"""Kernels 1, 2, 4 and 4a on the 50-D Neal's funnel, timed on the card with
CUDA events, for comparing two source trees of the port (for example one
whose leapfrog contracts y + a x to an FMA and one that rounds the product
first).

    python3 experiments/torch_leapfrog_rounding_timing.py --root TREE --build-only \
        --ptxas FILE
    python3 experiments/torch_leapfrog_rounding_timing.py --root TREE [--reps 20]

TREE is a checkout of the repository (default: this script's own); the
kernels are built from its sources and timed through its wrappers. With
--build-only the script builds TREE's kernel library and writes nvcc's
per-kernel register and spill lines to FILE, so that two trees can be
built side by side before either is timed. Otherwise it prints one JSON
line: the card's name and power limit and, per kernel, the per-call
times (ms) of `reps` bursts of 10 calls and their median, with the
leapfrogs a NUTS window call executes. Shapes are
chip_smoke.py's main-path ones: kernel 1 at 65,536 x 50 and kernel 2 at
4,096 x 50 (T = 8), L = 16, the constant schedule, step 0.2; kernels 4
and 4a at 65,536 x 50, 16 iterations x W = 4, depth 10, step 0.25, from a
state two windows in. Run the trees in turns in one call (A, B, B, A)
and compare medians only within it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

STEP_K1 = 0.2
STEP_K4 = 0.25
BURST = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--ptxas", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from mcmc_tpu_torch import targets
    from mcmc_tpu_torch.ops import _cuda
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    lib = _cuda.load_library()
    if args.build_only:
        if args.ptxas:
            os.makedirs(os.path.dirname(os.path.abspath(args.ptxas)), exist_ok=True)
            with open(args.ptxas, "w") as f:
                f.write("\n".join(cs.ptxas_summary(lib.build_log)) + "\n")
        print(json.dumps({"root": root, "build_s": lib.build_seconds}))
        return

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(40)
    key = ft.PhiloxStream.from_generator(g, dev).key
    t = targets.neals_funnel(cs.DIM)
    info = t.value_and_grad_fn.kernel_info
    ones = torch.ones(cs.DIM, device=dev)
    scalars = ft.kernel_scalars(STEP_K1, cs.GAMMA, cs.STEEPNESS, dev)
    sid = ft.SCHEDULE_IDS["constant"]
    fns, leapfrogs = {}, {}
    for name, n, kernel_fn, lead in (
            ("grahmc_step_kernel", cs.CHAINS, ft.grahmc_step_kernel, ()),
            ("grahmc_multistep_kernel", cs.MULTI_CHAINS, ft.grahmc_multistep_kernel,
             (cs.MULTI_T,))):
        q = torch.randn((n, cs.DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        a = (info, cs.NUM_STEPS, sid, *lead, q, lp.contiguous(), grad.contiguous(), scalars,
             ones)
        fns[name] = lambda f=kernel_fn, a=a: f(*a, key=key, call=0)
    nuts_scalars = fn.nuts_scalars(STEP_K4, 1000.0, dev)
    inv_mass, l_inv = ft.kernel_metric(torch.ones(cs.DIM, device=dev))
    nargs = (info, cs.NUTS_ITERS, cs.NUTS_W, cs.NUTS_DEPTH)
    for multinomial in (False, True):
        q = torch.randn((cs.NUTS_CHAINS, cs.DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        state = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial,
                                max_tree_depth=cs.NUTS_DEPTH)
        for call in range(2):
            state = fn.nuts_window_kernel(*nargs, state, nuts_scalars, inv_mass, key=key,
                                          call=call, l_inv=l_inv)
        name = cs.NUTS_NAMES["multinomial" if multinomial else "endpoint"]

        def window(state=state):
            # each timed call runs from the same state, two windows in
            return fn.nuts_window_kernel(*nargs, cs._clone_state(state), nuts_scalars,
                                         inv_mass, key=key, call=2, l_inv=l_inv)
        fns[name] = window
        leapfrogs[name] = int(window().n_exec.sum()) - int(state.n_exec.sum())

    for f in fns.values():        # warm-up
        f()
    torch.cuda.synchronize()
    ms = {name: [] for name in fns}
    for _ in range(args.reps):
        for name, f in fns.items():
            ms[name].append(cs._event_ms(torch, f, BURST))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"root": root, "card": card.stdout.strip(),
                      "median_ms": {k: statistics.median(v) for k, v in ms.items()},
                      "leapfrogs_per_call": leapfrogs,
                      "ms": ms}))


if __name__ == "__main__":
    main()
