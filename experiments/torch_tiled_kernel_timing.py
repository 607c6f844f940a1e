"""Kernel 1's block-tiled variants 1a and 1d against the warp-per-chain
kernels they replace, on one CUDA card.

    python experiments/torch_tiled_kernel_timing.py [--parent DIR] [--tree .]
        [--out _archive/tiled_out] [--work _archive/tiled] [--skip-timing]

DIR is an unpacked tree of the commit before the redesign (`git archive`);
--tree the tree under test. The script

1. builds both trees' kernel libraries, one process per tree, at once;
2. prints each kernel instance's ptxas line (registers, shared memory,
   spills) that differs between the parent and the tree, and every
   instance the tree adds or drops;
3. runs kernel 1 in the parent and in the tree on the same inputs and
   compares every output bit for bit: 1a on each of the 14 families at D
   10 and 50 (the 2- and 3-D families at theirs), at D 1, 32, 33 and 128
   and at ragged chain counts (1, 7, 31, 33, 8,191), at 65,536 x 50 on the
   correlated Gaussian with its oracle metric; 1d (the hierarchical
   posterior, diagonal and dense) at dim 9, 20, 100 and 128 with n_data
   50, 256, 33 and 1,000, at 8,191 and at 8,192 x 100 x 256; injected draws
   and Philox;
4. times 1a at the three shapes chip_smoke.py's main paths launch it at
   (the dense-warmup row's 65,536 x 50 and 4,096 x 50, L = 16; Rosenbrock's
   1,024 x 10 cell, L = 64), 1d (8,192 x 100 x 256, L = 16) and, as
   controls whose code neither tree changes, kernel 1 (65,536 x 50 on the
   funnel, L = 16), 2a (4,096 x 50, T = 8, L = 16), kernel 4 (the funnel)
   and 4b (the correlated Gaussian's dense metric; both 65,536 x 50, 16
   iterations x W = 4, depth 10), CUDA events around bursts enqueued while
   the card sleeps (as chip_smoke.py's _event_ms), in turns: parent, tree,
   tree, parent.

Steps 2 and 3 need --parent.

Each measurement runs in a process of its own, in the tree it measures.
Prints the card's name and power limit; writes the build logs and the times
under --out, the trees' copies and the compared outputs under --work (both
gitignored). Exits 1 if an output or a shared instance's ptxas line
differs.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HOLD_CYCLES = 5_000_000
FAMILIES_2D = {"multimodal_funnel_2d": (2,), "concentric_l1_2d": (2,), "concentric_l1_3d": (3,),
               "nested_l1_2d": (2,), "nested_l1_3d": (3,)}
FAMILIES = ("standard_normal", "neals_funnel", "correlated_gaussian", "gaussian_mixture",
            "neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t", "log_gamma",
            "log_gamma_unconstrained", "rosenbrock")


def cases():
    """(label, family, dim, chains, dense, n_data) of the bit comparison."""
    out = []
    for family in FAMILIES:
        for dim in (10, 50):
            out.append((family, dim, 1200, True, 0))
    for family, dims in FAMILIES_2D.items():
        out += [(family, d, 1200, True, 0) for d in dims]
    out += [("standard_normal", d, 1000, True, 0) for d in (1, 32, 33, 128)]
    out += [("neals_funnel", 50, n, True, 0) for n in (1, 7, 31, 33, 8191)]
    out.append(("correlated_gaussian", 50, 65536, True, 0))
    for dense in (False, True):
        out += [("hierarchical_logistic", d, n, dense, m)
                for d, n, m in ((9, 7, 50), (20, 33, 256), (100, 1, 33), (100, 8191, 256),
                                (128, 31, 1000), (128, 100, 33))]
    out.append(("hierarchical_logistic", 100, 8192, False, 256))
    return [(f"{f} D{d} C{n} {'dense' if dense else 'diagonal'} n_data{m}", f, d, n, dense, m)
            for f, d, n, dense, m in out]


def _inputs(torch, ft, family, dim, n, dense, n_data, dev, seed):
    from mcmc_tpu_torch.targets import get_target
    g = torch.Generator(device=dev).manual_seed(seed)
    t = get_target(family, dim=dim, **({"n_data": n_data} if n_data else {}))
    if family == "hierarchical_logistic":
        q = t.init_sampler(g, n) * 2.0
    elif family == "log_gamma":
        q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.5
    elif t.init_sampler is not None:
        q = t.init_sampler(g, n)
    else:
        q = torch.randn((n, dim), generator=g, device=dev) * 0.5
    lp, grad = t.value_and_grad_fn(q)
    if family == "correlated_gaussian" and n == 65536:
        cov = t.true_cov.to(dev, torch.float64)
    else:
        a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
        cov = a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64)
    invm, l_inv = ft.prepare_dense_metric(cov) if dense else (
        (torch.rand(dim, generator=g, device=dev) * 0.5 + 0.5), None)
    z = torch.randn((n, dim), generator=g, device=dev)
    p0 = ft.unwhiten(z, invm, l_inv).contiguous()
    u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
    return (t.value_and_grad_fn.kernel_info, q.float().contiguous(), lp.float().contiguous(),
            grad.float().contiguous(), invm, l_inv, p0, u)


def worker_outputs(torch, save):
    """Kernel 1's outputs on every case, injected and Philox, saved to `save`."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    dev = torch.device("cuda", 0)
    key = torch.tensor([11, -12], dtype=torch.int32, device=dev)
    out = {}
    for i, (label, family, dim, n, dense, n_data) in enumerate(cases()):
        info, q, lp, grad, invm, l_inv, p0, u = _inputs(torch, ft, family, dim, n, dense,
                                                        n_data, dev, 1000 + i)
        eps = 0.02 if family == "rosenbrock" else 0.1
        args = (info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad,
                ft.kernel_scalars(eps, 0.5, 1.0, dev), invm)
        for mode, rand in (("injected", dict(p0=p0, u=u)), ("philox", dict(key=key, call=3))):
            res = ft.grahmc_step_kernel(*args, l_inv=l_inv, **rand)
            out[f"{label} {mode}"] = [x.cpu() for x in res]
    torch.cuda.synchronize()
    torch.save(out, save)
    print(f"{len(out)} outputs saved")


def _event_ms(torch, fn, burst):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(burst):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / burst


def worker_time(torch, reps=10, burst=10):
    """Per-call ms of `reps` bursts of each timed kernel and shape (1a at
    three shapes, 1d, and the controls 1, 2a, 4 and 4b), Philox mode;
    prints one JSON line."""
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device("cuda", 0)
    key = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    t = get_target("correlated_gaussian", dim=50, correlation=0.9)
    q = torch.randn((65536, 50), generator=g, device=dev) * 0.5
    lp, grad = t.value_and_grad_fn(q)
    invm, l_inv = ft.prepare_dense_metric(t.true_cov.to(dev, torch.float64))
    a_scalars = ft.kernel_scalars(0.3, 1.0, 1.0, dev)

    def a_args(n, *lead):
        return (t.value_and_grad_fn.kernel_info, 16, ft.SCHEDULE_IDS["constant"], *lead,
                q[:n].contiguous(), lp[:n].contiguous(), grad[:n].contiguous(), a_scalars, invm)
    r = get_target("rosenbrock", dim=10)
    rq = (torch.randn((1024, 10), generator=g, device=dev) * 0.3 + 1.0).contiguous()
    rlp, rgrad = r.value_and_grad_fn(rq)
    m = torch.randn((10, 10), generator=g, device=dev, dtype=torch.float64)
    r_invm, r_linv = ft.prepare_dense_metric(m @ m.T / 10 + 0.5 * torch.eye(10, device=dev,
                                                                             dtype=torch.float64))
    r_args = (r.value_and_grad_fn.kernel_info, 64, ft.SCHEDULE_IDS["linear"], rq,
              rlp.contiguous(), rgrad.contiguous(), ft.kernel_scalars(0.02, 1.0, 1.0, dev),
              r_invm)
    h = get_target("hierarchical_logistic", dim=100, n_data=256, data_seed=0)
    hq = h.init_sampler(g, 8192).float().contiguous()
    hlp, hgrad = h.value_and_grad_fn(hq)
    d_args = (h.value_and_grad_fn.kernel_info, 16, ft.SCHEDULE_IDS["tanh"], hq,
              hlp.contiguous(), hgrad.contiguous(), ft.kernel_scalars(0.02, 0.5, 1.0, dev),
              torch.ones(100, device=dev))
    f = get_target("neals_funnel", dim=50)
    fq = torch.randn((65536, 50), generator=g, device=dev) * 0.5
    flp, fgrad = f.value_and_grad_fn(fq)
    k_args = (f.value_and_grad_fn.kernel_info, 16, ft.SCHEDULE_IDS["constant"], fq,
              flp.contiguous(), fgrad.contiguous(), ft.kernel_scalars(0.024, 1.0, 1.0, dev),
              torch.ones(50, device=dev))
    windows = {}
    for name, target, dense in (("4", f, False), ("4b", t, True)):
        wq = torch.randn((65536, 50), generator=g, device=dev) * 0.5
        wlp, wgrad = target.value_and_grad_fn(wq)
        w_invm, w_linv = (invm, l_inv) if dense else (torch.ones(50, device=dev), None)
        state = tn._init_pstate(wq, wlp, wgrad, torch.float32, multinomial=False,
                                max_tree_depth=10)
        windows[name] = ((target.value_and_grad_fn.kernel_info, 16, 4, 10, state,
                          fn.nuts_scalars(0.2, 1000.0, dev), w_invm), w_linv)
    fns = {"1a": lambda: ft.grahmc_step_kernel(*a_args(65536), key=key, call=0, l_inv=l_inv),
           "1a 4,096 x 50": lambda: ft.grahmc_step_kernel(*a_args(4096), key=key, call=0,
                                                          l_inv=l_inv),
           "1a 1,024 x 10": lambda: ft.grahmc_step_kernel(*r_args, key=key, call=0,
                                                          l_inv=r_linv),
           "1d": lambda: ft.grahmc_step_kernel(*d_args, key=key, call=0),
           "1": lambda: ft.grahmc_step_kernel(*k_args, key=key, call=0),
           "2a": lambda: ft.grahmc_multistep_kernel(*a_args(4096, 8), key=key, call=0,
                                                    l_inv=l_inv),
           "4": lambda: fn.nuts_window_kernel(*windows["4"][0], key=key, call=2,
                                              l_inv=windows["4"][1]),
           "4b": lambda: fn.nuts_window_kernel(*windows["4b"][0], key=key, call=2,
                                               l_inv=windows["4b"][1])}
    for name in ("4", "4b"):        # two windows in, as chip_smoke.py times them
        for call in range(2):
            fn.nuts_window_kernel(*windows[name][0], key=key, call=call, l_inv=windows[name][1])
    ms = {}
    for name, run in fns.items():
        run()
        ms[name] = [_event_ms(torch, run, burst) for _ in range(reps)]
    print("TIMES " + json.dumps(ms))


def worker(args):
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if args.worker == "build":
        from mcmc_tpu_torch.ops import _cuda
        lib = _cuda.load_library()
        Path(args.save).write_text(lib.build_log)
        print(f"built {lib.path.name} in {lib.build_seconds:.1f} s")
    elif args.worker == "outputs":
        worker_outputs(torch, args.save)
    else:
        worker_time(torch)


def run_worker(kind, root, save="", capture=False):
    cmd = [sys.executable, __file__, "--worker", kind, "--root", str(root), "--save", str(save)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        sys.exit(f"{kind} worker in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout


def ptxas_lines(log):
    """{kernel's mangled name: its ptxas resource line and spill line}."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spill = entry.group(1), ""
        elif "spill" in line and name:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            out[name] = f"{line.split(':', 1)[-1].strip()}; {spill}"
            name = None
    return out


def compare_parent(trees, lines, work):
    """Print the ptxas lines the parent and the tree disagree on and compare
    kernel 1's outputs of both bit for bit; returns (differing outputs,
    changed instances)."""
    old, new = lines["parent"], lines["tree"]
    changed = sorted(k for k in set(old) & set(new) if old[k] != new[k])
    print(f"[ptxas] parent {len(old)} instances, tree {len(new)}; {len(set(old) & set(new))} in "
          f"both, {len(changed)} of them changed", flush=True)
    for k in changed:
        print(f"  changed {k}: {old[k]} -> {new[k]}")
    for k in sorted(set(old) - set(new)):
        print(f"  dropped {k}: {old[k]}")
    for k in sorted(set(new) - set(old)):
        print(f"  adds {k}: {new[k]}")
    t0 = time.perf_counter()
    for label in ("parent", "tree"):
        run_worker("outputs", trees[label], work / f"outputs_{label}.pt")
    import torch
    a = torch.load(work / "outputs_parent.pt")
    b = torch.load(work / "outputs_tree.pt")

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    differ = [k for k in a if any(not torch.equal(bits(x), bits(y)) for x, y in zip(a[k], b[k]))]
    print(f"[outputs] {len(a)} kernel-1 calls compared bit for bit in "
          f"{time.perf_counter() - t0:.1f} s: {len(a) - len(differ)} equal, {len(differ)} differ",
          flush=True)
    for k in differ:
        print(f"  differs: {k}")
    return differ, changed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--out", default="_archive/tiled_out")
    ap.add_argument("--work", default="_archive/tiled")
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--worker", choices=("build", "outputs", "time"))
    ap.add_argument("--root")
    ap.add_argument("--save", default="")
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    out, work = Path(args.out).resolve(), Path(args.work).resolve()
    out.mkdir(parents=True, exist_ok=True)
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    tree = Path(args.tree).resolve()
    trees = {"parent": Path(args.parent).resolve()} if args.parent else {}
    trees["tree"] = tree
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, __file__, "--worker", "build", "--root", str(root), "--save",
         str(out / f"build_{label}.log")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for label, root in trees.items()}
    for label, proc in procs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            sys.exit(f"build of {label} failed:\n{text[-8000:]}")
        print(f"[build] {label}: {text.strip().splitlines()[-1]}", flush=True)
    print(f"[build] all trees in {time.perf_counter() - t0:.1f} s", flush=True)

    lines = {label: ptxas_lines((out / f"build_{label}.log").read_text()) for label in trees}
    spills = sorted(v for k, v in lines["tree"].items() if "tiled_step" in k)
    print(f"[ptxas] tree: {len(spills)} tiled instances; registers and spill stores: "
          + ", ".join(sorted({re.sub(r"Used (\d+) registers.*?(\d+) bytes spill stores.*",
                                    r"\1/\2", v) for v in spills})))
    differ, changed = [], []
    if "parent" in trees:
        differ, changed = compare_parent(trees, lines, work)
    if args.skip_timing:
        return 1 if differ or changed else 0

    def times(label):
        text = run_worker("time", trees[label])
        return json.loads(text.split("TIMES ", 1)[1].splitlines()[0])
    results = {label: {} for label in trees}
    turns = ["parent", "tree", "tree", "parent"] if "parent" in trees else ["tree"]
    for label in turns:
        got = times(label)
        for k in got:
            results[label].setdefault(k, []).extend(got[k])
        print(f"[time] {label}: " + ", ".join(
            f"{k} median {statistics.median(v):.4f} ms (reps {min(v):.4f}-{max(v):.4f})"
            for k, v in got.items()), flush=True)
    print("[time] medians over every rep of each tree (ms), min-max in brackets:")
    for label, r in results.items():
        print(f"  {label}: " + ", ".join(
            f"{k} {statistics.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]" for k, v in r.items()))
    (out / "times.json").write_text(json.dumps({"card": smi, "times": results}))
    return 1 if differ or changed else 0


if __name__ == "__main__":
    sys.exit(main())
