"""Which of kernel 1c's outputs differ between two trees on Neal's funnel,
and which rounding of the funnel's and the bridge's expressions each
tree's kernel computes, on one CUDA card.

    python experiments/torch_bridged_bits_probe.py --parent DIR --tree DIR
        [--tree DIR ...] [--work _archive/bits_probe]

Each DIR is an unpacked tree (its mcmc_tpu_torch/ alone is enough). The
script cuts each to 1c's source (csrc/fused_trajectory_bridged.cu), builds
it (experiments/torch_step_kernel_timing.py's build worker), and runs 1c
in each on the same inputs: the funnel at D 2, 10, 17, 32, 33 and 65,
16,385 chains (lane groups where the tree has them), beta 1 and 0.3, L 1
and 8, no friction, injected draws. For every case it prints, for each of
the seven outputs, the rows that differ from the first tree's; and at L 1
and D <= 32 (one register a warp lane, so the sums' order is the
butterfly's alone) it recomputes, in float32 with each fused multiply-add
written out, the candidate roundings of
  - the funnel's log-density: sum_sq inv_var + d_rest x0 as
    fma(sum_sq, inv_var, d_rest x0) "A", fma(d_rest, x0, sum_sq inv_var)
    "B" or two products and a sum "N";
  - the bridge's lp = beta lt + (1 - beta) lb: fma(beta, lt, .) "H",
    fma(1 - beta, lb, .) "I" or "N";
  - the neck's gradient -x0 / 9 + (inv_var / 2) sum_sq - d_rest / 2: fused
    "C" or not "D";
  - the mixed gradient beta g - (1 - beta) z (1/S): fma(beta, g, .) "E",
    fma(-(1 - beta), z (1/S), .) "F" or "N";
and counts, over the rows whose proposal q agrees between the trees, how
many of each tree's proposal lp and (accepted rows') neck gradient each
candidate gives bit for bit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
DIMS = (2, 10, 17, 32, 33, 65)
BETAS = (1.0, 0.3)
STEPS = (1, 8)
CHAINS = 16385
LOG_2PI = 1.8378770664093453
LOG_2PI_9 = 4.0351016437455645


def cases():
    return [(d, b, L) for d in DIMS for b in BETAS for L in STEPS]


def worker_run(root, save):
    sys.path.insert(0, str(root))
    import torch
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device("cuda")
    out = {}
    for i, (dim, beta, L) in enumerate(cases()):
        g = torch.Generator(device=dev).manual_seed(31000 + i)
        t = get_target("neals_funnel", dim=dim)
        info = t.value_and_grad_fn.kernel_info
        q = t.init_sampler(g, CHAINS).float().contiguous()
        base = ft.bridge_base(0.5, 2.0, dim, dev)
        potential = ft.bridged_vag(ft.device_vag(info), torch.tensor(beta, device=dev),
                                   torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                   base.mean, base.inv_scale)
        lp, grad = (x.float().contiguous() for x in potential(q))
        invm = torch.rand(dim, generator=g, device=dev) + 0.5
        p0 = torch.randn((CHAINS, dim), generator=g, device=dev)
        u = torch.rand(CHAINS, generator=g, device=dev).clamp_min(2.0 ** -25)
        scalars = ft.bridge_scalars(0.05, 0.0, 1.0, beta, base.log_norm, dev)
        res = ft.grahmc_bridged_kernel(info, L, 0, q, lp, grad, scalars, base.mean,
                                       base.inv_scale, invm, p0=p0, u=u)
        # the inverse variance exp(-x0) at the proposal, by the card's expf
        inv_var = torch.exp(-res[5][:, 0])
        out[f"D{dim} beta{beta} L{L}"] = [x.cpu() for x in res] + [
            inv_var.cpu(), scalars.cpu()]
    torch.save(out, save)
    print(f"{len(out)} cases saved")


def f32(x):
    return np.asarray(x, dtype=np.float32)


def fma(a, b, c):
    """float32 fma(a, b, c): the exact product in float64, one rounding."""
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def butterfly(s):
    """A warp's xor butterfly over 32 lanes (C, 32) in float32; lane 0's."""
    s = f32(s)
    for off in (16, 8, 4, 2, 1):
        s = f32(s + s[:, np.arange(32) ^ off])
    return s[:, 0]


def candidates(q1, inv_var, sc, dim):
    """The candidate roundings of the lp and the neck's gradient at q1
    (C, dim), one register a lane (dim <= 32)."""
    beta, log_norm = f32(sc[3]), f32(sc[4])
    omb = f32(1.0 - beta)
    lanes = np.zeros((q1.shape[0], 32), np.float32)
    lanes[:, :dim] = q1
    x0 = f32(q1[:, 0])
    v = lanes.copy()
    v[:, 0] = 0.0
    sum_sq = butterfly(f32(v * v))
    d_rest, c_rest, c_neck = f32(dim - 1), f32((dim - 1) * LOG_2PI), f32(LOG_2PI_9)
    inner = {"A": fma(sum_sq, inv_var, f32(d_rest * x0)),
             "B": fma(d_rest, x0, f32(sum_sq * inv_var)),
             "N": f32(f32(sum_sq * inv_var) + f32(d_rest * x0))}
    neck = f32(f32(f32(x0 * x0) / f32(9.0)) + c_neck)
    lt = {k: f32(np.float64(-0.5) * neck - np.float64(0.5) * f32(x + c_rest))
          for k, x in inner.items()}
    z = np.zeros_like(lanes)
    z[:, :dim] = f32(f32(q1 - f32(0.5)) * f32(0.5))
    lb = f32(np.float64(-0.5) * butterfly(f32(z * z)) + np.float64(log_norm))
    lp = {}
    for k, x in lt.items():
        lp[f"{k}H"] = fma(beta, x, f32(omb * lb))
        lp[f"{k}I"] = fma(omb, lb, f32(beta * x))
        lp[f"{k}N"] = f32(f32(beta * x) + f32(omb * lb))
    half_inv = f32(f32(0.5) * inv_var)
    div = f32(-x0 / f32(9.0))
    g0t = {"C": f32(fma(half_inv, sum_sq, div) - f32(0.5) * d_rest),
           "D": f32(f32(div + f32(half_inv * sum_sq)) - f32(0.5) * d_rest)}
    zs = f32(z[:, 0] * f32(0.5))
    g0 = {}
    for k, x in g0t.items():
        g0[f"{k}E"] = fma(beta, x, -f32(omb * zs))
        g0[f"{k}F"] = fma(-omb, zs, f32(beta * x))
        g0[f"{k}N"] = f32(f32(beta * x) - f32(omb * zs))
    return lp, g0


def same_rows(a, b):
    a, b = a.numpy(), b.numpy()
    if a.dtype == np.float32:
        eq = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    else:
        eq = a == b
    return eq.reshape(eq.shape[0], -1).all(axis=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--work", default="_archive/bits_probe")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root")
    ap.add_argument("--save")
    args = ap.parse_args()
    if args.worker:
        return worker_run(Path(args.root), args.save)
    sys.path.insert(0, str(HERE))
    import torch
    import torch_step_kernel_timing as tk
    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    roots = {"parent": Path(args.parent)} | {f"tree{i}": Path(t) for i, t in enumerate(args.tree)}
    cut = {label: tk.make_patched(root.resolve(), work / label, [],
                                  keep=set(tk.BRIDGED_SOURCES)) for label, root in roots.items()}
    builds = {label: subprocess.Popen(
        [sys.executable, str(HERE / "torch_step_kernel_timing.py"), "--worker", "build",
         "--root", str(root), "--save", str(work / f"build_{label}.log")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for label, root in cut.items()}
    for label, proc in builds.items():
        text = proc.communicate(timeout=1800)[0]
        if proc.returncode:
            sys.exit(f"build of {label} failed:\n{text[-4000:]}")
        print(f"[build] {label} ({roots[label]}): {text.strip().splitlines()[-1]}", flush=True)
    got = {}
    for label, root in cut.items():
        save = work / f"out_{label}.pt"
        subprocess.run([sys.executable, __file__, "--parent", args.parent, "--tree", "x",
                        "--worker", "--root", str(root), "--save", str(save)], check=True)
        got[label] = torch.load(save)
    names = ("q", "lp", "grad", "acc", "dh", "prop_q", "prop_lp")
    summary = {}
    for case in got["parent"]:
        dim = int(case.split()[0][1:])
        L = int(case.split()[-1][1:])
        ref = got["parent"][case]
        for label in got:
            if label == "parent":
                continue
            mine = got[label][case]
            diff = {n: int((~same_rows(a, b)).sum()) for n, a, b in zip(names, mine, ref)}
            line = f"[probe] {case} {label} against parent: rows differing " + ", ".join(
                f"{n} {c}" for n, c in diff.items())
            if L == 1 and dim <= 32:
                agree = same_rows(mine[5], ref[5])
                rows = agree & ~same_rows(mine[6], ref[6])
                acc_rows = agree & mine[3].numpy() & ref[3].numpy() & ~same_rows(
                    mine[2][:, :1], ref[2][:, :1])
                counts = {}
                for who, out in (("parent", ref), (label, mine)):
                    q1 = out[5].numpy()[agree]
                    lp_c, g0_c = candidates(q1, out[7].numpy()[agree], out[8].numpy(), dim)
                    lp_k = out[6].numpy()[agree]
                    g0_k = out[2].numpy()[agree][:, 0]
                    sel = rows[agree]
                    sel_g = acc_rows[agree]
                    counts[who] = {
                        "lp": {k: int((v[sel].view(np.int32) == lp_k[sel].view(np.int32)).sum())
                               for k, v in lp_c.items()},
                        "lp_all": {k: int((v.view(np.int32) == lp_k.view(np.int32)).sum())
                                   for k, v in lp_c.items()},
                        "g0": {k: int((v[sel_g].view(np.int32) == g0_k[sel_g].view(np.int32))
                                      .sum()) for k, v in g0_c.items()},
                    }
                line += (f"; proposal q agrees on {int(agree.sum())} rows, lp differs on "
                         f"{int(rows.sum())}, the accepted neck gradient on "
                         f"{int(acc_rows.sum())}; candidates matching (lp on those rows / "
                         f"on all agreeing rows; neck gradient): {json.dumps(counts)}")
            print(line, flush=True)
            summary[f"{case} {label}"] = diff
    (work / "summary.json").write_text(json.dumps(summary))


if __name__ == "__main__":
    main()
