"""The warp-per-chain dense metric's products alone (csrc/metric.cuh:
DenseMetric::row_times, the products of kernel 4's 4b and 4a+4b), at 4b's
shapes, on one CUDA card: what bounds them, before the window changes.

    python experiments/torch_dense_product_timing.py [--tree .]
        [--build-log PATH] [--out _archive/dense_product_out] [--reps 10]

The script

1. builds experiments/dense_product_bench.cu against the tree's
   csrc/metric.cuh with nvcc (-Xptxas -v) and prints each instance's
   registers and spills;
2. for 4b at 65,536 x 50 (K = 2, the rho = 0.9 Gaussian's oracle metric,
   condition number 451) and at Rosenbrock's 1,024 x 10 (K = 1, a random
   SPD metric): 87 dependent products a chain (4b's 86.9 a chain a window
   at the [6b] shape, PERF.md section 6), the unwhitening (L^{-1}, lower
   triangular) every 17th, 8 warps a block, M^{-1} and L^{-1} in shared
   memory; S = 1, 2, 4 and 8 partial sums, each with the loop over i outside
   the K registers (the tree's row_times at S = 1, the bench's
   row_times_i_outer at S > 1) and with it inside (the order before:
   row_times_r_outer); at two occupancies: the window's own (the
   resident blocks an SM of 4b's instance, from its ptxas registers in
   --build-log, a build log of the tree's kernel library; 2 blocks without
   one), forced by padding the dynamic shared memory, and the bench
   kernel's natural one; the resident warps an SM from
   cudaOccupancyMaxActiveBlocksPerMultiprocessor;
3. checks every variant's outputs: both loop orders bit for bit at each
   S, and each S bit for bit against its plain version (the same chain of
   products through samplers/trajectory.py:ordered_matmul at S = 1, the
   partial sums written out in PyTorch at S > 1);
4. times each variant in turns (CUDA events around bursts enqueued while
   the card sleeps, as chip_smoke.py's _event_ms).

If the time does not fall with S at a fixed occupancy, the chain of
dependent adds does not bound the products. Prints the card's name and
power limit; writes the times under --out (gitignored). Exits 1 if an
output differs.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HOLD_CYCLES = 5_000_000
N_PRODUCTS = 87
LOWER_EVERY = 17
WARPS = 8
SM_SMEM = 233_472          # an H100 SM's shared memory, bytes
BLOCK_RESERVED = 1_024     # reserved a block
SUMS = (1, 2, 4, 8)
# (label, chains, D, the family id of the window instance whose occupancy is taken)
SHAPES = (("4b 65,536 x 50", 65_536, 50, 2), ("4b 1,024 x 10 (rosenbrock)", 1_024, 10, 10))


def variant_id(k, sums, part_i):
    return (k - 1) * 8 + {1: 0, 2: 1, 4: 2, 8: 3}[sums] * 2 + int(part_i)


def build(tree, out):
    src = Path(__file__).resolve().with_name("dense_product_bench.cu")
    so = out / "libdense_product_bench.so"
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
           "-I", str(tree / "mcmc_tpu_torch" / "csrc"), "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    (out / "bench_build.log").write_text(log)
    return so, log


def ptxas_lines(log):
    """{kernel's mangled name: (registers, spill stores, spill loads)}."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spill = entry.group(1), (0, 0)
        elif "spill" in line and name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spill = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
        elif "Used" in line and "registers" in line and name:
            out[name] = (int(re.search(r"Used (\d+) registers", line).group(1)),) + spill
            name = None
    return out


def window_blocks(log, family, k, dim):
    """Resident blocks an SM of 4b's warp-window instance of `family` at K
    (endpoint scheme; nuts_window_k1_dense_kernel at K = 1) from its ptxas
    registers: the
    register file (65,536, allocated 256 a warp) and the shared memory
    (M^{-1}, L^{-1}, a row a warp) of 8-warp blocks; None if the log has no
    such line."""
    lines = ptxas_lines(log)
    name = (rf"nuts_window_k1_dense_kernelILi{family}E" if k == 1
            else rf"nuts_window_kernelILi{family}ELi{k}ELb0ELb1E")
    regs = [v[0] for n, v in lines.items() if re.search(name, n)]
    if not regs:
        return None, None
    r = regs[0]
    per_warp = -(-r * 32 // 256) * 256
    by_regs = 65_536 // (per_warp * WARPS)
    smem = 4 * (((2 * dim * dim + 3) // 4) * 4 + WARPS * 32 * k)
    by_smem = SM_SMEM // (smem + BLOCK_RESERVED)
    return min(by_regs, by_smem, 64 // WARPS), r


def event_ms(torch, fn, burst):
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


def partial_sums_matmul(torch, x, a, sums):
    """x @ a as `sums` partial sums, each product rounded before its add:
    partial s takes the terms i = s (mod sums) in order from -0, and the
    partials join pairwise, ((p0 + p1) + (p2 + p3)) + ... (the bench's
    row_times_i_outer and row_times_r_outer at S = sums)."""
    parts = []
    for s in range(sums):
        acc = torch.full(x.shape[:-1] + a.shape[1:], -0.0, dtype=x.dtype, device=x.device)
        for i in range(s, a.shape[0], sums):
            acc = acc + x[..., i:i + 1] * a[i]
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[k] + parts[k + 1] for k in range(0, len(parts), 2)]
    return parts[0]


def plain_chain(torch, ordered_matmul, x, invm, linv, sums):
    """The bench kernel's chain of products in plain PyTorch: the tree's
    ordered_matmul (the kernels' order) at S = 1, partial_sums_matmul at
    S > 1."""
    for n in range(N_PRODUCTS):
        a = linv if n % LOWER_EVERY == 0 else invm
        v = ordered_matmul(x, a) if sums == 1 else partial_sums_matmul(torch, x, a, sums)
        x = x + 1e-3 * v
    return x


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--build-log", default="")
    ap.add_argument("--out", default="_archive/dense_product_out")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--burst", type=int, default=10)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from mcmc_tpu_torch.samplers.trajectory import dense_unwhitening, ordered_matmul
    from mcmc_tpu_torch.targets import get_target
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    so, log = build(tree, out)
    lines = ptxas_lines(log)
    for name, (regs, st, ld) in sorted(lines.items()):
        m = re.search(r"products_kernelILi(\d)ELi(\d)ELb(\d)E", name)
        if m:
            print(f"[ptxas] K {m.group(1)} S {m.group(2)} "
                  f"{'i outside' if m.group(3) == '1' else 'r outside'}: {regs} registers, "
                  f"spill stores {st} B, loads {ld} B")
    window_log = Path(args.build_log).read_text() if args.build_log else ""
    lib = ctypes.CDLL(str(so))
    lib.bench_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                                              ctypes.c_void_p]
    lib.bench_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bench_min_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(3)
    results, bad = {}, []
    for label, n, dim, family in SHAPES:
        k = -(-dim // 32)
        if dim == 50:
            metric = get_target("correlated_gaussian", dim=dim).true_cov.to(dev, torch.float64)
        else:
            a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
            metric = a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64)
        invm = metric.float().contiguous()
        linv = dense_unwhitening(metric).float().contiguous()
        x0 = torch.randn((n, dim), generator=g, device=dev).contiguous()
        min_smem = lib.bench_min_smem(dim, k)
        fixed, regs = window_blocks(window_log, family, k, dim)
        note = f"4b's instance: {regs} registers, {fixed} blocks an SM" if fixed else \
            "no window build log: 2 blocks an SM"
        fixed = fixed or 2
        occupancies = {f"window's ({fixed} blocks)": SM_SMEM // fixed - BLOCK_RESERVED,
                       "natural": min_smem}
        print(f"[shape] {label}: K {k}, {min_smem} B of shared memory a block; {note}",
              flush=True)
        outs = {}
        fns = {}
        for occ, smem in occupancies.items():
            smem = max(smem, min_smem)
            for sums in SUMS:
                for part_i in (True, False):
                    v = variant_id(k, sums, part_i)
                    blocks = ctypes.c_int()
                    code = lib.bench_occupancy(v, smem, ctypes.byref(blocks))
                    if code:
                        sys.exit(f"occupancy query failed: {code}")
                    y = torch.empty_like(x0)

                    def run(v=v, y=y, smem=smem):
                        code = lib.bench_launch(v, dim, n, N_PRODUCTS, LOWER_EVERY,
                                                invm.data_ptr(), linv.data_ptr(), x0.data_ptr(),
                                                y.data_ptr(), smem, stream)
                        if code:
                            raise RuntimeError(f"launch failed: {code}")
                    run()
                    torch.cuda.synchronize()
                    name = (f"{occ}, S {sums}, {'i outside' if part_i else 'r outside'}, "
                            f"{blocks.value * WARPS} warps an SM")
                    fns[name] = run
                    outs[(sums, part_i)] = y
        for sums in SUMS:
            a, b = outs[(sums, True)], outs[(sums, False)]
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                bad.append(f"{label} S {sums}: loop orders differ")
            ref = plain_chain(torch, ordered_matmul, x0, invm, linv, sums)
            same = a.view(torch.int32) == ref.view(torch.int32)
            print(f"[outputs] {label} S {sums}: i outside = r outside bit for bit: "
                  f"{torch.equal(a.view(torch.int32), b.view(torch.int32))}; against "
                  f"its plain version at S {sums}: {int(same.sum())} of {same.numel()} equal",
                  flush=True)
            if not bool(same.all()):
                bad.append(f"{label} S {sums}: differs from its plain version")
        times = {name: [] for name in fns}
        order = list(fns)
        for name in order + order[::-1]:
            times[name] += [event_ms(torch, fns[name], args.burst)
                            for _ in range(args.reps // 2 or 1)]
        for name in order:
            t = times[name]
            print(f"[time] {label}, {name}: median {statistics.median(t):.4f} ms "
                  f"({min(t):.4f}-{max(t):.4f})", flush=True)
        results[label] = {name: t for name, t in times.items()}
    (out / "times.json").write_text(json.dumps({"card": smi, "times": results,
                                                "ptxas": lines}))
    for b in bad:
        print(f"DIFFERS {b}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
