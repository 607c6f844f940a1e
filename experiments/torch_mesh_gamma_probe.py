"""The sequential γ tune over a chain mesh against the same tune without one.

    python experiments/torch_mesh_gamma_probe.py [--seeds 4] [--chains 256]
        [--dim 10] [--num-steps 16] [--ranks 2] [--device cpu]

For each seed, `sequential_tune_grahmc` starts from exact N(0, I) draws at
step 0.9 (the runner's tuned step on the non-centered funnel's sphered
geometry) and picks γ by ESJD, once over a `--ranks` gloo mesh
(`parallel.launch.run_ranks`) and once in one process on the same chains
and seed. Each line prints the picked γ, its re-tuned step and the ESJD of
every γ of the grid, so that a systematic difference between the two
choices can be told from the grid's noise. `--device cuda` runs the ranks
on the card (gloo, sharing it).

    python experiments/torch_mesh_gamma_probe.py --runner-cell [--seeds 5]
        [--ranks 2] [--device cuda] [--output-dir DIR]

runs the runner's own cell instead (run_benchmarks_torch.py's GRAHMC row on
the 10-D non-centered funnel, 1,024 chains, 500 warmup, 2,000 draws, L 16:
the cell whose mesh row failed quality), for seed 42 and seeds 0, 1, ...,
once under ``torchrun --nproc-per-node RANKS ... --mesh RANKS --mesh-backend
gloo`` and once with ``--mesh off``, and prints each run's picked γ, tuned
step, accept, max R-hat and verdict from its benchmark_results.json.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tune(mesh):
    """Every seed's tune over the mesh, and rank 0's without it."""
    import torch
    from mcmc_tpu_torch.targets import get_target
    from mcmc_tpu_torch.tuning import sequential_tune_grahmc
    a = _args_from_env()
    t = get_target("standard_normal", dim=a["dim"])
    out = {}
    for seed in range(a["seeds"]):
        x0 = torch.randn(a["chains"], a["dim"], generator=torch.Generator().manual_seed(100 + seed),
                         dtype=torch.float64 if mesh.device.type == "cpu" else torch.float32)
        for name, m in (("mesh", mesh), ("alone", None)):
            if name == "alone" and mesh.rank != 0:
                continue
            gen = torch.Generator(device=mesh.device).manual_seed(seed)
            step, gamma, _steep, hist = sequential_tune_grahmc(
                gen, t.log_prob_fn, None, x0.to(mesh.device), a["num_steps"], init_step_size=0.9,
                value_and_grad_fn=t.value_and_grad_fn, mesh=m, max_iter_step=250,
                gamma_samples_per_eval=60)
            out[(name, seed)] = (gamma, step, hist["esjd"])
    return out


def _args_from_env():
    return json.loads(os.environ["MESH_GAMMA_PROBE"])


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ("--targets", "neals_funnel_noncentered", "--samplers", "grahmc", "--schedules",
        "constant", "--dim", "10", "--n-chains", "1024", "--num-warmup", "500",
        "--num-samples", "2000", "--num-steps-grid", "16", "--no-warmup-cache")


def runner_cell(args):
    """The runner's cell over the mesh and without it, seed by seed."""
    out = args.output_dir or tempfile.mkdtemp(prefix="mesh_gamma_")
    seeds = [42] + list(range(args.seeds - 1))
    for seed in seeds:
        for name in ("mesh", "alone"):
            where = os.path.join(out, f"{name}_{seed}")
            cli = [*CELL, "--seed", str(seed), "--device", args.device, "--output-dir", where]
            if name == "mesh":
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                       "--nproc-per-node", str(args.ranks), "--master-addr", "127.0.0.1",
                       "--master-port", str(port), "run_benchmarks_torch.py", *cli,
                       "--mesh", str(args.ranks), "--mesh-backend", "gloo"]
            else:
                cmd = [sys.executable, "run_benchmarks_torch.py", *cli, "--mesh", "off"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-3000:])
                raise SystemExit(f"seed {seed} {name}: exit {proc.returncode}")
            with open(os.path.join(where, "benchmark_results.json")) as f:
                row = json.load(f)[0]
            print(f"seed {seed:2d} {name:5s}: gamma {row['gamma']}, step {row['step_size']}, "
                  f"accept {row['accept_rate']}, R-hat max {row['rhat_max']}, "
                  f"{'PASS' if row['quality_pass'] else 'FAIL'}, mesh_devices "
                  f"{row.get('mesh_devices')}, {wall:.1f} s", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--chains", type=int, default=256)
    parser.add_argument("--dim", type=int, default=10)
    parser.add_argument("--num-steps", type=int, default=16)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    parser.add_argument("--runner-cell", action="store_true",
                        help="run the runner's cell over the mesh and without it")
    parser.add_argument("--output-dir", default=None)
    args = parser.parse_args()
    if args.runner_cell:
        return runner_cell(args)
    os.environ["MESH_GAMMA_PROBE"] = json.dumps(
        {"seeds": args.seeds, "chains": args.chains, "dim": args.dim,
         "num_steps": args.num_steps})
    from mcmc_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(f"{os.path.abspath(__file__)}:tune", args.ranks, device=args.device,
                    backend="gloo", timeout=3000)[0]
    res.pop("output", None)
    for (name, seed), (gamma, step, esjd) in sorted(res.items(), key=lambda kv: kv[0][::-1]):
        print(f"seed {seed} {name:5s}: gamma {gamma}, step {step:.4f}, ESJD by gamma "
              + " ".join(f"{e:.3f}" for e in esjd))
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
