"""MCMC benchmark CLI on the PyTorch/CUDA port (mcmc_tpu_torch).

Usage:
    python run_benchmarks_torch.py --dim 20 --targets standard_normal neals_funnel
    python run_benchmarks_torch.py --all-targets --output-dir results
    python run_benchmarks_torch.py --device cpu --targets standard_normal \\
        --samplers rwmh hmc nuts grahmc --dim 4 --n-chains 4 --num-warmup 200 \\
        --num-samples 300 --num-steps-grid 8 --output-dir /tmp/bench_out

The flags and defaults of run_benchmarks.py, plus --device: the runs go on
the CUDA card ("cuda", the default; it raises where there is none) or, only
when asked, on the CPU. The output is run_benchmarks.py's
benchmark_results.{csv,json}, which analyze_benchmarks.py and analysis/ read.

A chain mesh runs one process per rank; rank 0 alone writes the files:
    torchrun --nproc-per-node 2 run_benchmarks_torch.py --mesh 2 ...
(--mesh-backend gloo when the ranks share one card; on the CPU with
--device cpu the mesh takes gloo.)
"""

import argparse

import torch

from mcmc_tpu_torch.benchmark import ALL_TARGET_NAMES, print_summary, run_all_benchmarks


def _positive_int(text):
    value = int(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, got {value}")
    return value


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Run MCMC benchmarks with adaptive warmup "
                                                 "on the PyTorch/CUDA port")
    parser.add_argument("--targets", nargs="+", default=None,
                        help="List of targets to benchmark")
    parser.add_argument("--all-targets", action="store_true",
                        help="Run all available targets")
    parser.add_argument("--samplers", nargs="+", default=["rwmh", "hmc", "nuts", "grahmc"],
                        help="Samplers to benchmark (rwmh, hmc, nuts, grahmc; plus 'smc', "
                        "annealed SMC with log-Z estimation, set by the --smc-* flags)")
    parser.add_argument("--schedules", nargs="+",
                        default=["constant", "tanh", "sigmoid", "linear", "sine"],
                        help="GRAHMC friction schedules to test")
    parser.add_argument("--dim", type=int, default=10, help="Dimensionality of targets")
    parser.add_argument("--n-chains", type=int, default=4, help="Number of parallel chains")
    parser.add_argument("--num-warmup", type=int, default=2500,
                        help="Warmup steps (500 exploration + windows + 125 cooldown)")
    parser.add_argument("--num-samples", type=int, default=None,
                        help="Samples to collect (default: 10000)")
    parser.add_argument("--num-steps-grid", nargs="+", type=int, default=None,
                        help="Grid of trajectory lengths for HMC/GRAHMC")
    parser.add_argument("--mass-matrix-mode", type=str,
                        choices=["mass", "no-mass", "both", "dense"], default="mass",
                        help="Mass matrix: learned diagonal, identity, both, or 'dense' "
                        "(full covariance; the fused kernels' dense variants)")
    parser.add_argument("--track-convergence", action="store_true",
                        help="Track W2 at log-spaced checkpoints")
    parser.add_argument("--convergence-base", type=float, default=1.5,
                        help="Log-spacing base for checkpoints")
    parser.add_argument("--output-dir", type=str, default="benchmark_results",
                        help="Directory to save results")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--nuts-backend", type=str, default="auto",
                        choices=["auto", "classic", "persistent"],
                        help="NUTS path: 'auto' (the persistent machine through kernel 4 "
                        "on the card for a target it takes, classic otherwise), 'classic' "
                        "or 'persistent'")
    parser.add_argument("--mesh", type=str, default="auto",
                        help="Chain sharding over ranks: 'auto' (the ranks torchrun "
                        "started), a rank count N (run under torchrun --nproc-per-node "
                        "N) or 'off'")
    parser.add_argument("--mesh-backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="The mesh's collectives: NCCL where each rank owns a card "
                        "(default on the card), gloo on the CPU or, when asked, for "
                        "ranks sharing one card")
    parser.add_argument("--nuts-steps-per-sample", type=_positive_int, default=64,
                        help="Persistent-NUTS snapshot interval in leapfrog slots")
    parser.add_argument("--nuts-proposal", type=str, default="endpoint",
                        choices=["endpoint", "multinomial"],
                        help="Persistent-NUTS proposal scheme")
    parser.add_argument("--trajectory-tuner", type=str, default="grid",
                        choices=["grid", "chees"],
                        help="HMC/GRAHMC trajectory length: the L grid, or ChEES (one "
                        "warmup tunes T, jittered sampling; falls back to the grid)")
    parser.add_argument("--gamma-tuner", type=str, default="grid", choices=["grid", "joint"],
                        help="GRAHMC friction under --trajectory-tuner chees: the ESJD grid "
                        "phase, or SPSA inside the ChEES warmup")
    parser.add_argument("--tempering", type=int, default=0,
                        help="Parallel tempering for HMC/GRAHMC: K > 1 replica-exchange "
                        "rungs, the cold replica's draws emitted; 0/1 disables")
    parser.add_argument("--tempering-beta-min", type=float, default=0.05,
                        help="Hottest rung's inverse temperature (default 0.05)")
    parser.add_argument("--tempering-swap-interval", type=int, default=1,
                        help="Transitions between replica-exchange attempts (default 1)")
    parser.add_argument("--tempering-ladder", default="geometric",
                        choices=["geometric", "adaptive"],
                        help="'adaptive' tunes the ladder toward 0.234 swap acceptance "
                        "before sampling")
    parser.add_argument("--smc-particles", type=int, default=4096,
                        help="Population size of '--samplers smc' rows (default 4096)")
    parser.add_argument("--smc-move-steps", type=int, default=3,
                        help="MCMC move transitions per SMC stage (default 3)")
    parser.add_argument("--smc-num-steps", type=int, default=8,
                        help="Leapfrog steps per SMC move (default 8)")
    parser.add_argument("--smc-base-scale", type=float, default=2.0,
                        help="Std of the SMC bridge's N(0, s^2 I) base (default 2.0)")
    parser.add_argument("--smc-tune-trajectory", action="store_true",
                        help="Adapt the SMC moves' trajectory length by ChEES")
    parser.add_argument("--smc-rel-ess", type=float, default=0.5,
                        help="Adaptive schedule's target relative ESS (default 0.5)")
    parser.add_argument("--reparam", type=str, default="off", choices=["auto", "off"],
                        help="'auto' samples constrained-support targets in log-transformed "
                        "coordinates; 'off' in their natural ones")
    parser.add_argument("--no-warmup-cache", action="store_true",
                        help="Disable the per-configuration warmup checkpoints "
                        "(<output-dir>/.warmup_cache_seed<seed>/)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="Where the runs go: the CUDA card (default; raises without "
                        "one) or, only when asked, the CPU")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.all_targets:
        targets = list(ALL_TARGET_NAMES)
    elif args.targets:
        targets = args.targets
    else:
        print("Error: Must specify --targets or --all-targets")
        return None

    mesh = args.mesh if args.mesh in ("auto", "off") else int(args.mesh)
    if mesh not in ("off", 0, 1):
        # join torchrun's group (a no-op in one process) before any tensor
        # is placed: a rank's "cuda" is its own card
        from mcmc_tpu_torch.parallel.distributed import initialize
        initialize(backend=args.mesh_backend, device=args.device)
        if args.device == "cuda" and torch.distributed.is_initialized():
            torch.cuda.set_device(torch.distributed.get_rank() % torch.cuda.device_count())

    mass_modes = {"mass": [True], "no-mass": [False], "both": [True, False],
                  "dense": ["dense"]}[args.mass_matrix_mode]
    num_samples = args.num_samples if args.num_samples is not None else 10000

    print("=" * 80)
    print("MCMC BENCHMARK SUITE (fixed budget, adaptive warmup) on the PyTorch port")
    print("=" * 80)
    print(f"Targets: {', '.join(targets)}")
    print(f"Samplers: {', '.join(args.samplers)}")
    print(f"dim={args.dim} chains={args.n_chains} warmup={args.num_warmup} "
          f"samples={num_samples} device={args.device}")
    print(f"Mass matrix: {args.mass_matrix_mode} | Output: {args.output_dir}")
    print("=" * 80)

    rows = run_all_benchmarks(
        samplers=args.samplers,
        targets=targets,
        grahmc_schedules=args.schedules,
        dim=args.dim,
        n_chains=args.n_chains,
        num_warmup=args.num_warmup,
        num_samples=num_samples,
        seed=args.seed,
        output_dir=args.output_dir,
        num_steps_grid=args.num_steps_grid,
        mass_matrix_modes=mass_modes,
        track_convergence=args.track_convergence,
        convergence_base=args.convergence_base,
        mesh_devices=mesh,
        warmup_cache=not args.no_warmup_cache,
        nuts_steps_per_sample=args.nuts_steps_per_sample,
        nuts_backend=args.nuts_backend,
        nuts_proposal=args.nuts_proposal,
        trajectory_tuner=args.trajectory_tuner,
        gamma_tuner=args.gamma_tuner,
        tempering=args.tempering,
        tempering_beta_min=args.tempering_beta_min,
        tempering_swap_interval=args.tempering_swap_interval,
        tempering_ladder=args.tempering_ladder,
        smc_particles=args.smc_particles,
        smc_move_steps=args.smc_move_steps,
        smc_num_steps=args.smc_num_steps,
        smc_base_scale=args.smc_base_scale,
        smc_rel_ess=args.smc_rel_ess,
        smc_tune_trajectory=args.smc_tune_trajectory,
        reparam=args.reparam,
        device=args.device,
    )
    print_summary(rows)
    return rows


if __name__ == "__main__":
    main()
