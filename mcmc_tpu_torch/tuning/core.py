"""Standalone tune-and-sample CLI (port of ``mcmc_tpu/tuning/core.py``).

Tunes a sampler on a target, then samples adaptively in batches until the
minimum bulk ESS reaches a target, with a grid search over trajectory
length for HMC/GRAHMC. The JAX CLI's flags, plus --device: the runs go on
the CUDA card ("cuda", the default; it raises where there is none) or,
only when asked, on the CPU.

The port's own decisions:
- one ``torch.Generator`` on the run's device where the JAX CLI takes a
  key; each ``random.split`` is ``utils.generators.split_generator``;
- positions are float32 on a card (the fused kernels' dtype) and float64
  on the CPU, where the JAX CLI enables x64;
- the samplers' backends follow the port's one "auto" rule
  (``ops.padded_targets.sampler_backend``): on a card, RWMH's DA and
  batches run kernel 3, the GRAHMC grid's warmup and gamma tune kernel 1,
  HMC's and GRAHMC's batches kernel 2 (at most 4,096 chains, T from
  (8, 4, 2, 1) dividing the batch) or kernel 1 above; HMC's warmup stays
  eager and NUTS stays classic, as in the JAX CLI;
- RWMH's tuner and batches get the target's tagged value_and_grad_fn (the
  kernels' dispatch tag), where the JAX CLI passes only log_prob_fn and so
  never reaches its RWMH kernel;
- ``--plot`` imports ``tuning.plots`` (matplotlib) before any sampling and
  raises ImportError without it; nothing else here imports matplotlib.

Run: python -m mcmc_tpu_torch.tuning.core --sampler grahmc --target neals_funnel
"""

import argparse
import os
from typing import Callable, Dict, Optional

import torch

from mcmc_tpu_torch.diagnostics import compute_diagnostics
from mcmc_tpu_torch.ops.padded_targets import sampler_backend
from mcmc_tpu_torch.samplers import (get_friction_schedule, grahmc_run, hmc_run, nuts_run,
                                     rwmh_run)
from mcmc_tpu_torch.targets import TargetDistribution, get_target
from mcmc_tpu_torch.tuning.adaptation import run_adaptive_warmup
from mcmc_tpu_torch.tuning.dual_averaging import dual_averaging_tune_rwmh
from mcmc_tpu_torch.utils.generators import make_generator, position_dtype, split_generator

DEFAULT_HMC_GRID = [1, 2, 4, 8, 16, 32, 64]
DEFAULT_GRAHMC_GRID = [8, 16, 32, 64]


def _init_position(generator: torch.Generator, target: TargetDistribution, n_chains: int):
    dtype = position_dtype(generator.device)
    if target.init_sampler is not None:
        return target.init_sampler(generator, n_chains, dtype=dtype)
    return torch.randn((n_chains, target.dim), generator=generator, device=generator.device,
                       dtype=dtype) * 2.0


def _adaptive_sample(generator: torch.Generator, run_batch: Callable, init_position,
                     target_ess: int, batch_size: int, max_samples: int) -> Dict:
    """Sample in batches until min bulk ESS >= target_ess (or max_samples).

    run_batch: (generator, position) -> RunResult. The draws are
    concatenated on their device and diagnosed after every batch. Returns
    dict with concatenated samples/log_probs, the batches' results and
    totals.
    """
    pieces = []
    position = init_position
    total = 0
    batch_num = 0
    while total < max_samples:
        batch_num += 1
        res = run_batch(split_generator(generator), position)
        position = res.final_state.position
        pieces.append(res)
        total += batch_size

        samples = torch.cat([p.samples for p in pieces], dim=0)
        diag = compute_diagnostics(samples)
        del samples
        min_ess = diag["ess_bulk_min"]
        print(f"  batch {batch_num}: {total} samples, "
              f"min ESS = {min_ess:.1f}, mean ESS = {diag['ess_bulk_mean']:.1f}")
        if min_ess >= target_ess:
            print("  target ESS reached")
            break

    return {
        "samples": torch.cat([p.samples for p in pieces], dim=0),
        "log_probs": torch.cat([p.log_probs for p in pieces], dim=0),
        "pieces": pieces,
        "total_samples": total,
        "final_accept_rate": pieces[-1].accept_rate,
    }


def _print_diagnostics(diag: Dict, target_ess: int):
    print(f"\nSplit R-hat (rank-normalized): max {diag['rhat_max']:.4f} "
          f"mean {diag['rhat_mean']:.4f} "
          f"[{'PASS' if diag['rhat_max'] < 1.01 else 'FAIL'} @ 1.01]")
    print(f"Bulk ESS: min {diag['ess_bulk_min']:.1f} mean "
          f"{diag['ess_bulk_mean']:.1f} "
          f"[{'PASS' if diag['ess_bulk_min'] >= target_ess else 'FAIL'} "
          f"@ {target_ess}]")
    print(f"Tail ESS: min {diag['ess_tail_min']:.1f} mean "
          f"{diag['ess_tail_mean']:.1f}")


def tune_and_sample_rwmh(generator, target: TargetDistribution, n_chains: int = 4,
                         target_ess: int = 1000, batch_size: int = 2000,
                         max_samples: int = 50000,
                         warmup_steps: int = 2000) -> Dict:
    """DA-tune the RWMH scale, then sample adaptively until target ESS.
    As in the JAX CLI, the batches start from the initial positions."""
    init_gen, tune_gen = split_generator(generator), split_generator(generator)
    init_pos = _init_position(init_gen, target, n_chains)
    vag = target.value_and_grad_fn
    backend = sampler_backend("rwmh", target, init_pos.device)

    print(f"\nTUNING RWMH on {target.name} ({n_chains} chains)")
    scale, history = dual_averaging_tune_rwmh(
        tune_gen, target.log_prob_fn, init_pos, max_iter=warmup_steps,
        value_and_grad_fn=vag, backend=backend)
    print(f"Tuned scale: {scale:.4f}")

    def run_batch(g, pos):
        return rwmh_run(g, target.log_prob_fn, pos, num_samples=batch_size, scale=scale,
                        burn_in=0, value_and_grad_fn=vag, backend=backend)

    out = _adaptive_sample(generator, run_batch, init_pos, target_ess, batch_size,
                           max_samples)
    diag = compute_diagnostics(out["samples"])
    _print_diagnostics(diag, target_ess)
    return {
        "scale": scale,
        "history": history,
        "samples": out["samples"],
        "log_probs": out["log_probs"],
        "accept_rate": out["final_accept_rate"],
        "mean_acceptance": float(torch.mean(out["final_accept_rate"].double())),
        "diagnostics": diag,
        "total_samples": out["total_samples"],
    }


def nuts_gradient_calls(tree_depths) -> int:
    """A classic NUTS run's gradient evaluations: sum(2^depth - 1) over
    every (draw, chain), summed in int64 and read once."""
    return int(torch.sum(2 ** tree_depths.to(torch.int64) - 1))


def tune_and_sample_nuts(generator, target: TargetDistribution, n_chains: int = 4,
                         target_ess: int = 1000, batch_size: int = 2000,
                         max_samples: int = 50000, warmup_steps: int = 1000,
                         max_tree_depth: int = 10) -> Dict:
    """Warmup-tune NUTS (step size + mass matrix), sample until target ESS.
    Classic NUTS, eager, as the JAX CLI's."""
    init_gen, tune_gen = split_generator(generator), split_generator(generator)
    init_pos = _init_position(init_gen, target, n_chains)
    vag = target.value_and_grad_fn

    print(f"\nTUNING NUTS on {target.name} ({n_chains} chains)")
    step_size, inv_mass, warm_pos, tune_info = run_adaptive_warmup(
        "nuts", target.log_prob_fn, None, init_pos, tune_gen,
        num_warmup=warmup_steps, max_tree_depth=max_tree_depth, value_and_grad_fn=vag)
    print(f"Tuned step size: {step_size:.4f}")

    def run_batch(g, pos):
        return nuts_run(g, target.log_prob_fn, pos, step_size=step_size,
                        num_samples=batch_size, burn_in=0, inv_mass_matrix=inv_mass,
                        max_tree_depth=max_tree_depth, value_and_grad_fn=vag)

    out = _adaptive_sample(generator, run_batch, warm_pos, target_ess, batch_size,
                           max_samples)
    tree_depths = torch.cat([p.info["tree_depths"] for p in out["pieces"]], dim=0)
    mean_accepts = torch.cat([p.info["mean_accept_probs"] for p in out["pieces"]], dim=0)
    total_gradient_calls = nuts_gradient_calls(tree_depths)
    avg_depth = float(torch.mean(tree_depths.double()))

    diag = compute_diagnostics(out["samples"])
    _print_diagnostics(diag, target_ess)
    ess_per_sample = diag["ess_bulk_min"] / out["total_samples"]
    ess_per_gradient = (diag["ess_bulk_min"] / total_gradient_calls
                        if total_gradient_calls else 0.0)
    print(f"Gradient calls: {total_gradient_calls}, avg depth "
          f"{avg_depth:.2f}, ESS/grad {ess_per_gradient:.6f}")
    return {
        "step_size": step_size,
        "inv_mass_matrix": inv_mass,
        "max_tree_depth": max_tree_depth,
        "history": tune_info,
        "samples": out["samples"],
        "log_probs": out["log_probs"],
        "tree_depths": tree_depths,
        "mean_accept_probs": mean_accepts,
        "avg_mean_accept": float(torch.mean(mean_accepts.double())),
        "diagnostics": diag,
        "total_samples": out["total_samples"],
        "total_gradient_calls": total_gradient_calls,
        "avg_tree_depth": avg_depth,
        "ess_per_sample": ess_per_sample,
        "ess_per_gradient": ess_per_gradient,
    }


def _tune_and_sample_trajectory_grid(generator, target, n_chains, target_ess,
                                     batch_size, max_samples, warmup_steps,
                                     num_steps_grid, sampler: str,
                                     schedule_type: str = "constant") -> Dict:
    """Shared HMC/GRAHMC grid loop: warmup + adaptive sample per L, pick the
    best ESS/gradient configuration."""
    vag = target.value_and_grad_fn
    grid_results = []
    for L in num_steps_grid:
        print(f"\n{'=' * 60}\n{sampler.upper()} grid: L = {L}\n{'=' * 60}")
        init_gen, tune_gen, sample_gen = (split_generator(generator) for _ in range(3))
        init_pos = _init_position(init_gen, target, n_chains)
        backend = sampler_backend(sampler, target, init_pos.device)
        step_size, inv_mass, warm_pos, info = run_adaptive_warmup(
            sampler, target.log_prob_fn, None, init_pos, tune_gen,
            num_warmup=warmup_steps, num_steps=L,
            schedule_type=schedule_type if sampler == "grahmc" else None,
            value_and_grad_fn=vag)

        if sampler == "hmc":
            def run_batch(g, pos):
                return hmc_run(g, target.log_prob_fn, pos, step_size=step_size,
                               num_steps=L, num_samples=batch_size, burn_in=0,
                               inv_mass_matrix=inv_mass, value_and_grad_fn=vag,
                               backend=backend)
        else:
            def run_batch(g, pos):
                return grahmc_run(
                    g, target.log_prob_fn, pos, step_size=step_size,
                    num_steps=L, gamma=info.get("gamma", 1.0),
                    steepness=info.get("steepness", 2.0),
                    num_samples=batch_size, burn_in=0,
                    inv_mass_matrix=inv_mass,
                    friction_schedule=get_friction_schedule(schedule_type),
                    value_and_grad_fn=vag, backend=backend)

        out = _adaptive_sample(sample_gen, run_batch, warm_pos, target_ess,
                               batch_size, max_samples)
        diag = compute_diagnostics(out["samples"])
        total_gradient_calls = out["total_samples"] * L * n_chains
        ess_per_gradient = diag["ess_bulk_min"] / total_gradient_calls
        entry = {
            "num_steps": L,
            "step_size": step_size,
            "total_samples": out["total_samples"],
            "total_gradient_calls": total_gradient_calls,
            "ess_bulk_min": diag["ess_bulk_min"],
            "rhat_max": diag["rhat_max"],
            "ess_per_gradient": ess_per_gradient,
            "mean_acceptance": float(torch.mean(out["final_accept_rate"].double())),
            "diagnostics": diag,
        }
        if sampler == "grahmc":
            entry["gamma"] = info.get("gamma")
            entry["steepness"] = info.get("steepness")
            entry["schedule"] = schedule_type
        grid_results.append(entry)
        print(f"  L={L}: ESS/grad = {ess_per_gradient:.6f}")
        del out

    best = max(grid_results, key=lambda r: r["ess_per_gradient"])
    print(f"\nBEST: L={best['num_steps']} step={best['step_size']:.4f} "
          f"ESS/grad={best['ess_per_gradient']:.6f}")
    return {"best_config": best, "grid_results": grid_results,
            "num_steps_grid": list(num_steps_grid)}


def tune_and_sample_hmc_grid(generator, target, n_chains: int = 4,
                             target_ess: int = 1000, batch_size: int = 2000,
                             max_samples: int = 50000,
                             warmup_steps: int = 1000,
                             num_steps_grid: Optional[list] = None) -> Dict:
    if num_steps_grid is None:
        num_steps_grid = DEFAULT_HMC_GRID
    return _tune_and_sample_trajectory_grid(
        generator, target, n_chains, target_ess, batch_size, max_samples,
        warmup_steps, num_steps_grid, "hmc")


def tune_and_sample_grahmc_grid(generator, target, n_chains: int = 4,
                                target_ess: int = 1000, batch_size: int = 2000,
                                max_samples: int = 50000,
                                warmup_steps: int = 1000,
                                num_steps_grid: Optional[list] = None,
                                schedule_type: str = "constant") -> Dict:
    if num_steps_grid is None:
        num_steps_grid = DEFAULT_GRAHMC_GRID
    return _tune_and_sample_trajectory_grid(
        generator, target, n_chains, target_ess, batch_size, max_samples,
        warmup_steps, num_steps_grid, "grahmc", schedule_type)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Tune MCMC sampler hyperparameters using dual averaging "
                    "on the PyTorch/CUDA port")
    parser.add_argument("--sampler", type=str, required=True,
                        choices=["rwmh", "hmc", "nuts", "grahmc"],
                        help="Sampler to tune")
    parser.add_argument("--target", type=str, default="standard_normal",
                        choices=["standard_normal", "correlated_gaussian",
                                 "ill_conditioned_gaussian", "neals_funnel",
                                 "rosenbrock"],
                        help="Target distribution")
    parser.add_argument("--schedule", type=str, default="constant",
                        choices=["constant", "tanh", "sigmoid", "linear", "sine"],
                        help="Friction schedule for GRAHMC")
    parser.add_argument("--dim", type=int, default=10)
    parser.add_argument("--chains", type=int, default=4)
    parser.add_argument("--target-ess", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=2000)
    parser.add_argument("--max-samples", type=int, default=50000)
    parser.add_argument("--warmup-steps", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--max-tree-depth", type=int, default=10)
    parser.add_argument("--num-steps-grid", type=str, default=None,
                        help="Comma-separated trajectory lengths for grid search")
    parser.add_argument("--max-cycles", type=int, default=10,
                        help="(kept for flag parity; coordinate-wise tuning "
                             "is superseded by sequential ESJD tuning)")
    parser.add_argument("--plot", action="store_true",
                        help="Generate diagnostic plots (needs matplotlib)")
    parser.add_argument("--output-dir", type=str, default="./tuning_output")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="Where the runs go: the CUDA card (default; raises without "
                        "one) or, only when asked, the CPU")
    return parser


def _plots_module():
    """tuning.plots, imported before any sampling: --plot without
    matplotlib fails here, not after the run."""
    try:
        from mcmc_tpu_torch.tuning import plots
    except ImportError as err:
        raise ImportError(f"--plot needs matplotlib, which cannot be imported: {err}") from err
    return plots


def main(argv=None):
    args = build_parser().parse_args(argv)
    plots = _plots_module() if args.plot else None
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
    generator = make_generator(args.seed, args.device)
    target = get_target(args.target, dim=args.dim)

    grid = ([int(x) for x in args.num_steps_grid.split(",")]
            if args.num_steps_grid else None)

    if args.sampler == "rwmh":
        results = tune_and_sample_rwmh(
            generator, target, n_chains=args.chains, target_ess=args.target_ess,
            batch_size=args.batch_size, max_samples=args.max_samples,
            warmup_steps=args.warmup_steps)
    elif args.sampler == "nuts":
        results = tune_and_sample_nuts(
            generator, target, n_chains=args.chains, target_ess=args.target_ess,
            batch_size=args.batch_size, max_samples=args.max_samples,
            warmup_steps=args.warmup_steps, max_tree_depth=args.max_tree_depth)
    elif args.sampler == "hmc":
        results = tune_and_sample_hmc_grid(
            generator, target, n_chains=args.chains, target_ess=args.target_ess,
            batch_size=args.batch_size, max_samples=args.max_samples,
            warmup_steps=args.warmup_steps, num_steps_grid=grid)
    else:
        results = tune_and_sample_grahmc_grid(
            generator, target, n_chains=args.chains, target_ess=args.target_ess,
            batch_size=args.batch_size, max_samples=args.max_samples,
            warmup_steps=args.warmup_steps, num_steps_grid=grid,
            schedule_type=args.schedule)

    if plots is not None:
        os.makedirs(args.output_dir, exist_ok=True)
        history = results.get("history")
        if isinstance(history, dict) and ("scale_history" in history
                                          or "step_size_history" in history):
            plots.plot_tuning_history(
                history, args.sampler.upper(),
                os.path.join(args.output_dir, f"{args.sampler}_tuning_history.png"))
        if "samples" in results:
            plots.plot_sampling_diagnostics(
                results["samples"], results["diagnostics"], args.sampler.upper(),
                os.path.join(args.output_dir, f"{args.sampler}_diagnostics.png"))
        if "grid_results" in results:
            plots.plot_grid_comparison(
                results["grid_results"], results["num_steps_grid"],
                os.path.join(args.output_dir, f"{args.sampler}_grid_comparison.png"))

    return results


if __name__ == "__main__":
    main()
