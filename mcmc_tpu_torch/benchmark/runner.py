"""Benchmark runner: warmup -> sample -> diagnose -> gate (port of
``mcmc_tpu/benchmark/runner.py``).

The JAX runner's flags, result schema (``benchmark_results.{csv,json}``,
the reference's field list :831-888), grid search over L, failure records,
resume by signature, incremental saving, convergence trace, warmup cache
and mid-sampling resume, on the port's samplers. Its documented fixes stay:
the divergence rate is the samplers' real |dH| > 1000 count, NUTS counts
its executed leapfrogs, HMC and GRAHMC samples x L x chains everywhere.

The port's own device decisions:
- one ``torch.Generator`` on the run's device, seeded from the seed, where
  the JAX runner takes a key; each ``random.split`` becomes
  ``split_generator`` (a child generator seeded by one draw of the
  parent), so a restored warmup leaves the sampling draws as they were;
- positions are float32 on a card (the fused kernels' dtype) and float64 on
  the CPU (the JAX runner's x64 off the TPU);
- "auto" backends run the fused CUDA kernels for CUDA positions and a
  target they dispatch on, up to the kernels' D <= 128, else eager; NUTS
  "auto" is the persistent machine (kernel 4) there, else classic;
- a chain mesh is one process per rank (``--mesh N`` under ``torchrun
  --nproc-per-node N``, ``mcmc_tpu_torch.parallel``): every rank builds the
  same global positions from the seed, the warmups and the samplers with a
  sharded run (GRAHMC/HMC through kernel 1, tempering, persistent NUTS,
  ChEES, SMC) take the mesh, the other samplers run on each rank's chains
  and are gathered, and every history the diagnostics read is gathered to
  every rank, so each rank computes the same row; rank 0 alone writes the
  files, and a failure on any rank ends the run instead of becoming an
  error row;
- the CSV is written with the standard library's ``csv`` (no pandas on the
  card's machine), as pandas writes it;
- ``warmup_time`` and ``sample_time`` are the card's: every clock read
  comes after a ``torch.cuda.synchronize()``.
"""

import copy
import csv
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from mcmc_tpu_torch.diagnostics import (
    MIN_ESS_QUALITY, MIN_ESS_TAIL_QUALITY, ConvergenceW2Tracker, check_summary_statistics,
    compute_diagnostics, compute_sliced_w2, evaluate_gates, evaluate_smc_gates,
)
from mcmc_tpu_torch.ops.padded_targets import fusable
from mcmc_tpu_torch.samplers import (
    default_steepness, get_friction_schedule, grahmc_run, hmc_run, nuts_run,
    nuts_run_persistent, rwmh_run,
)
from mcmc_tpu_torch.targets import TargetDistribution, get_reference_sampler, get_target
from mcmc_tpu_torch.tuning import dual_averaging_tune_rwmh, run_adaptive_warmup

ALL_TARGET_NAMES = [
    "standard_normal", "correlated_gaussian", "ill_conditioned_gaussian",
    "student_t", "log_gamma", "rosenbrock", "neals_funnel", "gaussian_mixture",
]

DEFAULT_L_GRID = [8, 16, 24, 32, 48, 64, 96]

# Fields copied from each grid run into grid_search_info["all_results"]
_GRID_SUMMARY_FIELDS = [
    "num_steps", "ess_per_gradient", "ess_bulk_min", "ess_tail_min",
    "rhat_max", "rhat_mean", "accept_rate", "step_size", "total_samples",
    "n_gradients", "warmup_time", "sample_time", "usable", "quality_pass",
    "divergence_rate", "sliced_w2", "z_score_max", "gamma", "steepness",
    "mass_matrix_min", "mass_matrix_max", "mass_matrix_mean",
    "tempering", "swap_accept_rate",
]

TRAJECTORY_SAMPLERS = ("hmc", "grahmc", "rahmc")


# ----------------------------------------------------------------------------
# Generators, devices, timing
# ----------------------------------------------------------------------------

def make_generator(seed: int, device) -> torch.Generator:
    """The run's generator on `device`, seeded from `seed`."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A child generator on the same device, seeded by one draw of the
    parent (the JAX runner's random.split)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return make_generator(seed, generator.device)


def position_dtype(device) -> torch.dtype:
    """float32 on a card (the fused kernels'), float64 elsewhere."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _clock(device) -> float:
    """A clock read after the device's queued work has finished."""
    _sync(device)
    return time.perf_counter()


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ----------------------------------------------------------------------------
# Convergence checkpoints
# ----------------------------------------------------------------------------

def get_log_checkpoints(max_samples: int, base: float = 1.5, quantum: int = None) -> List[int]:
    """Log-spaced checkpoint counts from 100, always ending at max_samples.
    With `quantum`, the interior ones snap to its multiples (moving by at
    most quantum/2), so every batch but the last is whole chunks of one
    width; the positions are part of the result schema."""
    checkpoints = []
    current = 100.0
    while current < max_samples:
        checkpoints.append(int(current))
        current *= base
    checkpoints.append(max_samples)
    if not quantum or quantum <= 1:
        return checkpoints
    snapped = []
    for c in checkpoints[:-1]:
        q = max(quantum, int(round(c / quantum)) * quantum)
        if q < max_samples and (not snapped or q > snapped[-1]):
            snapped.append(q)
    snapped.append(max_samples)
    return snapped


def _checkpoint_chunks(batch: int, quantum: int) -> List[int]:
    """A checkpoint batch as chunks of `quantum` draws and a remainder."""
    if quantum <= 1:
        return [batch]
    chunks = [quantum] * (batch // quantum)
    if batch % quantum:
        chunks.append(batch % quantum)
    return chunks


def _grid_summary(r: Dict) -> Dict:
    out = {k: r.get(k) for k in _GRID_SUMMARY_FIELDS}
    out.setdefault("ess_per_gradient", r.get("ess_per_gradient", 0))
    return out


# ----------------------------------------------------------------------------
# Backends
# ----------------------------------------------------------------------------

def _say_past_cap(target: TargetDistribution, device) -> None:
    """Say so where a card runs this row eager for its D alone (past the
    fused kernels' cap, ops/fused_trajectory.py:MAX_DIM)."""
    from mcmc_tpu_torch.ops.fused_trajectory import MAX_DIM
    if torch.device(device).type == "cuda" and target.dim > MAX_DIM:
        print(f"  [backend] dim {target.dim} is past the fused kernels' {MAX_DIM}: "
              f"this row runs eager")


def _resolve_backend(sampler: str, target: TargetDistribution, device) -> str:
    """"fused" for RWMH (kernel 3) and HMC/GRAHMC (kernels 1 and 2) where
    the kernels take the target on this device (padded_targets.fusable),
    else "eager"."""
    if sampler not in ("rwmh",) + TRAJECTORY_SAMPLERS:
        return "eager"
    kernel = "rwmh" if sampler == "rwmh" else "grahmc"
    return "fused" if fusable(kernel, target.value_and_grad_fn, device) else "eager"


def _resolve_nuts_backend(nuts_backend: str, target: TargetDistribution, device) -> str:
    """'auto' -> 'persistent' (kernel 4 windows) where kernel 4 takes the
    target on this device, else 'classic'; explicit values pass through."""
    if nuts_backend != "auto":
        return nuts_backend
    return "persistent" if fusable("nuts", target.value_and_grad_fn, device) else "classic"


def _resolve_mesh(n_chains: int, mesh_devices="auto", device="cpu"):
    """The chain mesh of a multi-process run, or None for one process.

    "off", None, 0 and 1 are one process; "auto" is the process group's
    ranks when the run was started with more than one (torchrun), else one;
    an int N > 1 needs a group of N ranks, which parallel.distributed.
    initialize joins from torchrun's environment. A chain count that does
    not divide over the ranks runs the whole cell on every rank, as the JAX
    runner runs it on one device. The collectives take the group's backend
    (run_benchmarks_torch.py's --mesh-backend; else parallel.mesh_backend's
    rule)."""
    import torch.distributed as dist
    from mcmc_tpu_torch.parallel import make_mesh
    from mcmc_tpu_torch.parallel.distributed import initialize
    if mesh_devices in (None, "off", 0, 1):
        return None
    if mesh_devices == "auto":
        if not dist.is_initialized():
            return None
        n_dev = dist.get_world_size()
    else:
        n_dev = int(mesh_devices)
    if n_dev <= 1:
        return None
    initialize(device=device)
    if n_chains % n_dev:
        print(f"  [mesh] n_chains={n_chains} not divisible by {n_dev} ranks; "
              f"running every chain on every rank")
        return None
    return make_mesh(n_dev, device=_rank_device(device))


def _rank_device(device):
    """This rank's device: the card cuda:(rank mod cards), or the CPU."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def is_writer() -> bool:
    """Whether this process writes the run's files: the only process, or
    rank 0 of a mesh."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


# ----------------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------------

def _warmup(sampler, target, target_name, generator, init_pos, num_warmup, schedule_type,
            num_steps, learn_mass_matrix, verbose=True, nuts_backend="auto",
            trajectory_tuner="grid", nuts_proposal="endpoint", gamma_tuner="grid", mesh=None):
    """Phase 1. Returns (step_size, inv_mass, position, warmup_info).
    trajectory_tuner='chees' (HMC/GRAHMC) runs the ChEES joint adaptation
    of step, metric and trajectory length (the caller's num_steps ignored);
    RWMH tunes its scale by dual averaging and samples from `init_pos` (on
    every rank of a mesh alike, as the JAX runner's GSPMD tune is global).
    The windowed and ChEES warmups take the mesh."""
    device = init_pos.device
    vag = target.value_and_grad_fn
    is_grahmc = sampler in ("grahmc", "rahmc")
    if sampler == "rwmh":
        scale, _hist = dual_averaging_tune_rwmh(
            generator, target.log_prob_fn, init_pos, max_iter=1000, value_and_grad_fn=vag,
            backend=_resolve_backend("rwmh", target, device))
        return scale, None, init_pos, {"scale": scale}

    if trajectory_tuner == "chees" and sampler in TRAJECTORY_SAMPLERS:
        from mcmc_tpu_torch.tuning.chees import run_chees_warmup
        return run_chees_warmup(
            "grahmc" if is_grahmc else sampler, target.log_prob_fn, None, init_pos, generator,
            num_warmup=num_warmup, schedule_type=schedule_type if is_grahmc else None,
            learn_mass_matrix=learn_mass_matrix, value_and_grad_fn=vag, verbose=verbose,
            gamma=1.0, steepness=default_steepness(schedule_type) if is_grahmc else None,
            gamma_tuner=gamma_tuner, mesh=mesh)

    kwargs = {}
    backend = "auto"
    if sampler == "hmc":
        kwargs["num_steps"] = num_steps
    elif sampler == "nuts":
        kwargs["max_tree_depth"] = 15    # wider during warmup (reference :533)
        kwargs["nuts_proposal"] = nuts_proposal
        if nuts_backend == "persistent":
            backend = "persistent"
    elif is_grahmc:
        kwargs["num_steps"] = num_steps
        kwargs["gamma"] = 1.0
        kwargs["steepness"] = default_steepness(schedule_type)
        backend = _resolve_backend(sampler, target, device)
    else:
        raise ValueError(f"Unknown sampler: {sampler}")
    return run_adaptive_warmup(
        "grahmc" if is_grahmc else sampler, target.log_prob_fn, None, init_pos, generator,
        num_warmup=num_warmup, target_accept=0.65,
        schedule_type=schedule_type if is_grahmc else None,
        learn_mass_matrix=learn_mass_matrix, value_and_grad_fn=vag, verbose=verbose,
        backend=backend, mesh=mesh, **kwargs)


def _sample(sampler, target, generator, position, step_size, num_steps, num_samples, inv_mass,
            schedule_type, warmup_info, backend: str = "auto", mesh=None,
            nuts_backend: str = "auto", nuts_steps_per_sample: int = 64,
            nuts_proposal: str = "endpoint", tempering: int = 0,
            tempering_beta_min: float = 0.05, tempering_swap_interval: int = 1,
            replica_position=None, tempering_betas=None, tempering_step_sizes=None):
    """Phase 2 dispatch; returns the sampler's RunResult. tempering > 1
    (HMC/GRAHMC) runs the replica-exchange ladder and emits the cold
    replica's draws; replica_position carries the whole (K C, D) ladder
    from one checkpoint batch to the next.

    With a mesh (positions global, the same on every rank): tempering,
    persistent NUTS and fused HMC/GRAHMC take their sharded runs
    (parallel.fused_sharded, the JAX runner's dispatch); every other
    sampler runs on the rank's chains with its folded generator and is
    gathered (where the JAX runner lets GSPMD partition it)."""
    device = position.device if mesh is None else mesh.device
    if backend == "auto":
        backend = _resolve_backend(sampler, target, device)
    nuts_backend = _resolve_nuts_backend(nuts_backend, target, device)
    vag = target.value_and_grad_fn
    is_hmc = sampler == "hmc"
    friction = dict(gamma=0.0 if is_hmc else warmup_info.get("gamma", 1.0),
                    steepness=0.0 if is_hmc else warmup_info.get("steepness", 5.0),
                    friction_schedule=None if is_hmc else get_friction_schedule(schedule_type))
    if mesh is not None:
        from mcmc_tpu_torch.parallel import fused_sharded as fs
        n_local = position.shape[0] // mesh.size
    if tempering and tempering > 1 and sampler in TRAJECTORY_SAMPLERS:
        from mcmc_tpu_torch.samplers.tempered import tempered_run
        if tempering_step_sizes is not None:
            step_size = torch.as_tensor(np.asarray(tempering_step_sizes, np.float32),
                                        device=device)
        if mesh is not None:
            return fs.tempered_run_sharded(
                generator, target, position, mesh, step_size, num_steps=num_steps,
                num_samples=num_samples, n_temps=tempering, beta_min=tempering_beta_min,
                swap_interval=tempering_swap_interval, inv_mass_matrix=inv_mass,
                backend=backend, replica_position=replica_position, betas=tempering_betas,
                **friction)
        return tempered_run(
            generator, target.log_prob_fn, position, step_size, num_steps=num_steps,
            num_samples=num_samples, betas=tempering_betas, n_temps=tempering,
            beta_min=tempering_beta_min, swap_interval=tempering_swap_interval, burn_in=0,
            inv_mass_matrix=inv_mass, value_and_grad_fn=vag, backend=backend,
            init_replica_position=replica_position, **friction)
    if mesh is not None and sampler == "nuts" and nuts_backend == "persistent":
        return fs.nuts_persistent_run_sharded(
            generator, target, position, mesh, step_size, num_samples,
            steps_per_sample=nuts_steps_per_sample, burn_in_steps=0, inv_mass_matrix=inv_mass,
            max_tree_depth=10, collect_chains_per_device=n_local,
            proposal_scheme=nuts_proposal,
            backend="fused" if fusable("nuts", vag, device) else "eager")
    if mesh is not None and backend == "fused" and sampler in TRAJECTORY_SAMPLERS:
        return fs.grahmc_run_sharded(
            generator, target, position, mesh, step_size, num_steps, friction["gamma"],
            friction["steepness"], num_samples, inv_mass_matrix=inv_mass,
            friction_schedule=friction["friction_schedule"], collect_chains_per_device=n_local)
    if mesh is not None:
        from mcmc_tpu_torch.parallel import rank_generator, shard_chains
        res = _sample(sampler, target, rank_generator(generator, mesh),
                      shard_chains(position, mesh), step_size, num_steps, num_samples,
                      inv_mass, schedule_type, warmup_info, backend=backend,
                      nuts_backend=nuts_backend)
        for key in ("tree_depths", "mean_accept_probs"):      # classic NUTS: (draws, chains)
            if key in res.info:
                res.info[key] = fs.gather_history(res.info[key], mesh)
        return fs.gather_result(res, mesh, num_samples)
    if sampler == "rwmh":
        return rwmh_run(generator, target.log_prob_fn, position, num_samples=num_samples,
                        scale=step_size, burn_in=0, value_and_grad_fn=vag, backend=backend)
    if sampler == "hmc":
        return hmc_run(generator, target.log_prob_fn, position, step_size=step_size,
                       num_steps=num_steps, num_samples=num_samples, burn_in=0,
                       inv_mass_matrix=inv_mass, value_and_grad_fn=vag, backend=backend)
    if sampler == "nuts":
        if nuts_backend == "persistent":
            return nuts_run_persistent(
                generator, target.log_prob_fn, position, step_size=step_size,
                num_samples=num_samples, steps_per_sample=nuts_steps_per_sample,
                burn_in_steps=0, inv_mass_matrix=inv_mass, max_tree_depth=10,
                value_and_grad_fn=vag, proposal_scheme=nuts_proposal)
        return nuts_run(generator, target.log_prob_fn, position, step_size=step_size,
                        num_samples=num_samples, burn_in=0, inv_mass_matrix=inv_mass,
                        max_tree_depth=10, value_and_grad_fn=vag)
    if sampler in ("grahmc", "rahmc"):
        return grahmc_run(generator, target.log_prob_fn, position, step_size, num_steps,
                          friction["gamma"], friction["steepness"], num_samples, burn_in=0,
                          inv_mass_matrix=inv_mass, friction_schedule=friction["friction_schedule"],
                          value_and_grad_fn=vag, backend=backend)
    raise ValueError(f"Unknown sampler: {sampler}")


def _init_positions(target, generator, n_chains):
    dtype = position_dtype(generator.device)
    if target.init_sampler is not None:
        return target.init_sampler(generator, n_chains, dtype=dtype)
    return torch.randn((n_chains, target.dim), generator=generator, device=generator.device,
                       dtype=dtype) * 0.1


def _warmup_backend_tag(sampler, nuts_backend, nuts_proposal, use_chees, gamma_tuner) -> str:
    """The backend part of the warmup cache's key (the JAX runner's)."""
    if sampler == "nuts":
        return nuts_backend if nuts_proposal == "endpoint" else f"{nuts_backend}-{nuts_proposal}"
    if use_chees:
        return "chees" if (gamma_tuner == "grid" or sampler == "hmc") else f"chees-{gamma_tuner}"
    return ""


def _piece_stats(res, use_tempering: bool) -> Dict:
    st = {"draws": int(res.samples.shape[0]),
          "accept_mean": float(res.accept_rate.mean()),
          "total_divergences": int(res.info["total_divergences"])}
    if use_tempering:
        for k in ("swap_attempts", "swap_accept_rate", "replica_accept_rate", "betas"):
            st[k] = _host(res.info[k]).astype(np.float64).tolist()
    return st


def _mean_tree_depth(res) -> float:
    return float(_host(res.info["mean_tree_depth"]).mean())


def run_single_benchmark_with_L(
    sampler: str,
    target: TargetDistribution,
    target_name: str,
    generator: torch.Generator,
    n_chains: int,
    num_warmup: int,
    num_samples: int,
    schedule_type: str,
    num_steps: int,
    learn_mass_matrix=True,
    track_convergence: bool = False,
    convergence_base: float = 1.5,
    mesh_devices="auto",
    nuts_backend: str = "auto",
    warmup_cache_dir: Optional[str] = None,
    nuts_steps_per_sample: int = 64,
    trajectory_tuner: str = "grid",
    gamma_tuner: str = "grid",
    nuts_proposal: str = "endpoint",
    tempering: int = 0,
    tempering_beta_min: float = 0.05,
    tempering_swap_interval: int = 1,
    tempering_ladder: str = "geometric",
) -> Dict:
    """One warmup + sample + diagnose + gate pipeline at a fixed trajectory
    length; the result row, or an error row when a phase raised.

    `generator` lives on the run's device (positions, kernels and draws
    follow it). tempering=K > 1 (HMC/GRAHMC) samples through the K-rung
    ladder (tempering_ladder 'geometric', or 'adaptive': Robbins-Monro on
    its log-spacings toward 0.234 swap acceptance first); n_gradients counts
    every rung. warmup_cache_dir keeps Phase 1's products per signature and
    restores them; with track_convergence it also keeps the sampling phase
    at each checkpoint (SamplingCheckpoint). trajectory_tuner='chees'
    (HMC/GRAHMC) ignores num_steps: one warmup tunes T, and the sampling
    runs jittered trajectories around it.
    """
    is_grahmc = sampler in ("grahmc", "rahmc")
    use_tempering = bool(tempering and tempering > 1 and sampler in TRAJECTORY_SAMPLERS)
    if use_tempering and trajectory_tuner == "chees":
        raise ValueError("tempering composes with the fixed-L pipeline, "
                         "not the ChEES tuner; drop one of the two")
    if tempering_ladder not in ("geometric", "adaptive"):
        raise ValueError(f"tempering_ladder must be 'geometric' or "
                         f"'adaptive', got {tempering_ladder!r}")
    device = generator.device
    header = f"BENCHMARK: {sampler.upper()} on {target.name}"
    if is_grahmc:
        header += f" [{schedule_type}]"
    if use_tempering:
        header += f" [tempered K={tempering}]"
    print(f"\n{'=' * 80}\n{header}  (L={num_steps}, "
          f"mass={'learned' if learn_mass_matrix else 'identity'})\n{'=' * 80}")

    start_time = _clock(device)
    mesh = _resolve_mesh(n_chains, mesh_devices, device)
    _say_past_cap(target, device)
    if sampler == "nuts":
        nuts_backend = _resolve_nuts_backend(nuts_backend, target, device)
        print(f"  [nuts] backend: {nuts_backend}")
    try:
        init_pos = _init_positions(target, split_generator(generator), n_chains)
        use_chees = trajectory_tuner == "chees" and sampler in TRAJECTORY_SAMPLERS

        # Phase 1: adaptive warmup (or its cached products)
        warmup_sig = cached = None
        if warmup_cache_dir is not None:
            from mcmc_tpu_torch.utils.checkpoint import load_warmup, warmup_signature
            warmup_sig = warmup_signature(
                sampler, target_name, schedule_type if is_grahmc else None,
                0 if use_chees else num_steps, learn_mass_matrix, n_chains, target.dim,
                num_warmup=num_warmup,
                backend=_warmup_backend_tag(sampler, nuts_backend, nuts_proposal, use_chees,
                                            gamma_tuner))
            cached = load_warmup(warmup_cache_dir, warmup_sig, device=device)
            if cached is not None and use_chees and "trajectory_length" not in cached[3]:
                cached = None
        warmup_start = _clock(device)
        # drawn whether or not the warmup runs, so that a restored warmup
        # leaves every later draw of the run as it was
        warm_gen = split_generator(generator)
        if cached is not None:
            step_size, inv_mass, position, warmup_info = cached
            position = position.to(init_pos.dtype)
            if inv_mass is not None:
                inv_mass = inv_mass.to(init_pos.dtype)
            warmup_restored = True
            print(f"[Phase 1] Warmup restored from checkpoint "
                  f"({warmup_sig}): step_size={step_size:.4f}")
        else:
            print("[Phase 1] Adaptive warmup...")
            step_size, inv_mass, position, warmup_info = _warmup(
                sampler, target, target_name, warm_gen, init_pos, num_warmup, schedule_type,
                num_steps, learn_mass_matrix, nuts_backend=nuts_backend,
                trajectory_tuner=trajectory_tuner, nuts_proposal=nuts_proposal,
                gamma_tuner=gamma_tuner, mesh=mesh)
            warmup_restored = False
            if warmup_cache_dir is not None and is_writer():
                from mcmc_tpu_torch.utils.checkpoint import save_warmup
                save_warmup(warmup_cache_dir, warmup_sig, step_size, inv_mass, position,
                            warmup_info)
        step_size = float(step_size)
        warmup_time = _clock(device) - warmup_start
        print(f"  warmup {warmup_time:.1f}s, step_size={step_size:.4f}")

        sample_kw = dict(mesh=mesh, nuts_backend=nuts_backend,
                         nuts_steps_per_sample=nuts_steps_per_sample,
                         nuts_proposal=nuts_proposal, tempering=tempering,
                         tempering_beta_min=tempering_beta_min,
                         tempering_swap_interval=tempering_swap_interval)

        # Phase 1b: adaptive tempering ladder
        tempering_betas = tempering_steps = ladder_replica_pos = None
        ladder_meta = {}
        if use_tempering and tempering_ladder == "adaptive":
            from mcmc_tpu_torch.tuning.dual_averaging import TARGET_ACCEPT_HMC
            from mcmc_tpu_torch.tuning.ladder import tune_ladder
            print("[Phase 1b] Adapting tempering ladder (Robbins-Monro on log-spacings, "
                  f"target swap 0.234; per-rung steps toward accept {TARGET_ACCEPT_HMC})...")
            ladder_start = _clock(device)
            ladder_gen = split_generator(generator)
            burst_draws = max(16, 2 * tempering_swap_interval)

            def _ladder_burst(betas, steps, replica_pos):
                r = _sample(sampler, target, ladder_gen, position, step_size, num_steps,
                            burst_draws, inv_mass, schedule_type, warmup_info,
                            replica_position=replica_pos, tempering_betas=betas,
                            tempering_step_sizes=steps, **sample_kw)
                return (_host(r.info["swap_accept_rate"]), _host(r.info["swap_attempts"]),
                        _host(r.info["replica_accept_rate"]),
                        r.info["replica_final_positions"])

            tempering_betas, ladder_info = tune_ladder(
                _ladder_burst, tempering, beta_min_init=tempering_beta_min, n_rounds=16,
                step_size=step_size, target_accept=TARGET_ACCEPT_HMC)
            tempering_steps = ladder_info["step_sizes"]
            ladder_replica_pos = ladder_info["replica_final_positions"]
            ladder_time = _clock(device) - ladder_start
            ladder_meta = {
                "tempering_ladder": "adaptive",
                "ladder_tune_time": ladder_time,
                "ladder_rounds": ladder_info["n_rounds"],
                "ladder_initial_deviation": ladder_info["initial_deviation"],
                "ladder_final_deviation": ladder_info["final_deviation"],
                "tempering_step_sizes": [round(float(x), 5) for x in tempering_steps],
            }
            print(f"  ladder {ladder_time:.1f}s, mean|A-0.234| "
                  f"{ladder_info['initial_deviation']:.3f} -> "
                  f"{ladder_info['final_deviation']:.3f}, beta_min="
                  f"{float(tempering_betas[-1]):.4f}, steps="
                  f"{[round(float(x), 3) for x in tempering_steps]}")
        elif use_tempering:
            ladder_meta = {"tempering_ladder": "geometric"}

        chees_T = None
        if use_chees:
            num_steps = warmup_info["num_steps"]
            chees_T = warmup_info["trajectory_length"]
            if warmup_info.get("max_steps_cap_hit"):
                print("  [chees] trajectory cap hit — skipping sampling "
                      "(caller should fall back to the L grid search)")
                return {
                    "sampler": sampler, "target": target.name,
                    "schedule": schedule_type if is_grahmc else None,
                    "mass_matrix_learned": learn_mass_matrix,
                    "trajectory_tuner": "chees", "chees_cap_hit": True,
                    "chees_trajectory_length": chees_T,
                    "num_steps": num_steps, "step_size": step_size,
                    "warmup_time": warmup_time,
                    "error": "chees trajectory cap hit (criterion runaway)",
                }
            print(f"  [chees] trajectory tuned: T={chees_T:.4f} -> L={num_steps} "
                  f"(jittered sampling)")

        def _draws(gen, pos, n_draws, replica_pos, offset):
            """One sampling call of n_draws: ChEES's jittered run or _sample."""
            if use_chees:
                from mcmc_tpu_torch.tuning.chees import chees_run
                return chees_run(
                    gen, target.log_prob_fn, pos, step_size, chees_T, n_draws,
                    inv_mass_matrix=inv_mass, value_and_grad_fn=target.value_and_grad_fn,
                    schedule_type=schedule_type if is_grahmc else None,
                    gamma=warmup_info.get("gamma", 0.0),
                    steepness=warmup_info.get("steepness", 1.0), halton_offset=offset,
                    mesh=mesh)
            return _sample(sampler, target, gen, pos, step_size, num_steps, n_draws, inv_mass,
                           schedule_type, warmup_info, replica_position=replica_pos,
                           tempering_betas=tempering_betas,
                           tempering_step_sizes=tempering_steps, **sample_kw)

        # Phase 2: sampling, optionally with convergence checkpoints
        convergence_trace = None
        tempered_run_stats = None
        chees_leapfrogs = 0
        halton_cursor = warmup_info.get("halton_offset", 0) if use_chees else 0
        run_betas = None
        sampling_ckpt = None
        res = None
        sample_start = _clock(device)
        if track_convergence and sampler in TRAJECTORY_SAMPLERS:
            quantum = min(50, max(1, num_samples // 4))
            checkpoints = get_log_checkpoints(num_samples, base=convergence_base,
                                              quantum=quantum)
            print(f"[Phase 2] Sampling with {len(checkpoints)} convergence checkpoints "
                  f"(chunk width {quantum})...")
            convergence_trace, piece_samples, piece_stats = [], [], []
            prev = 0
            replica_pos = ladder_replica_pos
            w2_gen = split_generator(generator)
            w2_state = None
            if warmup_sig is not None:
                from mcmc_tpu_torch.utils.checkpoint import SamplingCheckpoint
                sampling_ckpt = SamplingCheckpoint(warmup_cache_dir, warmup_sig, config={
                    "num_samples": int(num_samples),
                    "quantum": int(quantum),
                    "convergence_base": float(convergence_base),
                    "tempering": int(tempering or 0),
                    # the JAX runner's stamp leaves these two out, so a
                    # checkpoint of another ladder would be resumed there
                    "tempering_beta_min": float(tempering_beta_min),
                    "tempering_swap_interval": int(tempering_swap_interval),
                    "chees": bool(use_chees),
                    "step_size": float(step_size),
                })
                restored = sampling_ckpt.load(device=device)
                if restored is not None and restored["prev"] > 0:
                    prev = restored["prev"]
                    generator.set_state(restored["generator_state"])
                    w2_state = restored["w2_generator_state"]
                    position = restored["position"].to(init_pos.dtype)
                    halton_cursor = restored["halton_cursor"]
                    chees_leapfrogs = restored["chees_leapfrogs"]
                    convergence_trace = restored["convergence_trace"]
                    piece_samples = restored["piece_samples"]
                    piece_stats = restored["piece_stats"]
                    if restored["replica_pos"] is not None:
                        replica_pos = restored["replica_pos"].to(init_pos.dtype)
                    print(f"  [resume] mid-sampling checkpoint restored "
                          f"at draw {prev}/{num_samples}")

            # one reference draw and direction set for the whole trace
            w2_tracker = ConvergenceW2Tracker(target_name, target.dim, n_reference=50000,
                                              n_projections=500, generator=w2_gen)
            if w2_state is not None:
                w2_gen.set_state(w2_state)
            for cp in checkpoints:
                if cp <= prev:
                    continue
                batch = cp - prev
                prev = cp
                for chunk in _checkpoint_chunks(batch, quantum):
                    res = _draws(generator, position, chunk, replica_pos, halton_cursor)
                    if use_chees:
                        halton_cursor += chunk
                        chees_leapfrogs += res.info["total_leapfrogs"]
                    else:
                        replica_pos = res.info.get("replica_final_positions")
                    position = res.final_state.position
                    piece_samples.append(res.samples)
                    piece_stats.append(_piece_stats(res, use_tempering))
                cumulative = torch.cat(piece_samples, dim=0)
                w2 = w2_tracker.w2(cumulative) if w2_tracker.ok else None
                cp_diag = compute_diagnostics(cumulative)
                n_grad_cp = (chees_leapfrogs if use_chees else cp * num_steps) * n_chains
                if use_tempering:
                    n_grad_cp *= tempering
                convergence_trace.append({
                    "checkpoint": int(cp),
                    "n_gradients": int(n_grad_cp),
                    "w2_distance": float(w2) if w2 is not None else None,
                    "ess_bulk_min": float(cp_diag["ess_bulk_min"]),
                    "ess_tail_min": float(cp_diag["ess_tail_min"]),
                    "rhat_max": float(cp_diag["rhat_max"]),
                })
                if sampling_ckpt is not None and is_writer():
                    sampling_ckpt.save(prev, generator.get_state(), w2_gen.get_state(),
                                       position, replica_pos if use_tempering else None,
                                       halton_cursor, chees_leapfrogs, convergence_trace,
                                       piece_samples, piece_stats)
            samples = torch.cat(piece_samples, dim=0)
            piece_draws = np.array([s["draws"] for s in piece_stats], np.float64)
            accept_rate = float(np.sum([s["accept_mean"] * d
                                        for s, d in zip(piece_stats, piece_draws)])
                                / piece_draws.sum())
            total_div = int(sum(s["total_divergences"] for s in piece_stats))
            divergence_rate = total_div / (num_samples * n_chains)
            tree_depths = None
            if use_tempering:
                att = np.array([s["swap_attempts"] for s in piece_stats])
                acc = np.array([s["swap_accept_rate"] for s in piece_stats])
                rep = np.array([s["replica_accept_rate"] for s in piece_stats])
                tempered_run_stats = {
                    "swap_accept_rate": (acc * att).sum(0) / np.maximum(att.sum(0), 1.0),
                    "replica_accept_rate": (rep * piece_draws[:, None]).sum(0)
                    / piece_draws.sum(),
                }
                run_betas = piece_stats[-1]["betas"]
        else:
            print(f"[Phase 2] Sampling {num_samples} draws...")
            res = _draws(split_generator(generator), position, num_samples, ladder_replica_pos,
                         halton_cursor)
            if use_chees:
                chees_leapfrogs += res.info["total_leapfrogs"]
            samples = res.samples
            accept_rate = float(res.accept_rate.mean())
            total_div = int(res.info["total_divergences"])
            divergence_rate = float(res.info["divergence_rate"])
            tree_depths = res.info.get("tree_depths")
        sample_time = _clock(device) - sample_start
        print(f"  sampling {sample_time:.1f}s, accept={accept_rate:.3f}, "
              f"div={divergence_rate:.2%}")

        # Gradient accounting (exact: Python ints)
        avg_tree_depth = None
        if sampler == "nuts" and res is not None and "n_leapfrogs" in res.info:
            n_gradients = int(res.info["n_leapfrogs"])
            avg_tree_depth = _mean_tree_depth(res)
        elif sampler == "nuts" and tree_depths is not None:
            depths = tree_depths.to(torch.int64)
            n_gradients = int(((1 << depths) - 1).sum())
            avg_tree_depth = float(depths.to(torch.float64).mean())
        elif sampler == "rwmh":
            n_gradients = 0
        elif use_chees:
            n_gradients = chees_leapfrogs * n_chains
        else:
            n_gradients = num_samples * num_steps * n_chains
            if use_tempering:
                n_gradients *= tempering

        # Sampler metadata
        if sampler == "rwmh":
            sampler_metadata = {"scale": step_size}
        elif sampler == "hmc":
            sampler_metadata = {"step_size": step_size, "num_steps": num_steps}
        elif sampler == "nuts":
            sampler_metadata = {"step_size": step_size, "max_tree_depth": 10,
                                "avg_tree_depth": avg_tree_depth,
                                "nuts_backend": nuts_backend}
            if nuts_backend == "persistent":
                sampler_metadata["nuts_steps_per_sample"] = nuts_steps_per_sample
                sampler_metadata["nuts_proposal"] = nuts_proposal
        else:
            sampler_metadata = {"step_size": step_size, "num_steps": num_steps,
                                "gamma": warmup_info.get("gamma", 1.0),
                                "steepness": warmup_info.get("steepness", 5.0),
                                "schedule": schedule_type}
            if "gamma_tuner" in warmup_info:
                sampler_metadata["gamma_tuner"] = warmup_info["gamma_tuner"]
        if use_tempering and (res is not None or run_betas is not None):
            swap_stats = tempered_run_stats or res.info
            if run_betas is None:
                run_betas = res.info["betas"]
            sampler_metadata.update(
                tempering=int(tempering),
                tempering_beta_min=float(tempering_beta_min),
                tempering_swap_interval=int(tempering_swap_interval),
                swap_accept_rate=[round(float(x), 4)
                                  for x in _host(swap_stats["swap_accept_rate"])],
                replica_accept_rate=[round(float(x), 4)
                                     for x in _host(swap_stats["replica_accept_rate"])],
                tempering_betas=[round(float(x), 4) for x in _host(run_betas)],
                **ladder_meta)
        if use_chees:
            sampler_metadata.update(trajectory_tuner="chees", chees_trajectory_length=chees_T,
                                    mean_num_steps=chees_leapfrogs / num_samples)

        # Phase 3: diagnostics and gates
        print("[Phase 3] Diagnostics...")
        diagnostics = compute_diagnostics(samples)
        stats_result = check_summary_statistics(diagnostics, target, significance=0.05)
        stats_pass = stats_result["pass"]
        has_true_mean = target.true_mean is not None and target.true_cov is not None
        # reparameterized targets: z-test the constrained coordinates too
        stats_result_t = None
        if (target.transform is not None and target.transform_true_mean is not None
                and target.transform_true_cov is not None):
            diag_t = compute_diagnostics(target.transform(samples))
            stats_result_t = check_summary_statistics(
                diag_t, SimpleNamespace(true_mean=target.transform_true_mean,
                                        true_cov=target.transform_true_cov),
                significance=0.05)
            stats_pass = stats_pass and stats_result_t["pass"]
            has_true_mean = True
        gates = evaluate_gates(diagnostics["rhat_max"], diagnostics["ess_bulk_min"],
                               diagnostics["ess_tail_min"], divergence_rate, num_samples,
                               stats_pass, has_true_mean)
        total_time = _clock(device) - start_time

        # Phase 4: Sliced-W2 against exact draws
        sliced_w2 = None
        if get_reference_sampler(target_name, target.dim) is not None:
            print("[Phase 4] Sliced W2...")
            sliced_w2 = compute_sliced_w2(samples, target_name, target.dim, n_reference=50000,
                                          n_projections=500,
                                          generator=split_generator(generator))
        sliced_w2_transformed = None
        if target.transform is not None and target.transform_target is not None:
            sliced_w2_transformed = compute_sliced_w2(
                target.transform(samples), target.transform_target, target.dim,
                n_reference=50000, n_projections=500, generator=split_generator(generator))

        results = {
            "sampler": sampler,
            "target": target.name,
            "schedule": schedule_type if is_grahmc else None,
            "dim": target.dim,
            "num_steps": num_steps if sampler in TRAJECTORY_SAMPLERS else None,
            "n_chains": n_chains,
            "num_warmup": num_warmup,
            "num_samples": num_samples,
            "total_samples": num_samples,
            "warmup_time": warmup_time,
            "sample_time": sample_time,
            "total_time": total_time,
            "accept_rate": accept_rate,
            "rhat_max": diagnostics["rhat_max"],
            "rhat_mean": diagnostics["rhat_mean"],
            "ess_bulk_min": diagnostics["ess_bulk_min"],
            "ess_bulk_mean": diagnostics["ess_bulk_mean"],
            "ess_tail_min": diagnostics["ess_tail_min"],
            "ess_tail_mean": diagnostics["ess_tail_mean"],
            "ess_per_sample": gates["ess_per_sample"],
            "ess_per_gradient": (diagnostics["ess_bulk_min"] / n_gradients
                                 if n_gradients > 0 else 0),
            "divergence_rate": divergence_rate,
            "total_divergences": total_div,
            "n_gradients": n_gradients,
            "rhat_pass": diagnostics["rhat_max"] < 1.01,
            "ess_pass": diagnostics["ess_bulk_min"] >= MIN_ESS_QUALITY,
            "ess_tail_pass": diagnostics["ess_tail_min"] >= MIN_ESS_TAIL_QUALITY,
            "stats_pass": stats_pass,
            "z_score_max": stats_result.get("max_z"),
            "z_score_threshold": stats_result.get("threshold"),
            "usable": gates["usable"],
            "quality_pass": gates["quality_pass"],
            "is_inefficient": gates["is_inefficient"],
            "is_high_efficiency": gates["is_high_efficiency"],
            "sliced_w2": sliced_w2,
            "sliced_w2_transformed": sliced_w2_transformed,
            "convergence_trace": convergence_trace if track_convergence else None,
            "reparam": "log" if target.family.endswith("_unconstrained") else None,
            "stats_pass_transformed": stats_result_t["pass"] if stats_result_t else None,
            "z_score_max_transformed": (stats_result_t.get("max_z")
                                        if stats_result_t else None),
        }
        results.update(sampler_metadata)
        results["warmup_restored"] = warmup_restored
        results["mesh_devices"] = mesh.size if mesh is not None else None
        results["mass_matrix_learned"] = learn_mass_matrix
        if learn_mass_matrix and inv_mass is not None:
            results["mass_matrix_min"] = float(torch.min(inv_mass))
            results["mass_matrix_max"] = float(torch.max(inv_mass))
            results["mass_matrix_mean"] = float(torch.mean(inv_mass))

        status = ("[PASS]" if results["quality_pass"]
                  else "[USABLE]" if results["usable"] else "[FAIL]")
        print(f"{status} R-hat={results['rhat_max']:.4f} "
              f"ESS={results['ess_bulk_min']:.0f}/{results['ess_tail_min']:.0f} "
              f"div={divergence_rate:.1%} "
              f"W2={sliced_w2 if sliced_w2 is None else round(sliced_w2, 4)} "
              f"({total_time:.1f}s)")
        if sampling_ckpt is not None and is_writer():
            sampling_ckpt.clear()
        return results

    except Exception as e:
        if mesh is not None:
            raise     # one rank's failure: the ranks cannot go on in step
        import traceback
        traceback.print_exc()
        return {
            "sampler": sampler,
            "target": target.name,
            "schedule": schedule_type if is_grahmc else None,
            "dim": target.dim,
            "num_steps": num_steps,
            "tempering": int(tempering) if use_tempering else None,
            "total_samples": 0,
            "ess_bulk_min": 0.0,
            "n_gradients": 0,
            "divergence_rate": None,
            "error": str(e),
            "total_time": _clock(device) - start_time,
            "usable": False,
            "quality_pass": False,
        }


def run_single_smc_benchmark(
    target: TargetDistribution,
    target_name: str,
    generator: torch.Generator,
    n_particles: int = 4096,
    move_steps: int = 3,
    num_steps: int = 8,
    step_size: float = 0.4,
    base_scale: float = 2.0,
    target_rel_ess: float = 0.5,
    max_stages: int = 200,
    mesh_devices="auto",
    tune_trajectory: bool = False,
) -> Dict:
    """One annealed-SMC row: n_particles carried from N(0, base_scale^2 I)
    to the target, log Z estimated, the final weighted population gated
    (evaluate_smc_gates). No warmup and no chains over time: the
    non-applicable fields are None, and the row adds ``log_z`` and the
    ``smc_*`` extras. The moves run kernel 1c where it takes the target."""
    from mcmc_tpu_torch.samplers.smc import smc_run, systematic_resample, weighted_moments

    device = generator.device
    start_time = _clock(device)
    print(f"\n{'=' * 70}\nSMC | {target_name} | dim={target.dim} | "
          f"P={n_particles} | moves={move_steps}x{num_steps} leapfrogs"
          f"\n{'=' * 70}")
    if target.support == "positive":
        print("  [WARN] positive-support target under a full-support "
              "Gaussian base: mass leaks outside the support at small "
              "beta. Run with --reparam auto for the unconstrained bridge.")
    mesh = _resolve_mesh(n_particles, mesh_devices, device)
    _say_past_cap(target, device)
    try:
        run_gen = split_generator(generator)
        where = f"mesh {mesh.size} ranks" if mesh is not None else "single-device"
        print(f"[Phase 1] Annealing ({where}, adaptive schedule, "
              f"target rel-ESS {target_rel_ess})...")
        sample_start = _clock(device)
        common = dict(n_particles=n_particles, dim=target.dim, step_size=step_size,
                      num_steps=num_steps, move_steps=move_steps, max_stages=max_stages,
                      base_scale=base_scale, target_rel_ess=target_rel_ess,
                      value_and_grad_fn=target.value_and_grad_fn,
                      tune_trajectory=tune_trajectory, dtype=position_dtype(device))
        if mesh is not None:
            from mcmc_tpu_torch.parallel.fused_sharded import smc_run_sharded
            res = smc_run_sharded(run_gen, target.log_prob_fn, mesh, **common)
        else:
            res = smc_run(run_gen, target.log_prob_fn, **common)
        sample_time = _clock(device) - sample_start

        n_stages = int(res.info["n_stages"])
        ess = float(res.info["ess"])
        log_z = float(res.log_Z)
        accept_rate = float(_host(res.info["accept"])[:n_stages].mean()) if n_stages else 0.0
        total_div = int(res.info["n_divergences"])
        divergence_rate = total_div / max(n_stages * move_steps * n_particles, 1)
        n_gradients = int(res.info["n_leapfrogs"]) * n_particles
        print(f"  {n_stages} stages, {int(res.info['n_resamples'])} "
              f"resamples, log_Z={log_z:.4f}, ESS={ess:.0f}, "
              f"accept={accept_rate:.3f} ({sample_time:.1f}s)")

        # Phase 2: gates on the weighted population; the z-test's MCSE is
        # sqrt(Var_w[x_i] / ESS_w)
        print("[Phase 2] Diagnostics + gates...")
        wmean, wcov = weighted_moments(res.particles, res.log_weights)
        mcse = np.sqrt(np.maximum(_host(torch.diagonal(wcov)), 0.0) / max(ess, 1.0))
        stats_result = check_summary_statistics({"summary": {"mean": _host(wmean),
                                                             "mcse_mean": mcse}},
                                                target, significance=0.05)
        stats_pass = stats_result["pass"]
        has_true_mean = target.true_mean is not None and target.true_cov is not None
        stats_result_t = None
        if (target.transform is not None and target.transform_true_mean is not None
                and target.transform_true_cov is not None):
            wmean_t, wcov_t = weighted_moments(target.transform(res.particles), res.log_weights)
            mcse_t = np.sqrt(np.maximum(_host(torch.diagonal(wcov_t)), 0.0) / max(ess, 1.0))
            stats_result_t = check_summary_statistics(
                {"summary": {"mean": _host(wmean_t), "mcse_mean": mcse_t}},
                SimpleNamespace(true_mean=target.transform_true_mean,
                                true_cov=target.transform_true_cov),
                significance=0.05)
            stats_pass = stats_pass and stats_result_t["pass"]
            has_true_mean = True
        gates = evaluate_smc_gates(ess, divergence_rate, log_z, n_particles, stats_pass,
                                   has_true_mean)

        # Phase 3: Sliced-W2 of the population resampled once (unweighted)
        has_ref = get_reference_sampler(target_name, target.dim) is not None
        sliced_w2 = sliced_w2_transformed = None
        if has_ref or target.transform is not None:
            print("[Phase 3] Sliced W2...")
            idx = systematic_resample(split_generator(generator), res.log_weights)
            flat = res.particles[idx]
            if has_ref:
                sliced_w2 = compute_sliced_w2(flat, target_name, target.dim, n_reference=50000,
                                              n_projections=500,
                                              generator=split_generator(generator))
            if target.transform is not None and target.transform_target is not None:
                sliced_w2_transformed = compute_sliced_w2(
                    target.transform(flat), target.transform_target, target.dim,
                    n_reference=50000, n_projections=500, generator=split_generator(generator))

        total_time = _clock(device) - start_time
        results = {
            "sampler": "smc",
            "target": target.name,
            "schedule": None,
            "dim": target.dim,
            "num_steps": num_steps,
            "n_chains": n_particles,
            "num_warmup": 0,
            "num_samples": n_particles,
            "total_samples": n_particles,
            "warmup_time": 0.0,
            "sample_time": sample_time,
            "total_time": total_time,
            "accept_rate": accept_rate,
            "rhat_max": None,
            "rhat_mean": None,
            "ess_bulk_min": ess,
            "ess_bulk_mean": ess,
            "ess_tail_min": None,
            "ess_tail_mean": None,
            "ess_per_sample": gates["ess_per_sample"],
            "ess_per_gradient": ess / n_gradients if n_gradients else 0.0,
            "divergence_rate": divergence_rate,
            "total_divergences": total_div,
            "n_gradients": n_gradients,
            "rhat_pass": None,
            "ess_pass": ess >= MIN_ESS_QUALITY,
            "ess_tail_pass": None,
            "stats_pass": stats_pass,
            "z_score_max": stats_result.get("max_z"),
            "z_score_threshold": stats_result.get("threshold"),
            "usable": gates["usable"],
            "quality_pass": gates["quality_pass"],
            "is_inefficient": gates["is_inefficient"],
            "is_high_efficiency": gates["is_high_efficiency"],
            "sliced_w2": sliced_w2,
            "sliced_w2_transformed": sliced_w2_transformed,
            "convergence_trace": None,
            "reparam": "log" if target.family.endswith("_unconstrained") else None,
            "stats_pass_transformed": stats_result_t["pass"] if stats_result_t else None,
            "z_score_max_transformed": (stats_result_t.get("max_z")
                                        if stats_result_t else None),
            "log_z": log_z,
            "smc_particles": n_particles,
            "smc_stages": n_stages,
            "smc_resamples": int(res.info["n_resamples"]),
            "smc_move_steps": move_steps,
            "smc_base_scale": float(base_scale),
            "smc_target_rel_ess": float(target_rel_ess),
            "smc_tune_trajectory": bool(tune_trajectory),
            "smc_final_trajectory_length": (float(res.info["final_trajectory_length"])
                                            if tune_trajectory else None),
            "step_size": float(res.info["final_step_size"]),
            "mesh_devices": mesh.size if mesh is not None else None,
            "mass_matrix_learned": False,
        }
        status = ("[PASS]" if results["quality_pass"]
                  else "[USABLE]" if results["usable"] else "[FAIL]")
        print(f"{status} log_Z={log_z:.4f} ESS={ess:.0f} "
              f"div={divergence_rate:.1%} "
              f"W2={sliced_w2 if sliced_w2 is None else round(sliced_w2, 4)} "
              f"({total_time:.1f}s)")
        return results
    except Exception as e:
        if mesh is not None:
            raise
        import traceback
        traceback.print_exc()
        return {
            "sampler": "smc",
            "target": target.name,
            "schedule": None,
            "dim": target.dim,
            "num_steps": num_steps,
            "total_samples": 0,
            "ess_bulk_min": 0.0,
            "n_gradients": 0,
            "divergence_rate": None,
            "error": str(e),
            "total_time": _clock(device) - start_time,
            "usable": False,
            "quality_pass": False,
            "mass_matrix_learned": False,
        }


_FAILURE_FIELDS = [
    "num_steps", "total_samples", "n_gradients", "rhat_max", "rhat_mean", "ess_bulk_min",
    "ess_bulk_mean", "ess_tail_min", "ess_tail_mean", "ess_per_sample", "ess_per_gradient",
    "divergence_rate", "total_divergences", "accept_rate", "warmup_time", "sample_time",
    "total_time", "sliced_w2", "stats_pass", "z_score_max", "z_score_threshold",
    "convergence_trace", "rhat_pass", "ess_pass", "ess_tail_pass", "is_inefficient",
    "is_high_efficiency", "step_size", "gamma", "steepness", "avg_tree_depth",
    "mass_matrix_learned", "mass_matrix_min", "mass_matrix_max", "mass_matrix_mean",
    "tempering", "tempering_beta_min", "tempering_swap_interval", "swap_accept_rate",
    "replica_accept_rate", "tempering_betas", "tempering_ladder", "ladder_tune_time",
    "ladder_rounds", "ladder_initial_deviation", "ladder_final_deviation",
    "tempering_step_sizes", "reparam", "stats_pass_transformed", "z_score_max_transformed",
    "sliced_w2_transformed",
]


def run_trajectory_length_grid_search(
    sampler: str,
    target: TargetDistribution,
    target_name: str,
    generator: torch.Generator,
    n_chains: int,
    num_warmup: int,
    num_samples: int,
    schedule_type: str,
    num_steps_grid: List[int],
    learn_mass_matrix=True,
    track_convergence: bool = False,
    convergence_base: float = 1.5,
    mesh_devices="auto",
    warmup_cache_dir: Optional[str] = None,
    tempering: int = 0,
    tempering_beta_min: float = 0.05,
    tempering_swap_interval: int = 1,
    tempering_ladder: str = "geometric",
) -> Dict:
    """Run every L of the grid; pick the highest ESS per gradient among the
    quality_pass runs (else among the usable ones), or return the failure
    record with the least bad run's diagnostics when none is usable."""
    print(f"\n{'#' * 80}\nGRID SEARCH over L = {num_steps_grid}\n{'#' * 80}")
    grid_results = []
    for L in num_steps_grid:
        r = run_single_benchmark_with_L(
            sampler, target, target_name, split_generator(generator), n_chains, num_warmup,
            num_samples, schedule_type, L, learn_mass_matrix, track_convergence,
            convergence_base, mesh_devices=mesh_devices, warmup_cache_dir=warmup_cache_dir,
            tempering=tempering, tempering_beta_min=tempering_beta_min,
            tempering_swap_interval=tempering_swap_interval, tempering_ladder=tempering_ladder)
        if r.get("error") is None:
            n_grad = r.get("n_gradients", r["total_samples"] * L)
            r["n_gradients"] = n_grad
            r["ess_per_gradient"] = r["ess_bulk_min"] / n_grad if n_grad > 0 else 0
        else:
            r["n_gradients"] = 0
            r["ess_per_gradient"] = 0
        grid_results.append(r)

    usable = [r for r in grid_results if r.get("usable", False)]
    if not usable:
        print("\nGRID SEARCH FAILED: no L produced usable samples")

        def least_bad_score(r):
            if r.get("error"):
                return (float("inf"), 0)
            return (r.get("rhat_max", float("inf")), -r.get("ess_bulk_min", 0))

        least_bad = min(grid_results, key=least_bad_score)
        failure = {
            "sampler": sampler,
            "target": target.name,
            "schedule": schedule_type if sampler in ("grahmc", "rahmc") else None,
            "dim": target.dim,
            "n_chains": n_chains,
            "grid_search_failed": True,
            "usable": False,
            "quality_pass": False,
            "error": "No trajectory length produced usable samples",
            "num_samples": num_samples,
            "num_warmup": num_warmup,
        }
        for field in _FAILURE_FIELDS:
            failure[field] = least_bad.get(field)
        failure["ess_bulk_min"] = least_bad.get("ess_bulk_min", 0)
        failure["grid_search_info"] = {
            "tested_L_values": num_steps_grid,
            "selected_L": None,
            "has_usable": False,
            "least_bad_L": least_bad.get("num_steps"),
            "all_results": [dict(_grid_summary(r), error=r.get("error")) for r in grid_results],
        }
        return failure

    quality = [r for r in usable if r.get("quality_pass", False)]
    pool, tier = (quality, "quality_pass") if quality else (usable, "usable_only")
    best = max(pool, key=lambda r: r["ess_per_gradient"])
    selected_L = best["num_steps"]
    print(f"\nGRID SEARCH COMPLETE — best L={selected_L} "
          f"(ESS/grad={best['ess_per_gradient']:.6f}) [{tier}]")
    for r in grid_results:
        status = ("[ERROR]" if r.get("error") else "[PASS]" if r.get("quality_pass")
                  else "[USABLE]" if r.get("usable") else "[FAIL]")
        print(f"  L={r['num_steps']:3d}: ESS/grad={r.get('ess_per_gradient', 0):.6f} "
              f"ESS={r.get('ess_bulk_min', 0):7.1f} "
              f"R-hat={r.get('rhat_max', 0) or 0:.4f} {status}")
    best["grid_search_info"] = {
        "tested_L_values": num_steps_grid,
        "selected_L": selected_L,
        "selection_tier": tier,
        "has_usable": True,
        "all_results": [_grid_summary(r) for r in grid_results],
    }
    return best


# ============================================================================
# Incremental save / resume
# ============================================================================

def _round_floats(obj):
    """JSON-safe copy with every float rounded to 4 places (ints, bools,
    strings and None kept; numpy scalars, arrays and tensors converted)."""
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, float):
        return round(obj, 4)
    if isinstance(obj, (int, str, type(None))):
        return obj
    if isinstance(obj, dict):
        return {k: _round_floats(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(x) for x in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return round(float(obj), 4)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return _round_floats(_host(obj).tolist())
    return obj


def _config_key(row: Dict):
    """One row per (sampler, target, schedule, mass-matrix mode) in the
    results file: a re-run under other settings replaces its row."""
    return (row.get("sampler"), row.get("target"), row.get("schedule"),
            row.get("mass_matrix_learned"))


def _csv_cell(v):
    """A value as pandas' to_csv writes it: None and NaN empty."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return v


def _write_csv_row(path: Path, columns, row: Dict, mode: str, header: bool) -> None:
    with open(path, mode, newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(columns)
        w.writerow([_csv_cell(row.get(c)) for c in columns])


def save_result_incremental(result: Dict, output_dir: str, is_first: bool = False):
    """Append one result to benchmark_results.{csv,json}.

    The CSV's columns are pinned in .csv_columns.json at its first row, so
    appended rows stay aligned (a later row's missing fields empty, its
    extra ones dropped), as the JAX runner's pandas write does; it is an
    append-only mirror. The JSON, which analysis and resume read, replaces
    any earlier row with the same _config_key."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    csv_path = out / "benchmark_results.csv"
    json_path = out / "benchmark_results.json"
    col_order_path = out / ".csv_columns.json"

    rounded = _round_floats(result)
    csv_row = copy.deepcopy(rounded)
    for k in ("grid_search_info", "convergence_trace"):
        if csv_row.get(k) is not None:
            csv_row[k] = json.dumps(csv_row[k])

    if is_first or not csv_path.exists():
        columns = list(csv_row)
        _write_csv_row(csv_path, columns, csv_row, "w", header=True)
        with open(col_order_path, "w") as f:
            json.dump(columns, f)
    else:
        if col_order_path.exists():
            with open(col_order_path) as f:
                columns = json.load(f)
        else:
            columns = list(csv_row)
            with open(col_order_path, "w") as f:
                json.dump(columns, f)
        _write_csv_row(csv_path, columns, csv_row, "a", header=False)

    if is_first or not json_path.exists():
        all_results = [rounded]
    else:
        with open(json_path) as f:
            all_results = json.load(f)
        key = _config_key(rounded)
        all_results = [r for r in all_results if _config_key(r) != key]
        all_results.append(rounded)
    with open(json_path, "w") as f:
        json.dump(all_results, f, indent=2)


def _resume_signature(sampler, target_name, schedule, learn_mass, nuts_backend=None,
                      nuts_steps_per_sample=None, trajectory_tuner=None, nuts_proposal=None,
                      tempering=None, smc_particles=None, smc_tune_trajectory=None):
    """Completed-set key for resume by signature: NUTS rows add the
    resolved backend, the persistent machine's snapshot interval and
    proposal scheme; HMC/GRAHMC rows the trajectory tuner and the ladder
    size; SMC rows the population and its tuner. Rows saved before a field
    existed resolve to None and re-run."""
    sig = (sampler, target_name, schedule, learn_mass)
    if sampler == "nuts":
        sig += (nuts_backend,
                nuts_steps_per_sample if nuts_backend == "persistent" else None,
                (nuts_proposal or "endpoint") if nuts_backend == "persistent" else None)
    elif sampler in TRAJECTORY_SAMPLERS:
        sig += ("chees" if trajectory_tuner == "chees" else None,
                int(tempering) if tempering and int(tempering) > 1 else None)
    elif sampler == "smc":
        sig += (int(smc_particles) if smc_particles else None,
                "chees" if smc_tune_trajectory else None)
    return sig


def run_all_benchmarks(
    samplers: List[str],
    targets: List[str],
    grahmc_schedules: List[str],
    dim: int,
    n_chains: int,
    num_warmup: int,
    num_samples: int,
    seed: int,
    output_dir: str,
    num_steps_grid: Optional[List[int]] = None,
    mass_matrix_modes: Optional[List] = None,
    track_convergence: bool = False,
    convergence_base: float = 1.5,
    mesh_devices="auto",
    nuts_backend: str = "auto",
    warmup_cache: bool = True,
    nuts_steps_per_sample: int = 64,
    trajectory_tuner: str = "grid",
    nuts_proposal: str = "endpoint",
    gamma_tuner: str = "grid",
    tempering: int = 0,
    tempering_beta_min: float = 0.05,
    tempering_swap_interval: int = 1,
    tempering_ladder: str = "geometric",
    smc_particles: int = 4096,
    smc_move_steps: int = 3,
    smc_num_steps: int = 8,
    smc_step_size: float = 0.4,
    smc_base_scale: float = 2.0,
    smc_rel_ess: float = 0.5,
    smc_max_stages: int = 200,
    smc_tune_trajectory: bool = False,
    reparam: str = "off",
    device="cuda",
) -> List[Dict]:
    """Every target x sampler x mass mode (x schedule for GRAHMC) on
    `device`, with resume by signature and incremental saving; returns the
    result rows (the JAX runner returns them as a DataFrame).

    warmup_cache keeps Phase 1's products under
    `<output_dir>/.warmup_cache_seed<seed>/`. trajectory_tuner 'chees'
    falls back to the L grid where the tuner reports a runaway. reparam
    'auto' samples constrained-support targets in their log-transformed
    coordinates (rows under '<target>_unconstrained' names)."""
    if reparam not in ("off", "auto"):
        raise ValueError(f"reparam must be 'off' or 'auto', got {reparam!r}")
    if tempering and tempering > 1 and trajectory_tuner == "chees":
        raise ValueError(
            "--tempering composes with the fixed-L pipeline, not the ChEES "
            "tuner (the criterion would adapt to the cold replica only); "
            "drop one of the two flags")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    _resolve_mesh(n_chains, mesh_devices, device)
    generator = make_generator(seed, device)
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    if num_steps_grid is None:
        num_steps_grid = DEFAULT_L_GRID
    if mass_matrix_modes is None:
        mass_matrix_modes = [True]
    warmup_cache_dir = (str(Path(output_dir) / f".warmup_cache_seed{seed}")
                        if warmup_cache else None)

    json_path = Path(output_dir) / "benchmark_results.json"
    if json_path.exists():
        with open(json_path) as f:
            all_results = json.load(f)
        completed = {
            _resume_signature(r.get("sampler"), r.get("target"), r.get("schedule"),
                              r.get("mass_matrix_learned"), r.get("nuts_backend"),
                              r.get("nuts_steps_per_sample"), r.get("trajectory_tuner"),
                              r.get("nuts_proposal"), r.get("tempering"),
                              r.get("smc_particles"), r.get("smc_tune_trajectory"))
            for r in all_results}
        print(f"RESUMING: {len(all_results)} existing results, skipping "
              f"{len(completed)} completed configurations")
        is_first = False
    else:
        all_results, completed, is_first = [], set(), True

    def keep(result):
        nonlocal all_results, is_first
        ck = _config_key(result)
        all_results = [r for r in all_results if _config_key(r) != ck]
        all_results.append(result)
        if is_writer():
            save_result_incremental(result, output_dir, is_first=is_first)
        is_first = False

    for target_name in targets:
        print(f"\n{'#' * 80}\n# TARGET: {target_name} (dim={dim})\n{'#' * 80}")
        target = get_target(target_name, dim=dim)
        if reparam == "auto" and target.support != "real":
            from mcmc_tpu_torch.targets import unconstrain_target
            target = unconstrain_target(target, registry_name=target_name)
            target_name = f"{target_name}_unconstrained"
            print(f"  [reparam] sampling {target.name} (log-transformed, support now R^D)")

        for sampler in samplers:
            if sampler == "smc":
                sig = _resume_signature("smc", target.name, None, False,
                                        smc_particles=smc_particles,
                                        smc_tune_trajectory=smc_tune_trajectory)
                if sig in completed:
                    print(f"  [SKIP] {sig} (already completed)")
                    continue
                keep(run_single_smc_benchmark(
                    target, target_name, split_generator(generator), n_particles=smc_particles,
                    move_steps=smc_move_steps, num_steps=smc_num_steps,
                    step_size=smc_step_size, base_scale=smc_base_scale,
                    target_rel_ess=smc_rel_ess, max_stages=smc_max_stages,
                    mesh_devices=mesh_devices, tune_trajectory=smc_tune_trajectory))
                continue
            for learn_mass in mass_matrix_modes:
                schedules = grahmc_schedules if sampler in ("grahmc", "rahmc") else [None]
                for schedule in schedules:
                    use_chees_tuner = (trajectory_tuner == "chees"
                                       and sampler in TRAJECTORY_SAMPLERS)
                    if sampler == "nuts":
                        sig = _resume_signature(
                            sampler, target.name, schedule, learn_mass,
                            _resolve_nuts_backend(nuts_backend, target, device),
                            nuts_steps_per_sample, nuts_proposal=nuts_proposal)
                    else:
                        sig = _resume_signature(
                            sampler, target.name, schedule, learn_mass,
                            trajectory_tuner="chees" if use_chees_tuner else None,
                            tempering=tempering)
                    if sig in completed:
                        print(f"  [SKIP] {sig} (already completed)")
                        continue
                    sub = split_generator(generator)
                    if sampler in TRAJECTORY_SAMPLERS:
                        result = None
                        chees_fell_back = False
                        if use_chees_tuner:
                            result = run_single_benchmark_with_L(
                                sampler, target, target_name, split_generator(generator),
                                n_chains, num_warmup, num_samples, schedule or "constant", 0,
                                learn_mass, track_convergence, convergence_base,
                                mesh_devices=mesh_devices, warmup_cache_dir=warmup_cache_dir,
                                trajectory_tuner="chees", gamma_tuner=gamma_tuner)
                            if result.get("chees_cap_hit"):
                                print("  [chees] trajectory cap hit "
                                      "(criterion runaway on this target) "
                                      "— falling back to the L grid search")
                                result = None
                                chees_fell_back = True
                        if result is None:
                            result = run_trajectory_length_grid_search(
                                sampler, target, target_name, sub, n_chains, num_warmup,
                                num_samples, schedule or "constant", num_steps_grid,
                                learn_mass, track_convergence, convergence_base,
                                mesh_devices=mesh_devices, warmup_cache_dir=warmup_cache_dir,
                                tempering=tempering, tempering_beta_min=tempering_beta_min,
                                tempering_swap_interval=tempering_swap_interval,
                                tempering_ladder=tempering_ladder)
                            if chees_fell_back:
                                result["trajectory_tuner"] = "chees"
                                result["chees_fell_back"] = True
                    else:
                        result = run_single_benchmark_with_L(
                            sampler, target, target_name, sub, n_chains, num_warmup,
                            num_samples, schedule or "constant", 20, learn_mass,
                            mesh_devices=mesh_devices, nuts_backend=nuts_backend,
                            warmup_cache_dir=warmup_cache_dir,
                            nuts_steps_per_sample=nuts_steps_per_sample,
                            nuts_proposal=nuts_proposal)
                    keep(result)

    print(f"\n[OK] results saved incrementally to {output_dir}/"
          f"benchmark_results.{{csv,json}} ({len(all_results)} experiments)")
    return all_results


def _name(row) -> str:
    sched = row.get("schedule")
    return row["sampler"] + (f"-{sched}" if isinstance(sched, str) else "")


def print_summary(rows: List[Dict]):
    """Pass/usable counts, failure analysis and the efficiency ranking."""
    n = len(rows)
    if n == 0:
        print("No results.")
        return
    print(f"\n{'=' * 80}\nBENCHMARK SUMMARY\n{'=' * 80}")
    passed = sum(bool(r.get("quality_pass")) for r in rows)
    usable = sum(bool(r.get("usable")) for r in rows)
    print(f"Total experiments: {n}")
    print(f"High quality: {passed}/{n} ({100 * passed / n:.1f}%)")
    print(f"Usable: {usable}/{n} ({100 * usable / n:.1f}%)")
    print(f"Failed: {n - usable}/{n}")
    for key, title, width in (("sampler", "By sampler", 10), ("target", "By target", 30)):
        print(f"\n{title}:")
        for value in dict.fromkeys(r.get(key) for r in rows):
            sub = [r for r in rows if r.get(key) == value]
            print(f"  {value:{width}s}: pass={sum(bool(r.get('quality_pass')) for r in sub)}/"
                  f"{len(sub)}, usable={sum(bool(r.get('usable')) for r in sub)}/{len(sub)}")
    for row in rows:
        if row.get("grid_search_failed"):
            print(f"  GRID FAILURE: {_name(row)} on {row['target']} "
                  f"(best L tried: {row.get('num_steps')})")
    top = sorted((r for r in rows if r.get("usable")),
                 key=lambda r: r.get("ess_per_gradient") or 0, reverse=True)[:10]
    if top:
        print("\nTop 10 by ESS/gradient (usable only):")
        for row in top:
            rhat = row.get("rhat_max")
            rhat_s = f"{rhat:.4f}" if rhat is not None and np.isfinite(rhat) else "n/a"
            print(f"  {_name(row):<25s} {row['target']:<25s} "
                  f"{row['ess_per_gradient']:.6f} "
                  f"(ESS={row.get('ess_bulk_min', 0):.0f}, R-hat={rhat_s})")
