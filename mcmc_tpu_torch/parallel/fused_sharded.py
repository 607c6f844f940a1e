"""Chain-sharded sampling runs over a chain mesh (port of
``mcmc_tpu/parallel/fused_sharded.py``).

Each rank runs the port's own single-device run on its block of the chains
(``parallel.shard_chains``) with the run generator folded by its rank
(``parallel.rank_generator``, the JAX package's ``fold_in(key,
axis_index)``), so on the card every transition goes through the same CUDA
kernels as without a mesh: kernel 1 for GRAHMC (kernel 2 at the
single-device run's multistep sizes), 1b for tempering, 4 / 4a /
4b for persistent NUTS, 1c for SMC's moves. The sampling loops communicate
nothing; the collectives are the final totals, tempering's swap and replica
means, and SMC's weight reductions (inside ``samplers.smc``).

Every run returns the JAX package's contract on every rank: the history
prefixes, per-chain arrays and final state gathered in rank order (a rank's
chains are a contiguous block, as ``P('chains')`` lays them out), the
global scalars replicated. Rank r's stream depends only on the seed and r,
so rank 0 of an n-rank run is bit for bit a 1-rank run over rank 0's chains
(``parallel.solo_mesh(device, fold_index=r)`` reproduces rank r's).
"""

from typing import Callable, Optional, Sequence

import torch

from mcmc_tpu_torch.parallel import (ChainMesh, all_gather, pmean, psum, rank_generator,
                                     shard_chains)
from mcmc_tpu_torch.samplers.base import ChainState, RunResult

Tensor = torch.Tensor


def gather_history(x: Tensor, mesh: ChainMesh) -> Tensor:
    """Gather a (T, c, ...) history along its chain axis 1."""
    return all_gather(x.transpose(0, 1).contiguous(), mesh).transpose(0, 1)


def gather_result(res: RunResult, mesh: ChainMesh, num_samples: int,
                  chain_info: Sequence[str] = (), sum_info: Sequence[str] = (),
                  mean_info: Sequence[str] = ()) -> RunResult:
    """A rank's RunResult made global (the JAX package's `_assemble_result`):
    histories gathered along the chain axis, accept_rate, final_state and
    the info's divergence_count, final_positions and `chain_info` keys
    gathered along the leading axis, total_divergences and the `sum_info`
    keys summed, the `mean_info` keys averaged over the ranks,
    divergence_rate recomputed from the global total, n_devices the mesh's
    size. Other info keys are the same on every rank and stay."""
    n_chains = res.accept_rate.shape[0] * mesh.size
    info = dict(res.info)
    for key in ("divergence_count", "final_positions", *chain_info):
        if key in info:
            info[key] = all_gather(info[key], mesh)
    total = psum(res.info["total_divergences"], mesh)
    info["total_divergences"] = total
    info["divergence_rate"] = total.to(torch.float32) / max(num_samples * n_chains, 1)
    for key in sum_info:
        info[key] = psum(info[key], mesh)
    for key in mean_info:
        info[key] = pmean(info[key], mesh)
    info["n_devices"] = mesh.size
    final = ChainState(*(all_gather(f, mesh) for f in res.final_state))
    return RunResult(gather_history(res.samples, mesh), gather_history(res.log_probs, mesh),
                     all_gather(res.accept_rate, mesh), final, info)


def _local_positions(init_position: Tensor, mesh: ChainMesh) -> Tensor:
    """This rank's chains in float32, the kernels' dtype (the JAX package
    casts the same)."""
    return shard_chains(torch.as_tensor(init_position).to(torch.float32), mesh)


def grahmc_run_sharded(
    generator: torch.Generator,
    target,
    init_position: Tensor,
    mesh: ChainMesh,
    step_size,
    num_steps: int,
    gamma,
    steepness,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Tensor] = None,
    friction_schedule: Optional[Callable] = None,
    collect_chains_per_device: int = 8,
) -> RunResult:
    """Fused GRAHMC with the chains sharded over `mesh`: each rank runs
    ``grahmc_run(backend="fused")`` on its chains, so a rank takes the
    kernel its single-device run takes for as many chains: kernel 1 (1a
    for a dense metric) once a transition, or kernel 2 (2a) over T
    transitions at most MULTISTEP_MAX_CHAINS chains a rank. (The JAX
    package's sharded run steps kernel 1 at every size; a mesh here changes
    no rank's kernel.) init_position: the global (n_chains, dim), n_chains
    divisible by the mesh's size. Collects each rank's first
    `collect_chains_per_device` chains, gathered in rank order.
    friction_schedule defaults to the constant schedule; info carries the
    global divergence total."""
    from mcmc_tpu_torch.samplers.grahmc import grahmc_run
    local = _local_positions(init_position, mesh)
    if inv_mass_matrix is not None:
        inv_mass_matrix = inv_mass_matrix.to(device=mesh.device, dtype=torch.float32)
    res = grahmc_run(
        rank_generator(generator, mesh), target.log_prob_fn, local, step_size, num_steps,
        gamma, steepness, num_samples, burn_in=burn_in, inv_mass_matrix=inv_mass_matrix,
        friction_schedule=friction_schedule, value_and_grad_fn=target.value_and_grad_fn,
        collect_chains=min(collect_chains_per_device, local.shape[0]), backend="fused")
    return gather_result(res, mesh, num_samples)


def tempered_run_sharded(
    generator: torch.Generator,
    target,
    init_position: Tensor,
    mesh: ChainMesh,
    step_size,
    num_steps: int,
    num_samples: int,
    n_temps: int = 6,
    beta_min: float = 0.05,
    swap_interval: int = 1,
    inv_mass_matrix: Optional[Tensor] = None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    backend: str = "auto",
    replica_position: Optional[Tensor] = None,
    betas=None,
) -> RunResult:
    """Parallel tempering with the chains sharded over `mesh`: each rank
    runs the whole K-rung ladder on its chains (kernel 1b on the card), so
    every swap stays on the rank. The collectives are the global divergence
    total, the swap and replica accept means and the swap attempt totals.

    replica_position: a previous call's info["replica_final_positions"]
    ((K n_chains, D): device-major blocks of each rank's replica-major
    rows) to continue the ladder; this function's own output round-trips.
    betas: an explicit descending (K,) ladder, else geometric."""
    from mcmc_tpu_torch.samplers.tempered import (_validate_betas, geometric_ladder,
                                                  tempered_run)
    if betas is None:
        betas = geometric_ladder(n_temps, beta_min, device=mesh.device)
    else:
        _validate_betas(betas)
    betas = torch.as_tensor(betas, dtype=torch.float32).to(mesh.device)
    local = _local_positions(init_position, mesh)
    local_replica = None
    if replica_position is not None:
        local_replica = _local_positions(replica_position, mesh)
    if inv_mass_matrix is not None:
        inv_mass_matrix = inv_mass_matrix.to(device=mesh.device, dtype=torch.float32)
    res = tempered_run(
        rank_generator(generator, mesh), target.log_prob_fn, local, step_size,
        num_steps=num_steps, num_samples=num_samples, betas=betas,
        swap_interval=swap_interval, burn_in=0, inv_mass_matrix=inv_mass_matrix,
        gamma=gamma, steepness=steepness, friction_schedule=friction_schedule,
        value_and_grad_fn=target.value_and_grad_fn, backend=backend,
        init_replica_position=local_replica)
    # equal chains a rank: the global mean of a rate is the ranks' mean;
    # the attempt totals add up over the mesh
    return gather_result(res, mesh, num_samples, chain_info=("replica_final_positions",),
                         sum_info=("swap_attempts",),
                         mean_info=("swap_accept_rate", "replica_accept_rate"))


def nuts_persistent_run_sharded(
    generator: torch.Generator,
    target,
    init_position: Tensor,
    mesh: ChainMesh,
    step_size,
    num_samples: int,
    steps_per_sample: int = 64,
    burn_in_steps: int = 0,
    inv_mass_matrix: Optional[Tensor] = None,
    max_tree_depth: int = 10,
    delta_max: float = 1000.0,
    collect_chains_per_device: int = 8,
    steps_per_iter: Optional[int] = None,
    proposal_scheme: str = "endpoint",
    backend: str = "fused",
) -> RunResult:
    """Persistent NUTS through the fused window (kernel 4; 4a for the
    multinomial scheme, 4b for a dense metric) with the chains sharded over
    `mesh`: each rank runs its own machine on its chains (backend "eager":
    the eager machine, for a target kernel 4 does not take). The collectives
    are the global divergence, transition, leapfrog and slot totals. The
    counters are int64 sums of the global totals: the JAX package's uint32
    slot count, chosen from one shard's total, wraps under its psum past
    2^32 slots; these do not."""
    from mcmc_tpu_torch.samplers.nuts_persistent import nuts_run_persistent
    res = nuts_run_persistent(
        rank_generator(generator, mesh), target.log_prob_fn,
        _local_positions(init_position, mesh), step_size, num_samples,
        steps_per_sample=steps_per_sample, burn_in_steps=burn_in_steps,
        inv_mass_matrix=(None if inv_mass_matrix is None else
                         inv_mass_matrix.to(device=mesh.device, dtype=torch.float32)),
        max_tree_depth=max_tree_depth, delta_max=delta_max,
        value_and_grad_fn=target.value_and_grad_fn,
        collect_chains=collect_chains_per_device, backend=backend,
        steps_per_iter=steps_per_iter, proposal_scheme=proposal_scheme)
    out = gather_result(res, mesh, num_samples,
                        chain_info=("transitions", "mean_accept_probs", "mean_tree_depth",
                                    "n_leapfrogs_per_chain"),
                        sum_info=("n_leapfrogs", "n_leapfrog_slots"))
    total_trans = torch.sum(out.info["transitions"], dtype=torch.int64)
    out.info["divergence_rate"] = (out.info["total_divergences"].to(torch.float32)
                                   / torch.clamp(total_trans, min=1).to(torch.float32))
    return out


def smc_run_sharded(
    generator: torch.Generator,
    log_prob_fn,
    mesh: ChainMesh,
    n_particles: int,
    dim: int,
    step_size,
    num_steps: int,
    betas=None,
    target_rel_ess: float = 0.5,
    resample_threshold: float = 0.5,
    move_steps: int = 3,
    max_stages: int = 200,
    base_mean=None,
    base_scale=1.0,
    inv_mass_matrix: Optional[Tensor] = None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    value_and_grad_fn: Optional[Callable] = None,
    adapt_step_size: bool = True,
    final_resample: bool = False,
    tune_trajectory: bool = False,
    max_leapfrogs: Optional[int] = None,
    move_backend: str = "auto",
    dtype: torch.dtype = torch.float32,
):
    """Annealed SMC (samplers.smc) with the particles sharded over `mesh`.

    n_particles is the global population (divisible by the mesh's size,
    at least 2 a rank). The weight reductions span the mesh, so the
    adaptive schedule, the resampling decisions and the step sizes are the
    same on every rank; resampling stays on each rank, its particles
    carrying the rank's total weight forward; the moves run kernel 1c on
    the card. The tuned moves' jitter comes from the unfolded `generator`,
    so every rank integrates the same lengths. Returns the SMCResult with
    particles, log_weights and final_state gathered in rank order, log Z
    and the info the same on every rank."""
    from mcmc_tpu_torch.samplers.smc import SMCResult, smc_run
    if n_particles % mesh.size:
        raise ValueError(f"n_particles {n_particles} not divisible by mesh size {mesh.size}")
    local_p = n_particles // mesh.size
    if local_p < 2:
        raise ValueError("need >= 2 particles per rank")
    res = smc_run(
        rank_generator(generator, mesh), log_prob_fn, local_p, dim, step_size, num_steps,
        betas=betas, target_rel_ess=target_rel_ess, resample_threshold=resample_threshold,
        move_steps=move_steps, max_stages=max_stages, base_mean=base_mean,
        base_scale=base_scale, inv_mass_matrix=inv_mass_matrix, gamma=gamma,
        steepness=steepness, friction_schedule=friction_schedule,
        value_and_grad_fn=value_and_grad_fn, adapt_step_size=adapt_step_size,
        final_resample=final_resample, tune_trajectory=tune_trajectory,
        max_leapfrogs=max_leapfrogs, move_backend=move_backend, dtype=dtype, mesh=mesh,
        jitter_generator=generator)
    final = ChainState(*(all_gather(f, mesh) for f in res.final_state))
    return SMCResult(all_gather(res.particles, mesh), all_gather(res.log_weights, mesh),
                     res.log_Z, final, res.info)
