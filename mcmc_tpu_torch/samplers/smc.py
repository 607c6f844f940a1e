"""Annealed Sequential Monte Carlo with log-Z estimation (port of
``mcmc_tpu/samplers/smc.py``).

A population of P particles starts as exact draws from the base
p0 = N(m, S^2 I) and is carried to the target pi through the geometric
bridge

    pi_b(x)  proportional to  p0(x)^(1-b) * exp(logp(x))^b,   b: 0 -> 1,

alternating importance reweighting (b -> b'), systematic resampling when
the weights degenerate, and HMC/GRAHMC moves targeting pi_b'. The running
product of normalized-weight sums estimates Z = integral exp(logp), so a
normalized target gives log Z = 0.

The population is one (P, D) batch on the device. The stage loop is a host
loop: each stage makes ONE host read, the resampling decision and whether
the schedule has reached b = 1, read together (the JAX package runs a
lax.while_loop with lax.cond). The next b comes from a fixed schedule or
the adaptive conditional-ESS bisection (30 steps, on the device). Moves run
through `grahmc_step` on the mixture value-and-grad (move_backend "eager")
or through kernel 1c, one launch per move, the bridge evaluated in the
kernel (move_backend "fused"); with tune_trajectory, through the jittered
ChEES-tuned `mh_transition_dynamic`, eager, one host read of each move's
leapfrog count. Log-weights and log Z are in the energy
dtype of the particles' dtype (float64 particles on the CPU tests, float32
on the card, as on the TPU).
"""

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import ChainState, make_value_and_grad
from mcmc_tpu_torch.samplers.grahmc import grahmc_step

Tensor = torch.Tensor

_BISECT_ITERS = 30          # ~1e-9 resolution on a unit interval
_STEP_RM_GAIN = 1.0         # Robbins-Monro gain of the per-move step tuning
_TARGET_MOVE_ACCEPT = 0.65  # HMC-family optimum


class SMCResult(NamedTuple):
    """Annealed-SMC output.

    particles:   (P, D) final particle positions (weighted unless the run
                 finished with a resample; see info['ess'])
    log_weights: (P,) normalized log-weights of `particles` (logsumexp 0)
    log_Z:       0-d estimate of log integral exp(logp)
    final_state: ChainState of the final particles (the target's log-probs)
    info:        betas / rel_ess / accept / resampled / step_size /
                 trajectory_length per stage (max_stages buffers) with
                 n_stages, n_resamples, n_divergences, ess, final_step_size,
                 n_leapfrogs, final_trajectory_length
    """
    particles: Tensor
    log_weights: Tensor
    log_Z: Tensor
    final_state: ChainState
    info: dict


def gaussian_base(dim: int, mean=None, scale=1.0, device="cuda"):
    """Normalized spherical-Gaussian base N(mean, scale^2 I), float32, on the
    card unless `device` names another. Returns (sampler(generator, n),
    log_prob, value_and_grad) with the batched (P, D) convention."""
    scale = torch.as_tensor(scale, dtype=torch.float32).cpu().broadcast_to((dim,))
    if bool((scale <= 0.0).any()):
        raise ValueError("base scale must be strictly positive")
    mean = (torch.zeros(dim, dtype=torch.float32) if mean is None else
            torch.as_tensor(mean, dtype=torch.float32).cpu().broadcast_to((dim,)))
    log_norm = -torch.sum(torch.log(scale)) - 0.5 * dim * math.log(2.0 * math.pi)
    mean, scale, log_norm = (t.contiguous().to(device) for t in (mean, scale, log_norm))

    def sampler(generator, n, dtype=torch.float32):
        z = torch.randn((n, dim), generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (mean + scale * z).to(dtype)

    def log_prob(x):
        z = (x - mean.to(x.dtype)) / scale.to(x.dtype)
        return -0.5 * torch.sum(z * z, dim=-1) + log_norm.to(x.dtype)

    def value_and_grad(x):
        z = (x - mean.to(x.dtype)) / scale.to(x.dtype)
        lp = -0.5 * torch.sum(z * z, dim=-1) + log_norm.to(x.dtype)
        return lp, -z / scale.to(x.dtype)

    return sampler, log_prob, value_and_grad


def prefix_sum(x: Tensor) -> Tensor:
    """Inclusive prefix sum of a 1-D tensor, summed in one fixed order on
    every device: ceil(log2 n) rounds of x[k:] + x[:-k] (Hillis and
    Steele). torch.cumsum of a floating CUDA tensor sums in an order that
    can change between calls, and systematic resampling compares every
    point with the CDF, so one seed would not give the same indices."""
    k = 1
    while k < x.shape[0]:
        x = torch.cat([x[:k], x[k:] + x[:-k]])
        k *= 2
    return x


def systematic_resample(generator: Optional[torch.Generator], log_weights: Tensor,
                        u: Optional[Tensor] = None) -> Tensor:
    """Systematic resampling: indices (P,) such that particle i is copied
    floor(P w_i) or ceil(P w_i) times. One prefix sum and one searchsorted.

    log_weights need not be normalized. The single uniform is `u` when
    given (a test hands in the JAX package's), else drawn from
    `generator`."""
    n = log_weights.shape[0]
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    cdf = prefix_sum(torch.exp(lw))
    # guard the tail against rounding: cdf[-1] must dominate every point
    cdf[-1] = 1.0 + 1e-6
    if u is None:
        u = torch.rand((), generator=generator, device=generator.device, dtype=cdf.dtype)
    points = u.to(device=cdf.device, dtype=cdf.dtype) / n + torch.arange(
        n, dtype=cdf.dtype, device=cdf.device) / n
    return torch.clamp(torch.searchsorted(cdf, points), 0, n - 1)


def _lse(x: Tensor, mesh=None) -> Tensor:
    """logsumexp over the particle population. With a chain mesh, x is this
    rank's shard and the sum spans every rank: one pmax for the shift, one
    psum for the sum (the JAX package's `_lse(axis_name=...)`)."""
    if mesh is None:
        return torch.logsumexp(x, dim=0)
    from mcmc_tpu_torch.parallel import pmax, psum
    m = pmax(torch.max(x), mesh)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(psum(torch.sum(torch.exp(x - m_safe)), mesh)) + m_safe


def _rel_ess(log_weights: Tensor, total: Optional[int] = None, mesh=None) -> Tensor:
    """Relative effective sample size of NORMALIZED log-weights:
    1 / (P sum w_i^2), in (0, 1]. `total` is the global particle count
    when log_weights is a rank's shard of a mesh."""
    n = total if total is not None else log_weights.shape[0]
    return torch.exp(-_lse(2.0 * log_weights, mesh)) / n


def _validate_beta_schedule(betas) -> None:
    """A bad explicit schedule must error loudly: betas[-1] != 1 estimates
    the WRONG constant (Z of pi^b_last), non-ascending steps make the
    incremental weights estimate nothing meaningful."""
    if isinstance(betas, torch.Tensor):
        betas = betas.detach().cpu()
    b = np.asarray(betas, np.float64)
    if b.ndim != 1 or b.size < 1:
        raise ValueError(f"betas must be a 1-D schedule, got shape {b.shape}")
    if not np.all(np.isfinite(b)) or b[0] <= 0.0:
        raise ValueError(f"betas must be finite with betas[0] > 0: {b}")
    if abs(b[-1] - 1.0) > 1e-6:
        raise ValueError("betas[-1] must be 1.0 (the target; anything else "
                         f"estimates Z of pi^beta instead), got {b[-1]}")
    if b.size > 1 and np.any(np.diff(b) <= 0.0):
        raise ValueError(f"betas must be strictly ascending: {b}")


def resolve_move_backend(move_backend: str, value_and_grad_fn, tune_trajectory: bool,
                         inv_mass_matrix, device) -> str:
    """"auto" -> "fused" only when every fusion precondition holds: CUDA
    particles, fixed-length moves, a target kernel 1c dispatches on, and a
    diagonal (or absent) metric (kernel 1c takes a dense one too, but SMC
    never learns one, so "auto" keeps the JAX package's rule). An explicit
    "fused" asserts the preconditions loudly instead (on the CPU it runs
    the kernel's plain version, which is how the CPU tests exercise it)."""
    if move_backend not in ("auto", "eager", "fused"):
        raise ValueError(f"unknown move_backend {move_backend!r}")
    info = getattr(value_and_grad_fn, "kernel_info", None)
    if move_backend == "auto":
        from mcmc_tpu_torch.ops.padded_targets import fusable
        dense = inv_mass_matrix is not None and inv_mass_matrix.ndim == 2
        return ("fused" if fusable("grahmc", value_and_grad_fn, device)
                and not tune_trajectory and not dense else "eager")
    if move_backend == "fused":
        if tune_trajectory:
            raise ValueError("move_backend='fused' fuses the fixed-length move path; "
                             "tune_trajectory uses the dynamic-length transition")
        if info is None:
            raise TypeError("move_backend='fused' needs an analytic value_and_grad_fn "
                            "with kernel_info (a mcmc_tpu_torch.targets factory)")
    return move_backend


def smc_run(
    generator: torch.Generator,
    log_prob_fn,
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
    mesh=None,
    jitter_generator: Optional[torch.Generator] = None,
) -> SMCResult:
    """Annealed SMC from N(base_mean, base_scale^2 I) to exp(log_prob_fn).

    betas: explicit ascending schedule ending at 1.0 (the stages' b after
    each reweight), or None for the adaptive conditional-ESS schedule (the
    next b chosen so the reweight's relative conditional ESS equals
    target_rel_ess, at most max_stages stages).
    move_steps: MCMC transitions per stage, each of num_steps leapfrogs
    (plain HMC when friction_schedule is None).
    resample_threshold: systematic resampling when the relative ESS drops
    below it.
    adapt_step_size: per-transition Robbins-Monro step tuning toward 0.65
    acceptance (the adaptive-SMC regime; pass a fixed `betas` schedule with
    adapt_step_size=False for the exactly unbiased estimator).
    final_resample: return an unweighted (uniform-weight) population.
    tune_trajectory: adapt the move's trajectory length alongside the step
    size with the ChEES criterion on the particle population (Millard et
    al. 2025): each move draws a jitter h ~ U(0, 1) from `generator`, runs
    n = ceil(h T / eps) leapfrogs (read to the host, at most max_leapfrogs)
    through mh_transition_dynamic, and takes one Adam step on log T from
    chees_log_t_grad at the unflipped endpoint momentum. T starts at T0 =
    max(step_size num_steps, 1e-6); info["trajectory_length"] holds each
    stage's T before its moves, "final_trajectory_length" the last one, and
    "n_leapfrogs" the realized count per particle. Without it both hold T0.
    max_leapfrogs: the cap on a tuned move's count (default max(4
    num_steps, 16)); unused without tune_trajectory.
    move_backend: "eager" (grahmc_step on the mixture value-and-grad, any
    log-prob and metric), "fused" (kernel 1c, one launch per move: a tagged
    target, a named or no friction schedule) or "auto" (resolve_move_backend).
    dtype: the particles' dtype; log-weights and log Z take its energy
    dtype.

    `generator` lives on the device the particles should live on (the card
    for a CUDA generator): it draws the initial population, the resampling
    uniforms and the eager moves' momenta; the fused moves draw their
    Philox key from it once per run.

    mesh, jitter_generator: the rank's part of
    `parallel.fused_sharded.smc_run_sharded`, which passes them. Then
    n_particles is the rank's shard of n_particles x mesh.size;
    every weight reduction (the reweight's normalization, the log-Z
    increment, the relative ESS, the conditional-ESS bisection), each
    move's accept mean and the divergence count span the mesh, so every
    rank takes the same schedule, resampling decisions and step sizes;
    resampling stays on the rank, each rank's particles carrying its total
    weight forward. The tuned moves' jitter comes from jitter_generator
    (the unfolded run generator, the same on every rank).
    """
    if betas is not None:
        _validate_beta_schedule(betas)
        max_stages = max(max_stages, len(betas))
    if n_particles < 2:
        raise ValueError("n_particles must be >= 2")
    if not 0.0 < target_rel_ess < 1.0:
        raise ValueError("target_rel_ess must be in (0, 1)")
    if base_scale is not None and bool(np.any(np.asarray(
            base_scale.detach().cpu() if isinstance(base_scale, Tensor) else base_scale)
            <= 0.0)):
        raise ValueError("base_scale must be strictly positive")
    from mcmc_tpu_torch.samplers.trajectory import mh_transition_dynamic
    from mcmc_tpu_torch.tuning.chees import (chees_init, chees_log_t_grad, chees_update,
                                             num_leapfrog_steps)
    if max_leapfrogs is None:
        max_leapfrogs = max(4 * num_steps, 16)
    dev = generator.device
    total = n_particles * (1 if mesh is None else mesh.size)
    if jitter_generator is None:
        jitter_generator = generator
    move_backend = resolve_move_backend(move_backend, value_and_grad_fn, tune_trajectory,
                                        inv_mass_matrix, dev)
    n, d = n_particles, dim
    e_dtype = precision.energy_dtype(dtype)
    base_sampler, _base_lp, base_vag = gaussian_base(d, base_mean, base_scale, device=dev)
    target_vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
    inv_mass = (torch.ones(d, dtype=dtype, device=dev) if inv_mass_matrix is None
                else inv_mass_matrix.to(device=dev, dtype=dtype))

    if move_backend == "fused":
        from mcmc_tpu_torch.ops.fused_trajectory import (
            PhiloxStream, bridge_base, make_fused_grahmc_step, prepare_dense_metric)
        fused_move = make_fused_grahmc_step(value_and_grad_fn, num_steps, friction_schedule)
        base = bridge_base(base_mean, base_scale, d, dev)
        stream = PhiloxStream.from_generator(generator, dev)
        if inv_mass.ndim == 2:
            inv_mass = prepare_dense_metric(inv_mass)       # factored once per run

    q = base_sampler(generator, n, dtype)
    lp_t, g_t = target_vag(q)
    lp_t, g_t = lp_t.to(e_dtype), g_t.to(dtype)
    logw = torch.full((n,), -math.log(total), dtype=e_dtype, device=dev)
    log_z = torch.zeros((), dtype=e_dtype, device=dev)
    beta = torch.zeros((), dtype=torch.float32, device=dev)
    eps = torch.as_tensor(step_size, dtype=torch.float32).to(dev).reshape(())
    # the ChEES state at T0 (constant unless tune_trajectory)
    chees = chees_init(torch.clamp(eps * num_steps, min=1e-6), torch.float32, dev)
    n_leapfrogs = 0
    fixed = betas is not None
    if fixed:
        sched = torch.as_tensor(betas, dtype=torch.float32).to(dev)
        n_run = sched.shape[0]
    else:
        n_run = max_stages
    hist = {name: torch.zeros(max_stages, dtype=torch.float32, device=dev)
            for name in ("betas", "rel_ess", "accept", "step_size", "trajectory_length")}
    hist["resampled"] = torch.zeros(max_stages, dtype=torch.bool, device=dev)

    def cond_ess(logw, ll, delta):
        w = logw + delta.to(logw.dtype) * ll
        return _rel_ess(w - _lse(w, mesh), total, mesh)

    def pick_beta(beta, logw, ll, stage):
        """The next inverse temperature: the fixed schedule's, or the largest
        step whose conditional relative ESS still meets target_rel_ess
        (monotone in the step: an exact bisection), the full step to 1 when
        it already meets it."""
        if fixed:
            return sched[min(stage, n_run - 1)]
        full = 1.0 - beta
        meets_at_full = cond_ess(logw, ll, full) >= target_rel_ess
        lo, hi = torch.zeros_like(full), full
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            ok = cond_ess(logw, ll, mid) >= target_rel_ess
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        # lo == 0 only if even an infinitesimal step fails the target: force
        # minimal progress so the loop cannot stall below max_stages
        return beta + torch.where(meets_at_full, full, torch.maximum(lo, full / max_stages))

    def move(mstate, eps, mixture_vag, b_new, chees):
        """One pi_{b_new}-invariant transition: (state, ChEES state, its
        leapfrog count)."""
        if tune_trajectory:
            q0 = mstate.position
            h = torch.rand((), generator=jitter_generator, device=dev)
            t_len = torch.exp(chees.log_t)
            n_lf = int(num_leapfrog_steps(h * t_len, eps, max_leapfrogs))    # the host read
            mstate, _acc, q1, p1, log_alpha, _div = mh_transition_dynamic(
                generator, mstate, mixture_vag, eps, n_lf, inv_mass,
                friction_schedule=friction_schedule, gamma_max=gamma, steepness=steepness)
            # the criterion's gradient needs the unflipped endpoint momentum
            g = chees_log_t_grad(q0, q1, p1, h, t_len,
                                 torch.exp(log_alpha).to(torch.float32), inv_mass, mesh=mesh)
            return mstate, chees_update(chees, g), n_lf
        if move_backend == "fused":
            return fused_move(stream, mstate, eps, gamma, steepness, inv_mass,
                              bridge=(b_new, base))[0], chees, num_steps
        return grahmc_step(generator, mstate, mixture_vag, eps, num_steps, gamma,
                           steepness, inv_mass, friction_schedule)[0], chees, num_steps

    stage, n_resamples = 0, 0
    n_divergences = torch.zeros((), dtype=torch.int64, device=dev)
    more = True
    while more and stage < n_run:
        lp_b, g_b = base_vag(q)
        ll = lp_t - lp_b.to(e_dtype)
        b_new = pick_beta(beta, logw, ll, stage)
        # reweight and the unbiased log-Z increment (logw stays normalized)
        w = logw + (b_new - beta).to(e_dtype) * ll
        incr = _lse(w, mesh)
        logw = w - incr
        log_z = log_z + incr
        rel = _rel_ess(logw, total, mesh)
        do_res = rel < resample_threshold
        # the stage's one host read: resample?, and is b still below 1?
        resample, more = (bool(x) for x in torch.stack([do_res, b_new < 1.0]).tolist())
        if resample:
            idx = systematic_resample(generator, logw)
            q, lp_t, g_t, lp_b, g_b = q[idx], lp_t[idx], g_t[idx], lp_b[idx], g_b[idx]
            logw = _reset_weights(logw, mesh)
            n_resamples += 1

        # moves targeting pi_{b_new}; the state's mixture log-prob is built
        # from the cached target and base pieces, no extra evaluation
        bb = b_new.to(e_dtype)
        bp = b_new.to(dtype)

        def mixture_vag(x, bb=bb, bp=bp):
            lt, gt = target_vag(x)
            lb, gb = base_vag(x)
            return (bb * lt.to(e_dtype) + (1.0 - bb) * lb.to(e_dtype),
                    bp * gt.to(x.dtype) + (1.0 - bp) * gb.to(x.dtype))

        mstate = ChainState(
            position=q,
            log_prob=bb * lp_t + (1.0 - bb) * lp_b.to(e_dtype),
            grad_log_prob=bp * g_t + (1.0 - bp) * g_b.to(dtype),
            accept_count=torch.zeros(n, dtype=torch.int32, device=dev),
            divergence_count=torch.zeros(n, dtype=torch.int32, device=dev))
        step_in, t_in = eps, torch.exp(chees.log_t)
        accs = []
        for _ in range(move_steps):
            prev = mstate.accept_count
            mstate, chees, n_lf = move(mstate, eps, mixture_vag, b_new, chees)
            n_leapfrogs += n_lf
            acc_t = (mstate.accept_count - prev).to(torch.float32).mean()
            if mesh is not None:
                # the global accept: the step sizes must agree on every rank
                from mcmc_tpu_torch.parallel import pmean
                acc_t = pmean(acc_t, mesh)
            accs.append(acc_t)
            if adapt_step_size:
                # asymmetric: growth capped at e^0.05, shrink up to e^-1,
                # since leapfrog acceptance falls off a cliff at the
                # stability limit
                raw = _STEP_RM_GAIN * (acc_t - _TARGET_MOVE_ACCEPT)
                eps = eps * torch.exp(torch.clamp(raw, -1.0, 0.05))
        accept = torch.stack(accs).mean() if accs else torch.zeros((), device=dev)

        # refresh the target pieces at the moved positions (one evaluation
        # per stage) rather than un-mixing the mixture log-prob, which
        # divides by b_new and amplifies float32 rounding at small b
        q = mstate.position
        lp_t, g_t = target_vag(q)
        lp_t, g_t = lp_t.to(e_dtype), g_t.to(dtype)

        hist["betas"][stage] = b_new
        hist["rel_ess"][stage] = rel.to(torch.float32)
        hist["accept"][stage] = accept
        hist["resampled"][stage] = do_res
        hist["step_size"][stage] = step_in
        hist["trajectory_length"][stage] = t_in
        n_divergences = n_divergences + torch.sum(mstate.divergence_count)
        beta = b_new
        stage += 1

    if final_resample:
        idx = systematic_resample(generator, logw)
        logw = _reset_weights(logw, mesh)
        q, lp_t, g_t = q[idx], lp_t[idx], g_t[idx]
    if mesh is not None:
        from mcmc_tpu_torch.parallel import psum
        n_divergences = psum(n_divergences, mesh)

    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    final_state = ChainState(position=q, log_prob=lp_t, grad_log_prob=g_t,
                             accept_count=zeros, divergence_count=zeros.clone())
    info = {
        "n_stages": stage,
        "n_resamples": n_resamples,
        "n_divergences": n_divergences,
        "ess": _rel_ess(logw, total, mesh) * total,
        "final_step_size": eps,
        # leapfrogs PER PARTICLE: every particle integrates the same count
        "n_leapfrogs": n_leapfrogs,
        "final_trajectory_length": torch.exp(chees.log_t),
        **hist,
    }
    return SMCResult(q, logw, log_z, final_state, info)


def _reset_weights(logw: Tensor, mesh) -> Tensor:
    """Uniform log-weights after a resample: -log P, or on a rank of a mesh
    its island's total weight spread over its particles, so that the
    global weights stay normalized while no particle leaves its rank."""
    n = logw.shape[0]
    if mesh is None:
        return torch.full_like(logw, -math.log(n))
    return torch.full_like(logw, 0.0) + (torch.logsumexp(logw, dim=0) - math.log(n))


def weighted_moments(particles: Tensor, log_weights: Tensor):
    """Self-normalized importance estimates (mean (D,), covariance (D, D))
    of the final weighted population."""
    w = torch.exp(log_weights - torch.logsumexp(log_weights, dim=0))
    dtype = torch.promote_types(w.dtype, particles.dtype)
    w, particles = w.to(dtype), particles.to(dtype)
    mean = torch.sum(w[:, None] * particles, dim=0)
    d = particles - mean
    cov = torch.einsum("p,pi,pj->ij", w, d, d)
    return mean, cov
