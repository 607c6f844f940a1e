"""ChEES: cross-chain trajectory-length adaptation for HMC / GRAHMC (port of
``mcmc_tpu/tuning/chees.py``).

ChEES (Hoffman, Radul & Sountsov, AISTATS 2021) maximizes

    ChEES(T) = (1/4) E[ (||q' - mu'||^2 - ||q - mu||^2)^2 ]

over the trajectory length T. Each iteration integrates a jittered length
t = h T (h quasirandom in (0, 1), shared by all chains, so every chain runs
the same leapfrog count) and ascends d ChEES / d log T with Adam, from the
per-chain estimate g_i = h T alpha_i c_i <q'_i - mu', v'_i>, c_i =
||q'_i - mu'||^2 - ||q_i - mu||^2, v' = M^{-1} p' (alpha_i the MH
acceptance probability; norms in the metric's sphered space).

The step size is tuned alongside by the windowed warmup's dual averaging
and the metric by its Welford windows: `run_chees_warmup` returns what
`run_adaptive_warmup` returns, the tuned trajectory in
info["trajectory_length"] and info["num_steps"]. GRAHMC's friction is held
during adaptation and tuned after it by the sequential ESJD grid
(gamma_tuner="grid"), or adapted inside the warmup by two-sided SPSA on
log gamma (gamma_tuner="joint", diagonal metric only).

Port notes. The JAX package's jitted scans are host loops here. The warmup
transition runs eager (`samplers.trajectory.mh_transition_dynamic`), as the
JAX package's is XLA; each step reads its leapfrog count back to the host
once. `chees_run`'s "fused" backend quantizes the jitter to
`jitter_levels` levels, as the JAX package's "pallas" one does, and launches
kernel 1 (1a for a dense metric, factored once) once per draw at the
draw's level length: the CUDA kernel takes L at launch, so one kernel
serves every level. The ChEES and SPSA states take the energy dtype of the
positions (`mcmc_tpu_torch.precision`), as the port's dual averaging does.
`mesh=` raises.
"""

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import (finalize_run, init_chain_state,
                                          make_value_and_grad, run_sampler)
from mcmc_tpu_torch.samplers.trajectory import as_scalar, mh_transition_dynamic
from mcmc_tpu_torch.tuning.adaptation import build_schedule, fixed_width_batches
from mcmc_tpu_torch.tuning.dual_averaging import (da_final_step_size, da_init,
                                                  da_reset, da_step_size, da_update)
from mcmc_tpu_torch.tuning.welford import (chain_averaged_variance, dense_covariance,
                                           dense_moment_init, dense_moment_update,
                                           shrink_covariance, shrink_variance,
                                           welford_init, welford_update)

Tensor = torch.Tensor

CHEES_ADAM_LR = 0.025          # the paper's Adam learning rate on log T
CHEES_ADAM_EPS = 1e-8
DEFAULT_MAX_STEPS = 256        # cap on leapfrogs per jittered trajectory
CHEES_WINSOR_MULT = 10.0       # clip per-chain gradients at this x median |g|

# Joint GRAHMC friction adaptation: two-sided SPSA on log gamma, probes at
# gamma e^{+-delta} on alternating live steps, one clipped Robbins-Monro
# step per DA batch, gamma kept in [GAMMA_MIN, GAMMA_MAX].
GAMMA_SPSA_DELTA = 0.3
GAMMA_SPSA_LR = 0.4
GAMMA_MIN, GAMMA_MAX = 0.01, 20.0


class GammaSPSAState(NamedTuple):
    """Per-batch accumulator of the two-sided friction probe: the iterate
    log_gamma, the acceptance-weighted sphered-ESJD sums at the + and -
    probes and their live step counts. 0-d tensors."""
    log_gamma: Tensor
    sum_p: Tensor
    sum_m: Tensor
    n_p: Tensor
    n_m: Tensor


def gamma_spsa_init(gamma: float, dtype: torch.dtype = torch.float32,
                    device="cuda") -> GammaSPSAState:
    """The SPSA state at log(gamma), gamma clipped to [GAMMA_MIN,
    GAMMA_MAX] (1 when gamma is not positive)."""
    g0 = float(np.clip(gamma if gamma and gamma > 0 else 1.0, GAMMA_MIN, GAMMA_MAX))
    z = torch.zeros((), dtype=dtype, device=device)
    return GammaSPSAState(torch.full((), math.log(g0), dtype=dtype, device=device),
                          z, z.clone(), z.clone(), z.clone())


def gamma_spsa_batch_update(gs: GammaSPSAState, lr: float = GAMMA_SPSA_LR,
                            delta: float = GAMMA_SPSA_DELTA) -> GammaSPSAState:
    """One Robbins-Monro step on log gamma from a finished batch's probe
    sums: the scale-free estimate (log E+ - log E-) / (2 delta), clipped to
    +-2. Skipped (iterate kept) when either side saw no live step or a
    non-positive sum. The sums restart at 0."""
    e_p = gs.sum_p / torch.clamp(gs.n_p, min=1.0)
    e_m = gs.sum_m / torch.clamp(gs.n_m, min=1.0)
    ok = (gs.n_p > 0) & (gs.n_m > 0) & (e_p > 0) & (e_m > 0)
    g_hat = (torch.log(torch.clamp(e_p, min=1e-30))
             - torch.log(torch.clamp(e_m, min=1e-30))) / (2.0 * delta)
    new_lg = torch.clamp(gs.log_gamma + lr * torch.clamp(g_hat, -2.0, 2.0),
                         math.log(GAMMA_MIN), math.log(GAMMA_MAX))
    z = torch.zeros_like(gs.sum_p)
    return GammaSPSAState(torch.where(ok, new_lg, gs.log_gamma), z, z.clone(), z.clone(),
                          z.clone())


def halton_sequence(n: int, offset: int = 0) -> np.ndarray:
    """Points offset + 1 .. offset + n of the base-2 radical-inverse (van der
    Corput) sequence, float64 on the host: the quasirandom jitter stream."""
    idx = np.arange(offset + 1, offset + n + 1, dtype=np.uint64)
    out = np.zeros(n, dtype=np.float64)
    denom = 1.0
    while idx.any():
        denom *= 2.0
        out += (idx & 1) / denom
        idx >>= 1
    return out


class ChEESState(NamedTuple):
    """Adam on log T: 0-d tensors."""
    log_t: Tensor
    m: Tensor       # first-moment EMA
    v: Tensor       # second-moment EMA
    count: Tensor   # update count (bias correction)


def chees_init(initial_trajectory_length, dtype: torch.dtype = torch.float64,
               device="cuda") -> ChEESState:
    """The ChEES state at T0 (a number, or a tensor that stays on its
    device), on the card unless `device` names another."""
    log_t = torch.log(as_scalar(initial_trajectory_length, dtype, device))
    z = torch.zeros_like(log_t)
    return ChEESState(log_t, z, z.clone(), z.clone())


def chees_update(state: ChEESState, grad, lr: float = CHEES_ADAM_LR, beta1: float = 0.9,
                 beta2: float = 0.999) -> ChEESState:
    """One Adam ascent step on log T (a non-finite gradient counts as 0);
    Adam's second moment makes the step scale-free."""
    count = state.count + 1.0
    if not isinstance(grad, Tensor):
        grad = torch.full((), float(grad), dtype=state.m.dtype, device=state.m.device)
    grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
    m = beta1 * state.m + (1.0 - beta1) * grad
    v = beta2 * state.v + (1.0 - beta2) * grad * grad
    mhat = m / (1.0 - beta1 ** count)
    vhat = v / (1.0 - beta2 ** count)
    log_t = state.log_t + lr * mhat / (torch.sqrt(vhat) + CHEES_ADAM_EPS)
    return ChEESState(log_t, m, v, count)


def _midpoint_median(x: Tensor) -> Tensor:
    """The median with jnp.median's midpoint rule: the mean of the two
    middle order statistics for an even count."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def chees_log_t_grad(q0: Tensor, q1: Tensor, p1: Tensor, h, trajectory_length,
                     alpha: Tensor, inv_mass: Tensor,
                     winsorize: float = CHEES_WINSOR_MULT) -> Tensor:
    """Acceptance-weighted cross-chain estimate of d ChEES / d log T.

    q0/q1: (C, D) current/proposed positions; p1 the unflipped endpoint
    momentum; h the iteration's jitter; alpha (C,) the MH acceptance
    probabilities. Norms in the sphered space z = L^{-1} q (dense M^{-1} =
    L L^T, velocity L^T p) or q / sqrt(M^{-1}) (diagonal, velocity p
    sqrt(M^{-1})). Chains whose endpoint or velocity is not finite are left
    out of the means and the gradient; each chain's term is clipped at
    `winsorize` times the cross-chain median |term| (0 disables), which
    bounds a runaway tail chain's pull."""
    if inv_mass.ndim == 2:
        chol = torch.linalg.cholesky(inv_mass.to(q0.dtype))
        z0 = torch.linalg.solve_triangular(chol, q0.T, upper=False).T
        z1 = torch.linalg.solve_triangular(chol, q1.T, upper=False).T
        vz1 = p1 @ chol
    else:
        scale = torch.sqrt(inv_mass)
        z0, z1, vz1 = q0 / scale, q1 / scale, p1 * scale
    finite = torch.isfinite(z1).all(dim=-1) & torch.isfinite(vz1).all(dim=-1)
    fmask = finite.to(z1.dtype)
    z1 = torch.where(finite[:, None], z1, torch.zeros_like(z1))
    vz1 = torch.where(finite[:, None], vz1, torch.zeros_like(vz1))
    n_fin = torch.sum(fmask)
    mu0 = torch.mean(z0, dim=0)
    mu1 = torch.sum(z1, dim=0) / torch.clamp(n_fin, min=1.0)
    d1 = z1 - mu1
    c = torch.sum(d1 * d1, dim=-1) - torch.sum((z0 - mu0) ** 2, dim=-1)
    dc_dt = fmask * c * torch.sum(d1 * vz1, dim=-1)
    # a finite but huge q1 can still overflow c, and inf * 0 is nan
    ok = torch.isfinite(dc_dt)
    dc_dt = torch.where(ok, dc_dt, torch.zeros_like(dc_dt))
    alpha = alpha * fmask * ok
    if winsorize:
        bound = winsorize * _midpoint_median(torch.abs(dc_dt))
        dc_dt = torch.clamp(dc_dt, -bound, bound)
    g = torch.sum(alpha * dc_dt) / torch.clamp(torch.sum(alpha), min=1e-12)
    return g * h * trajectory_length       # t = h T: d / d log T = t d / dt


def num_leapfrog_steps(t, step_size, max_steps: int) -> Tensor:
    """Trajectory time t quantized to a leapfrog count, ceil(t / eps)
    clipped to [1, max_steps], as an int32 tensor."""
    n = torch.ceil(torch.as_tensor(t) / step_size)
    return torch.clamp(n, 1, max_steps).to(torch.int32)


def scale_default_schedule(num_warmup: int) -> Tuple[int, list, int]:
    """The Stan-style default warmup schedule (500 exploration + [25, 50,
    100, 200, 500, 1000] windows + 125 cooldown = 2,500) scaled to
    `num_warmup`: the same 20/75/5 proportions, exactly num_warmup steps,
    the smallest windows dropped first when all six cannot fit."""
    f = num_warmup / 2500.0
    exploration = max(1, int(round(500 * f)))
    windows = [max(1, int(round(w * f))) for w in (25, 50, 100, 200, 500, 1000)]
    while exploration + sum(windows) + 1 > num_warmup and len(windows) > 1:
        windows.pop(0)
    while exploration + sum(windows) + 1 > num_warmup and exploration > 1:
        exploration -= 1
    cooldown = max(1, num_warmup - exploration - sum(windows))
    return exploration, windows, cooldown


def jitter_levels_of(trajectory_length: float, step_size: float, max_steps: int,
                     levels: int, h: np.ndarray):
    """The fused backend's quantized jitter: (the distinct level lengths Ls,
    each draw's branch index into Ls), the JAX package's rule exactly --
    level k's length is round((k + 1/2) / levels T / eps) (Python's round,
    half to even), clipped to [1, max_steps], and a draw with jitter h takes
    level min(levels - 1, int(h levels))."""
    levels = max(1, int(levels))
    level_l = [int(np.clip(round((k + 0.5) / levels * trajectory_length / step_size),
                           1, max_steps)) for k in range(levels)]
    ls = sorted(set(level_l))
    branch_of_level = [ls.index(n) for n in level_l]
    idx = np.asarray([branch_of_level[min(levels - 1, int(x * levels))] for x in h],
                     np.int32)
    return ls, idx


def _resolve_backend(backend: str, value_and_grad_fn, device) -> str:
    """"auto" -> "fused" for CUDA positions and a family kernel 1
    dispatches on, else "eager"."""
    from mcmc_tpu_torch.ops.padded_targets import KERNEL_FAMILIES
    if backend == "auto":
        info = getattr(value_and_grad_fn, "kernel_info", None)
        fusable = info is not None and info["family"] in KERNEL_FAMILIES["grahmc"]
        return "fused" if fusable and torch.device(device).type == "cuda" else "eager"
    if backend not in ("eager", "fused"):
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'eager' or 'fused'")
    return backend


def _friction(schedule_type: Optional[str]):
    if schedule_type is None:
        return None
    from mcmc_tpu_torch.samplers.grahmc import get_friction_schedule
    return get_friction_schedule(schedule_type)


def chees_run(
    generator: torch.Generator,
    log_prob_fn,
    init_position: Tensor,
    step_size: float,
    trajectory_length: float,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Tensor] = None,
    value_and_grad_fn=None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
    max_steps: int = DEFAULT_MAX_STEPS,
    jitter_levels: int = 4,
    schedule_type: Optional[str] = None,
    gamma: float = 0.0,
    steepness: float = 1.0,
    halton_offset: int = 8192,
    mesh=None,
):
    """Jittered-trajectory sampling at the ChEES-tuned point: draw i
    integrates t_i = h_i trajectory_length, h_i the Halton stream from
    `halton_offset` (shared by all chains), which averages away the
    resonance a fixed L can hit.

    backend: "eager" (continuous jitter: ceil(h T / eps) leapfrogs per draw
    through mh_transition_dynamic, any log-prob and metric), "fused" (the
    jitter quantized to `jitter_levels` levels, jitter_levels_of; one
    kernel-1 launch per draw at its level's L, 1a for a dense metric
    factored once; tagged targets) or "auto" (fused for CUDA positions and
    a family kernel 1 dispatches on). schedule_type None is plain HMC,
    else GRAHMC's friction with `gamma` and `steepness`. `generator` lives
    on the positions' device; the fused backend draws its Philox key from
    it once per run.

    Returns the RunResult; info carries total_leapfrogs (the leapfrogs the
    draws really took), mean_num_steps, num_steps_per_draw,
    trajectory_length, jitter_backend and, fused, jitter_level_steps."""
    if mesh is not None:
        raise NotImplementedError("chees_run over a mesh waits for parallel/ "
                                  "(ROADMAP Queue 1, item 7)")
    if trajectory_length <= 0 or step_size <= 0:
        raise ValueError("step_size and trajectory_length must be positive")
    state = init_chain_state(init_position, log_prob_fn, value_and_grad_fn, needs_grad=True)
    n_dim = state.position.shape[1]
    pos_dtype, device = state.position.dtype, state.position.device
    inv_mass = (torch.ones(n_dim, dtype=pos_dtype, device=device) if inv_mass_matrix is None
                else inv_mass_matrix.to(device=device, dtype=pos_dtype))
    backend = _resolve_backend(backend, value_and_grad_fn, device)
    friction = _friction(schedule_type)
    h = halton_sequence(burn_in + num_samples, halton_offset)

    if backend == "fused":
        from mcmc_tpu_torch.ops.fused_trajectory import (PhiloxStream, make_fused_grahmc_step,
                                                         prepare_dense_metric)
        if value_and_grad_fn is None:
            raise TypeError("the fused backend requires an analytic "
                            "value_and_grad_fn from mcmc_tpu_torch.targets")
        level_steps, idx = jitter_levels_of(trajectory_length, step_size, max_steps,
                                            jitter_levels, h)
        ns = np.asarray([level_steps[i] for i in idx], np.int64)
        if inv_mass.ndim == 2:
            inv_mass = prepare_dense_metric(inv_mass)       # factored once per run
        fused = {n: make_fused_grahmc_step(value_and_grad_fn, n, friction)
                 for n in level_steps}
        stream = PhiloxStream.from_generator(generator, device)
        draws = iter(ns.tolist())

        def step(s):
            s, (accept, *_r) = fused[next(draws)](stream, s, step_size, gamma, steepness,
                                                  inv_mass)
            return s, accept
    else:
        ns = np.clip(np.ceil(h * trajectory_length / step_size), 1, max_steps).astype(np.int64)
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
        draws = iter(ns.tolist())

        def step(s):
            s, accept, *_r = mh_transition_dynamic(
                generator, s, vag, step_size, next(draws), inv_mass,
                friction_schedule=friction, gamma_max=gamma, steepness=steepness)
            return s, accept

    state, samples, log_probs, _ = run_sampler(step, state, num_samples, burn_in,
                                               collect_chains)
    sample_ns = ns[burn_in:]
    extra = {
        "total_leapfrogs": int(sample_ns.sum()),
        "mean_num_steps": float(sample_ns.mean()),
        "num_steps_per_draw": np.asarray(sample_ns, np.int32),
        "trajectory_length": float(trajectory_length),
        "jitter_backend": backend,
    }
    if backend == "fused":
        extra["jitter_level_steps"] = level_steps
    return finalize_run(state, samples, log_probs, num_samples, extra)


def _cooldown_mean(values, weights, fallback: float) -> float:
    """The live-step-weighted mean of the cooldown batches' values (Polyak
    averaging), or `fallback` when there were none."""
    if not values:
        return fallback
    return float(np.average([float(v) for v in values], weights=weights))


def run_chees_warmup(
    sampler: str,
    target_log_prob,
    target_grad_log_prob,            # API parity with run_adaptive_warmup
    initial_position: Tensor,
    generator: torch.Generator,
    num_warmup: int = 1000,
    target_accept: float = 0.651,
    schedule_type: Optional[str] = None,
    update_freq: int = 100,
    learn_mass_matrix=True,
    value_and_grad_fn=None,
    verbose: bool = False,
    max_steps: int = DEFAULT_MAX_STEPS,
    adam_lr: float = CHEES_ADAM_LR,
    initial_trajectory_length: Optional[float] = None,
    gamma: float = 1.0,
    steepness: Optional[float] = None,
    mesh=None,
    gamma_tuner: str = "grid",
    **kwargs,
) -> Tuple[float, Optional[Tensor], Tensor, Dict]:
    """ChEES warmup: step size (dual averaging), metric (Welford windows,
    diagonal; pooled moments, "dense") and trajectory length (ChEES / Adam)
    adapted together. Returns (step_size, inv_mass or None, position,
    info), info["trajectory_length"] the tuned T and info["num_steps"] the
    equivalent fixed count round(T / step).

    sampler: "hmc", or "grahmc"/"rahmc" (friction held at `gamma`, then the
    sequential ESJD tune, gamma_tuner="grid"; or adapted inside the warmup
    by SPSA, "joint", which needs a diagonal metric and falls back to the
    grid when it ends pinned at a bound). The schedule is
    scale_default_schedule(num_warmup) unless exploration_steps,
    adaptation_windows or cooldown_steps are given; every window runs in
    fixed-width batches of update_freq steps (masked steps still move the
    chains but adapt nothing), one DA update per batch from the batch's
    mean acceptance probability. log T (and log gamma) is averaged over the
    cooldown batches. `generator` lives on the positions' device and
    drives every draw."""
    if mesh is not None:
        raise NotImplementedError("the mesh warmup waits for parallel/ "
                                  "(ROADMAP Queue 1, item 7)")
    if sampler not in ("hmc", "grahmc", "rahmc"):
        raise ValueError(f"ChEES adaptation supports hmc/grahmc, got {sampler}")
    if gamma_tuner not in ("grid", "joint"):
        raise ValueError(f"unknown gamma_tuner {gamma_tuner!r}")
    joint_gamma = gamma_tuner == "joint" and sampler in ("grahmc", "rahmc")
    if joint_gamma and learn_mass_matrix == "dense":
        raise ValueError("gamma_tuner='joint' needs a diagonal metric (sphered ESJD); "
                         "use gamma_tuner='grid' with learn_mass_matrix='dense'")
    dense_mass = learn_mass_matrix == "dense"
    n_chains, n_dim = initial_position.shape
    pos_dtype, device = initial_position.dtype, initial_position.device
    e_dtype = precision.energy_dtype(pos_dtype)

    friction_schedule = None
    if sampler in ("grahmc", "rahmc"):
        from mcmc_tpu_torch.samplers.grahmc import default_steepness, get_friction_schedule
        friction_schedule = get_friction_schedule(schedule_type or "constant")
        if steepness is None:
            steepness = default_steepness(schedule_type or "constant")
    vag = make_value_and_grad(target_log_prob, value_and_grad_fn)

    initial_step = 0.5 / math.sqrt(n_dim)
    if initial_trajectory_length is None:
        initial_trajectory_length = initial_step    # one leapfrog to start
    da = da_init(initial_step, e_dtype, device)
    ch = chees_init(initial_trajectory_length, e_dtype, device)
    gs = gamma_spsa_init(gamma if joint_gamma else 1.0, torch.float32, device)
    cs = init_chain_state(initial_position, target_log_prob, value_and_grad_fn,
                          needs_grad=True)
    if dense_mass:
        inv_mass = torch.eye(n_dim, dtype=pos_dtype, device=device)
        moments = dense_moment_init(torch.zeros(n_dim, dtype=pos_dtype, device=device))
    else:
        inv_mass = torch.ones(n_dim, dtype=pos_dtype, device=device)
        moments = welford_init((n_chains, n_dim), pos_dtype, device)
    update = dense_moment_update if dense_mass else welford_update

    if any(k in kwargs for k in ("exploration_steps", "adaptation_windows", "cooldown_steps")):
        exploration_steps = kwargs.get("exploration_steps", 500)
        adaptation_windows = kwargs.get("adaptation_windows")
        cooldown_steps = kwargs.get("cooldown_steps", 125)
    else:
        exploration_steps, adaptation_windows, cooldown_steps = scale_default_schedule(
            num_warmup)
    schedule = build_schedule(num_warmup, exploration_steps=exploration_steps,
                              adaptation_windows=adaptation_windows,
                              cooldown_steps=cooldown_steps)
    if verbose:
        print(f"ChEES adaptation schedule ({sum(e - s for s, e, _ in schedule)} steps), "
              f"max_steps={max_steps}, adam_lr={adam_lr}")

    def step(cs, ch, gs, moments, h: float, live: bool, accumulate: bool):
        """One transition of the warmup: (cs, ch, gs, moments, accept
        statistic, leapfrog count, log T)."""
        eps = da_step_size(da).to(pos_dtype)
        t_len = torch.clamp(torch.exp(ch.log_t).to(pos_dtype), eps, max_steps * eps)
        h_t = as_scalar(h, pos_dtype, device)
        n = int(num_leapfrog_steps(h_t * t_len, eps, max_steps))    # the host read
        q0 = cs.position
        gamma_t = gamma
        if joint_gamma:
            # live steps alternate +-delta around the iterate (parity of the
            # live step count, so masked steps never break the alternation)
            probe_plus = ((gs.n_p + gs.n_m) % 2.0) < 0.5
            sign = torch.where(probe_plus, 1.0, -1.0)
            gamma_t = torch.exp(gs.log_gamma + sign * GAMMA_SPSA_DELTA).to(pos_dtype)
        cs, _accept, q1, p1, log_alpha, _div = mh_transition_dynamic(
            generator, cs, vag, eps, n, inv_mass, friction_schedule=friction_schedule,
            gamma_max=gamma_t, steepness=steepness)
        alpha = torch.exp(log_alpha)
        if joint_gamma and live:
            d = (q1 - q0).to(torch.float32)
            esjd = torch.mean(alpha.to(torch.float32)
                              * torch.sum(d * d / inv_mass.to(torch.float32), dim=-1))
            zero = torch.zeros_like(esjd)
            gs = gs._replace(sum_p=gs.sum_p + torch.where(probe_plus, esjd, zero),
                             n_p=gs.n_p + probe_plus.to(torch.float32),
                             sum_m=gs.sum_m + torch.where(probe_plus, zero, esjd),
                             n_m=gs.n_m + (~probe_plus).to(torch.float32))
        if live:
            g = chees_log_t_grad(q0, q1, p1, h_t, t_len, alpha.to(pos_dtype), inv_mass)
            ch = chees_update(ch, g, lr=adam_lr)
            if accumulate:
                moments = update(moments, cs.position)
        return cs, ch, gs, moments, torch.mean(alpha), n, ch.log_t

    halton_offset = 0
    accept_trace, log_t_trace, mean_n_trace, log_gamma_trace = [], [], [], []
    cool_log_ts, cool_weights, cool_log_gammas = [], [], []
    for start_idx, end_idx, phase in schedule:
        accumulate = phase == "adaptation" and bool(learn_mass_matrix)
        if accumulate:
            moments = (dense_moment_init(torch.mean(cs.position, dim=0)) if dense_mass
                       else welford_init((n_chains, n_dim), pos_dtype, device))
        for n_real, mask in fixed_width_batches(end_idx - start_idx, update_freq):
            row = np.zeros(mask.numel(), dtype=np.float64)
            row[:n_real] = halton_sequence(n_real, halton_offset)
            halton_offset += n_real
            alphas, ns, log_ts = [], [], []
            for h, live in zip(row.tolist(), mask.tolist()):
                cs, ch, gs, moments, acc, n, log_t = step(cs, ch, gs, moments, h, live,
                                                          accumulate)
                if live:
                    alphas.append(acc)
                    ns.append(n)
                    log_ts.append(log_t)
            acc_mean = torch.stack(alphas).mean()
            da = da_update(da, acc_mean, target_accept)
            if joint_gamma:
                gs = gamma_spsa_batch_update(gs)
            accept_trace.append(acc_mean)
            log_t_trace.append(torch.stack(log_ts).mean())
            mean_n_trace.append(float(np.mean(ns)))
            log_gamma_trace.append(gs.log_gamma)
            if phase == "cooldown":
                cool_log_ts.append(log_t_trace[-1])
                cool_weights.append(n_real)
                cool_log_gammas.append(gs.log_gamma)
        if accumulate:
            if dense_mass:
                inv_mass = shrink_covariance(dense_covariance(moments),
                                             moments.count / n_chains).to(pos_dtype)
            else:
                inv_mass = shrink_variance(chain_averaged_variance(moments),
                                           moments.count).to(pos_dtype)
            da = da_reset(da)
            if verbose:
                print(f"  window [{start_idx}-{end_idx}]: T={float(torch.exp(ch.log_t)):.4f} "
                      f"mass range [{float(inv_mass.min()):.4f}, {float(inv_mass.max()):.4f}]")

    accept_trace = [float(a) for a in accept_trace]
    log_t_trace = [float(t) for t in log_t_trace]
    step_size = float(da_final_step_size(da))
    log_t_final = _cooldown_mean(cool_log_ts, cool_weights, float(ch.log_t))
    # the criterion ran away iff the averaged iterate reaches the cap (read
    # before the clip and before any step retune)
    max_steps_cap_hit = bool(np.exp(log_t_final) >= max_steps * step_size)
    trajectory_length = float(np.clip(np.exp(log_t_final), step_size, max_steps * step_size))
    num_steps = int(max(1, round(trajectory_length / step_size)))
    inv_mass = inv_mass if learn_mass_matrix else None
    position = cs.position

    gamma_fallback_to_grid = False
    run_grid_phase = friction_schedule is not None and kwargs.get("tune_gamma", True)
    tuned_gamma = gamma if friction_schedule is not None else None
    if joint_gamma and kwargs.get("tune_gamma", True):
        lg_final = _cooldown_mean(cool_log_gammas, cool_weights, float(gs.log_gamma))
        if (lg_final <= math.log(GAMMA_MIN) * 0.99 + 0.01
                or lg_final >= math.log(GAMMA_MAX) * 0.99):
            gamma_fallback_to_grid = True
        else:
            tuned_gamma = float(np.exp(lg_final))
            run_grid_phase = False
    if run_grid_phase:
        from mcmc_tpu_torch.tuning.adaptation import _resolve_backend as warmup_backend
        from mcmc_tpu_torch.tuning.sequential import sequential_tune_grahmc
        step_size, tuned_gamma, steepness, _hist = sequential_tune_grahmc(
            generator, target_log_prob, target_grad_log_prob, position,
            num_steps=num_steps,
            schedule_type=schedule_type or "constant",
            target_accept=target_accept,
            inv_mass_matrix=inv_mass,
            init_step_size=step_size,
            gamma_coarse_values=kwargs.get("gamma_coarse_values"),
            gamma_samples_per_eval=kwargs.get("gamma_samples_per_eval", 150),
            value_and_grad_fn=value_and_grad_fn,
            steepness=steepness,
            verbose=verbose,
            backend=warmup_backend("grahmc", "auto", value_and_grad_fn, device))
        step_size = float(step_size)
        num_steps = int(max(1, round(trajectory_length / step_size)))
        if num_steps > max_steps:
            # the retuned step pushed the equivalent count past the cap: a
            # jittered run would truncate its long draws
            max_steps_cap_hit = True

    info = {
        "trajectory_length": trajectory_length,
        "num_steps": num_steps,
        "step_size": step_size,
        "mass_matrix_learned": learn_mass_matrix,
        "accept_history": accept_trace,
        "log_t_history": log_t_trace,
        "mean_leapfrogs_history": mean_n_trace,
        "halton_offset": halton_offset,
        "max_steps_cap_hit": max_steps_cap_hit,
        "target_accept": target_accept,
    }
    if friction_schedule is not None:
        info["gamma"] = float(tuned_gamma)
        info["steepness"] = float(steepness)
        info["gamma_tuner"] = "joint" if joint_gamma and not gamma_fallback_to_grid else "grid"
        if joint_gamma:
            info["log_gamma_history"] = [float(g) for g in log_gamma_trace]
            info["gamma_fallback_to_grid"] = gamma_fallback_to_grid
    if verbose:
        print(f"ChEES complete: T={trajectory_length:.4f} step={step_size:.5f} -> L={num_steps}")
    return step_size, inv_mass, position, info
