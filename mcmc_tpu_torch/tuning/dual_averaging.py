"""Nesterov dual averaging for step-size adaptation (Hoffman & Gelman 2014)
(port of ``mcmc_tpu/tuning/dual_averaging.py``).

Stan constants gamma=0.05, t0=10, kappa=0.75. The state is 0-d tensors on the
device, so a tune loop can feed a batch-mean acceptance tensor straight back
into the next step size without reading anything on the host.

The per-sampler convergence-driven tuners (dual_averaging_tune_{rwmh,hmc,
nuts}) keep the reference's protocol: batches of `n_samples_per_tune`
transitions, one DA update each, the relative change of the smoothed step
below `tolerance` for `patience` consecutive iterations after `min_iter`.
They run chunks of 25 DA iterations with no host read inside and read the
chunk's steps once, as the JAX package's device-side chunks do. RWMH's
tuner runs kernel 3 and the joint GRAHMC tune kernel 1 where "auto" picks
them (CUDA positions, a tagged target); HMC's and NUTS's run eager (NUTS is
classic NUTS, ``samplers/nuts.py``). joint_tune_grahmc (vector DA over
[log eps, log gamma]) is kept for parity but deprecated in favor of the
sequential ESJD tune (tuning/sequential.py), as in the JAX package.
"""

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.trajectory import as_scalar

DA_GAMMA = 0.05   # shrinkage toward mu (Stan)
DA_T0 = 10.0      # iteration offset (Stan)
DA_KAPPA = 0.75   # smoothing decay (Stan)

TARGET_ACCEPT_RWMH = 0.234   # Roberts & Rosenthal optimal
TARGET_ACCEPT_HMC = 0.65
TARGET_ACCEPT_NUTS = 0.65
TARGET_ACCEPT_GRAHMC = 0.65


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor      # current (noisy) log step size
    log_step_bar: torch.Tensor  # smoothed log step size
    h_bar: torch.Tensor         # running error average
    mu: torch.Tensor            # shrinkage reference point
    count: torch.Tensor         # iteration counter m


def da_init(initial_step_size, dtype: torch.dtype = torch.float32,
            device="cuda") -> DualAveragingState:
    """The DA state at `initial_step_size` (a number or a tensor, which
    stays on the device), on the card unless `device` names another
    device."""
    log_step = torch.log(as_scalar(initial_step_size, dtype, device))
    return DualAveragingState(
        log_step=log_step,
        log_step_bar=log_step,
        h_bar=torch.zeros_like(log_step),
        mu=log_step,
        count=torch.zeros_like(log_step),
    )


def da_update(state: DualAveragingState, accept_stat,
              target_accept) -> DualAveragingState:
    """One DA update from a batch-mean acceptance statistic (number or
    tensor)."""
    m = state.count + 1.0
    eta = 1.0 / (m + DA_T0)
    h_bar = (1.0 - eta) * state.h_bar + eta * (target_accept - accept_stat)
    log_step = state.mu - (torch.sqrt(m) / DA_GAMMA) * h_bar
    m_kappa = m ** (-DA_KAPPA)
    smoothed = m_kappa * log_step + (1.0 - m_kappa) * state.log_step_bar
    # The first iteration initializes the smoothed value outright.
    log_step_bar = torch.where(m == 1.0, log_step, smoothed)
    return DualAveragingState(log_step, log_step_bar, h_bar, state.mu, m)


def da_reset(state: DualAveragingState) -> DualAveragingState:
    """Restart adaptation around the current best estimate (new mu), as the
    windowed warmup does when the mass matrix changes: the smoothed step
    (the current one before any update) becomes the new reference."""
    current = torch.where(state.count > 0, state.log_step_bar, state.log_step)
    return DualAveragingState(
        log_step=current,
        log_step_bar=current,
        h_bar=torch.zeros_like(current),
        mu=current,
        count=torch.zeros_like(state.count),
    )


def da_step_size(state: DualAveragingState) -> torch.Tensor:
    """Current exploration step size exp(log_step)."""
    return torch.exp(state.log_step)


def da_final_step_size(state: DualAveragingState) -> torch.Tensor:
    """Final smoothed step size exp(log_step_bar)."""
    return torch.exp(state.log_step_bar)


# ============================================================================
# Convergence-driven per-sampler tuners
# ============================================================================

def _tune_with_da(
    run_batch: Callable,        # (position, step_size) -> (accept_stat, position)
    init_step_size: float,
    target_accept: float,
    init_position: torch.Tensor,
    tolerance: float = 0.01,
    max_iter: int = 2000,
    min_iter: int = 100,
    patience: int = 10,
    chunk: int = 25,
) -> Tuple[float, Dict]:
    """Generic DA tuning loop: chunks of `chunk` DA iterations with no host
    read inside, then the chunk's smoothed steps and accept statistics read
    at once and the convergence checked on the host (relative change of the
    smoothed step below tolerance for `patience` consecutive iterations
    after `min_iter`). The DA state takes the positions' energy dtype and
    device; run_batch owns its randomness."""
    device = init_position.device
    da_state = da_init(init_step_size, precision.energy_dtype(init_position.dtype), device)
    position = init_position
    step_hist, accept_hist = [], []
    converged_count = 0
    converged_iter = max_iter
    prev = float(da_final_step_size(da_state))

    m = 0
    while m < max_iter:
        steps, accepts = [], []
        for _ in range(chunk):
            accept_stat, position = run_batch(position, da_step_size(da_state))
            da_state = da_update(da_state, accept_stat, target_accept)
            steps.append(da_final_step_size(da_state))
            accepts.append(accept_stat.to(da_state.log_step.dtype))
        steps = torch.stack(steps).tolist()
        accept_hist.extend(torch.stack(accepts).tolist())
        step_hist.extend(steps)
        for s in steps:
            m += 1
            if m >= min_iter:
                rel = abs(s - prev) / (abs(prev) + 1e-10)
                converged_count = converged_count + 1 if rel < tolerance else 0
                if converged_count >= patience:
                    converged_iter = m
                    break
            prev = s
        if converged_iter < max_iter:
            break

    final = step_hist[converged_iter - 1] if converged_iter <= len(step_hist) else step_hist[-1]
    history = {
        "scale_history": step_hist,
        "step_size_history": step_hist,
        "accept_history": accept_hist,
        "converged_iter": converged_iter,
        "target_accept": target_accept,
    }
    return float(final), history


def _fused_backend(backend: str, kernel: str, value_and_grad_fn, device) -> bool:
    """Whether a tuner runs its fused kernel: "auto" where the kernel takes
    the target on this device (padded_targets.fusable), "fused" always (the
    kernel runs or raises), "eager" never."""
    from mcmc_tpu_torch.ops.padded_targets import fusable
    if backend == "auto":
        return fusable(kernel, value_and_grad_fn, device)
    if backend not in ("eager", "fused"):
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'eager' or 'fused'")
    return backend == "fused"


def dual_averaging_tune_rwmh(
    generator: torch.Generator, log_prob_fn, init_position: torch.Tensor,
    target_accept: float = TARGET_ACCEPT_RWMH,
    tolerance: float = 0.01, max_iter: int = 2000, min_iter: int = 100,
    patience: int = 10, n_samples_per_tune: int = 100,
    value_and_grad_fn: Optional[Callable] = None, backend: str = "auto",
) -> Tuple[float, Dict]:
    """Tune the RWMH proposal scale from 2.38 / sqrt(d) (Roberts &
    Rosenthal). Each DA iteration runs `n_samples_per_tune` transitions;
    fused (kernel 3, T the largest of rwmh.FUSED_TRANSITIONS dividing
    n_samples_per_tune) for CUDA positions and a tagged target under
    "auto", eager otherwise. `generator` lives on the positions' device."""
    from mcmc_tpu_torch.samplers.rwmh import FUSED_TRANSITIONS, rwmh_init, rwmh_step

    d = init_position.shape[-1]
    state0 = rwmh_init(init_position, log_prob_fn)
    if _fused_backend(backend, "rwmh", value_and_grad_fn, init_position.device):
        from mcmc_tpu_torch.ops.fused_rwmh import make_fused_rwmh_multistep
        from mcmc_tpu_torch.ops.fused_trajectory import PhiloxStream
        trans = next(t for t in FUSED_TRANSITIONS if n_samples_per_tune % t == 0)
        multi = make_fused_rwmh_multistep(value_and_grad_fn, trans, n_hist=1)
        stream = PhiloxStream.from_generator(generator, init_position.device)

        def advance(st, scale):
            accepts = []
            for _ in range(n_samples_per_tune // trans):
                st, (accept, _q, _lp) = multi(stream, st, scale)
                accepts.append(accept)
            return st, torch.cat(accepts)
    else:
        def advance(st, scale):
            accepts = []
            for _ in range(n_samples_per_tune):
                st, accept = rwmh_step(generator, st, log_prob_fn, scale)
                accepts.append(accept)
            return st, torch.stack(accepts)

    def run_batch(position, scale):
        st = state0._replace(position=position,
                             log_prob=log_prob_fn(position).to(state0.log_prob.dtype))
        st, accepts = advance(st, scale)
        return accepts.to(torch.float32).mean(), st.position

    return _tune_with_da(run_batch, 2.38 / d ** 0.5, target_accept, state0.position,
                         tolerance, max_iter, min_iter, patience)


def dual_averaging_tune_hmc(
    generator: torch.Generator, log_prob_fn, init_position: torch.Tensor,
    num_steps: int = 20, target_accept: float = TARGET_ACCEPT_HMC,
    inv_mass_matrix: Optional[torch.Tensor] = None, value_and_grad_fn=None,
    tolerance: float = 0.01, max_iter: int = 2000, min_iter: int = 100,
    patience: int = 10, n_samples_per_tune: int = 100,
) -> Tuple[float, Dict]:
    """Tune the HMC step size at a fixed trajectory length from 0.5 /
    sqrt(d) (eager, as the port's HMC warmup)."""
    from mcmc_tpu_torch.samplers.base import make_value_and_grad
    from mcmc_tpu_torch.samplers.hmc import hmc_init, hmc_step

    d = init_position.shape[-1]
    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
    state0 = hmc_init(init_position, log_prob_fn, value_and_grad_fn)
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(d, dtype=state0.position.dtype,
                                     device=state0.position.device)

    def run_batch(position, step_size):
        lp, grad = vag(position)
        st = state0._replace(position=position, log_prob=lp.to(state0.log_prob.dtype),
                             grad_log_prob=grad.to(position.dtype))
        accepts = []
        for _ in range(n_samples_per_tune):
            st, (accept, *_rest) = hmc_step(generator, st, vag, step_size, num_steps,
                                            inv_mass_matrix)
            accepts.append(accept)
        return torch.stack(accepts).to(torch.float32).mean(), st.position

    return _tune_with_da(run_batch, 0.5 / d ** 0.5, target_accept, state0.position,
                         tolerance, max_iter, min_iter, patience)


def dual_averaging_tune_nuts(
    generator: torch.Generator, log_prob_fn, init_position: torch.Tensor,
    max_tree_depth: int = 10, target_accept: float = TARGET_ACCEPT_NUTS,
    inv_mass_matrix: Optional[torch.Tensor] = None, value_and_grad_fn=None,
    tolerance: float = 0.01, max_iter: int = 2000, min_iter: int = 100,
    patience: int = 10, n_samples_per_tune: int = 100,
) -> Tuple[float, Dict]:
    """Tune the classic-NUTS step size from 0.5 / sqrt(d); the accept
    statistic is the mean trajectory alpha."""
    from mcmc_tpu_torch.samplers.base import make_value_and_grad
    from mcmc_tpu_torch.samplers.nuts import nuts_init, nuts_step

    d = init_position.shape[-1]
    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
    state0 = nuts_init(init_position, log_prob_fn, value_and_grad_fn)
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(d, dtype=state0.position.dtype,
                                     device=state0.position.device)

    def run_batch(position, step_size):
        lp, grad = vag(position)
        st = state0._replace(position=position, log_prob=lp.to(state0.log_prob.dtype),
                             grad_log_prob=grad.to(position.dtype))
        alphas = []
        for _ in range(n_samples_per_tune):
            st, (_depths, mean_alpha) = nuts_step(generator, st, vag, step_size,
                                                  inv_mass_matrix, max_tree_depth)
            alphas.append(torch.mean(mean_alpha))
        return torch.stack(alphas).mean(), st.position

    return _tune_with_da(run_batch, 0.5 / d ** 0.5, target_accept, state0.position,
                         tolerance, max_iter, min_iter, patience)


# ============================================================================
# Joint [step, gamma] dual averaging for GRAHMC (kept for parity; deprecated)
# ============================================================================

class JointDualAveragingState(NamedTuple):
    """Vector DA over [log step, log gamma] driven by one scalar accept error."""
    log_params: torch.Tensor
    log_params_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


GAMMA_CLIP = (0.01, 20.0)


def joint_da_init(initial_params) -> JointDualAveragingState:
    """The joint state at (step, gamma), a (2,) tensor whose dtype and
    device the state keeps."""
    lp = torch.log(torch.as_tensor(initial_params))
    zero = torch.zeros((), dtype=lp.dtype, device=lp.device)
    return JointDualAveragingState(lp, lp, zero, lp, zero)


def joint_da_update(state: JointDualAveragingState, accept_stat,
                    target_accept) -> JointDualAveragingState:
    m = state.count + 1.0
    eta = 1.0 / (m + DA_T0)
    h_bar = (1.0 - eta) * state.h_bar + eta * (target_accept - accept_stat)
    log_params = state.mu - (torch.sqrt(m) / DA_GAMMA) * h_bar
    lo, hi = torch.log(torch.tensor(GAMMA_CLIP, dtype=log_params.dtype))
    log_params = torch.cat([log_params[:1], torch.clamp(log_params[1:], float(lo), float(hi))])
    m_kappa = m ** (-DA_KAPPA)
    bar = m_kappa * log_params + (1.0 - m_kappa) * state.log_params_bar
    bar = torch.where(m == 1.0, log_params, bar)
    return JointDualAveragingState(log_params, bar, h_bar, state.mu, m)


def joint_tune_grahmc(
    generator: torch.Generator, log_prob_fn, grad_log_prob_fn, init_position: torch.Tensor,
    num_steps: int, schedule_type: str = "constant",
    target_accept: float = TARGET_ACCEPT_GRAHMC, max_iter: int = 1000,
    inv_mass_matrix: Optional[torch.Tensor] = None, current_step_size=None,
    fixed_steepness: float = 10.0, value_and_grad_fn=None,
    n_samples_per_tune: int = 50, backend: str = "auto",
) -> Tuple[float, float, float, Dict]:
    """DEPRECATED joint acceptance-driven tune of (step_size, gamma): one
    scalar error signal cannot tune two parameters with opposite effects on
    the acceptance (the JAX package's and the reference's conclusion); kept
    for comparison. The production path is
    tuning.sequential.sequential_tune_grahmc. Each iteration runs
    `n_samples_per_tune` GRAHMC transitions, through kernel 1 for CUDA
    positions and a tagged target under "auto", and reads nothing on the
    host; the history is read once at the end. Returns (step, gamma,
    steepness, history)."""
    from mcmc_tpu_torch.samplers.base import make_value_and_grad
    from mcmc_tpu_torch.samplers.grahmc import (get_friction_schedule, grahmc_init,
                                                grahmc_step)

    schedule = get_friction_schedule(schedule_type)
    d = init_position.shape[-1]
    state = grahmc_init(init_position, log_prob_fn, value_and_grad_fn)
    device, e_dtype = state.position.device, state.log_prob.dtype
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(d, dtype=state.position.dtype, device=device)
    if _fused_backend(backend, "grahmc", value_and_grad_fn, device):
        from mcmc_tpu_torch.ops.fused_trajectory import PhiloxStream, make_fused_grahmc_step
        fused = make_fused_grahmc_step(value_and_grad_fn, num_steps, schedule)
        stream = PhiloxStream.from_generator(generator, device)

        def step(s, step_size, gamma):
            return fused(stream, s, step_size, gamma, fixed_steepness, inv_mass_matrix)
    else:
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

        def step(s, step_size, gamma):
            return grahmc_step(generator, s, vag, step_size, num_steps, gamma,
                               fixed_steepness, inv_mass_matrix, schedule)

    init_step = current_step_size if current_step_size is not None else 0.5 / d ** 0.5
    da = joint_da_init(torch.tensor([init_step, 1.0], dtype=e_dtype, device=device))
    bars, rates = [], []
    for _ in range(max_iter):
        params = torch.exp(da.log_params)
        step_size, gamma = params[0], torch.clamp(params[1], 0.001, 50.0)
        accepts = []
        for _ in range(n_samples_per_tune):
            state, (accept, *_r) = step(state, step_size, gamma)
            accepts.append(accept)
        acc = torch.stack(accepts).to(torch.float32).mean()
        da = joint_da_update(da, acc, target_accept)
        bars.append(torch.exp(da.log_params_bar))
        rates.append(acc)
    bars = torch.stack(bars).tolist()
    history = {"step_size": [b[0] for b in bars], "gamma": [b[1] for b in bars],
               "accept_rate": torch.stack(rates).tolist()}
    final = torch.exp(da.log_params_bar).tolist()
    return float(final[0]), float(final[1]), fixed_steepness, history
