"""GRAHMC: Generalized Repelling-Attracting HMC with time-varying friction
(port of ``mcmc_tpu/samplers/grahmc.py``).

Conformal leapfrog with one of five gamma(t) schedules running from -gamma
(repelling) to +gamma (attracting), momentum flip, non-finite-Hamiltonian
reject guard, MH test, burn-in counter reset and optional proposal tracking.

``grahmc_step`` is split in two: the draw of the randomness, then the pure
``grahmc_transition(state, p0, u, ...)``, so tests can inject the JAX
package's draws.
"""

import math
from typing import Callable, Dict, Optional

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import (
    ChainState, RunResult, finalize_run, init_chain_state, make_value_and_grad,
    run_multistep_sampler, run_sampler,
)
from mcmc_tpu_torch.samplers.trajectory import (integrate_trajectory,
                                                kinetic_energy,
                                                sample_momentum)

Tensor = torch.Tensor

DIVERGENCE_DELTA_H = 1000.0

# Largest chain count at which the fused backend runs the multi-transition
# kernel (the JAX package's measured threshold; `grahmc.py:211-215` there).
MULTISTEP_MAX_CHAINS = 4096

# ============================================================================
# Friction schedules gamma(t): -gamma_max -> +gamma_max over the trajectory.
# Signature (t, T, gamma_max, steepness) on tensors.
# ============================================================================


def constant_schedule(t, T, gamma, steepness=None):
    """Original RAHMC step schedule: -gamma for t < T/2, +gamma after, and
    exactly 0 AT T/2 (an odd-length trajectory's middle substep)."""
    return torch.where(t < T / 2, -gamma,
                       torch.where(t > T / 2, gamma, torch.zeros_like(gamma)))


def tanh_schedule(t, T, gamma_max, steepness=5.0):
    """Smooth tanh transition; steepness controls the switch sharpness."""
    return gamma_max * torch.tanh(steepness * (2.0 * t / T - 1.0))


def sigmoid_schedule(t, T, gamma_max, steepness=10.0):
    """Sigmoid transition mapped to (-gamma_max, +gamma_max)."""
    z = steepness * (t / T - 0.5)
    return gamma_max * (2.0 / (1.0 + torch.exp(-z)) - 1.0)


def linear_schedule(t, T, gamma_max, steepness=None):
    """Linear ramp."""
    return gamma_max * (2.0 * t / T - 1.0)


def sine_schedule(t, T, gamma_max, steepness=None):
    """Sinusoidal ramp."""
    return gamma_max * torch.sin(math.pi * (t / T - 0.5))


FRICTION_SCHEDULES: Dict[str, Callable] = {
    "constant": constant_schedule,
    "tanh": tanh_schedule,
    "sigmoid": sigmoid_schedule,
    "linear": linear_schedule,
    "sine": sine_schedule,
}


def get_friction_schedule(schedule_type: str) -> Callable:
    return FRICTION_SCHEDULES[schedule_type]


# Sentinel: run the trajectory with NO friction at all (the HMC path: the
# exp/multiply substeps are skipped, unlike a zero-valued gamma).
NO_FRICTION = "no_friction"


def default_steepness(schedule_type: str) -> float:
    return 0.5 if schedule_type == "tanh" else 2.0


# ============================================================================
# Sampler
# ============================================================================

def grahmc_init(init_position, log_prob_fn, value_and_grad_fn=None) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                            needs_grad=True)


def grahmc_transition(state: ChainState, p0: Tensor, u: Tensor,
                      value_and_grad: Callable, step_size, num_steps: int,
                      gamma, steepness, inv_mass_matrix: Tensor,
                      friction_schedule: Optional[Callable] = None):
    """One GRAHMC (HMC when friction_schedule is None) MH transition from the
    given momentum p0 (n_chains, n_dim) and accept uniforms u (n_chains,).

    Returns (new_state, (accept, proposal_q, proposal_lp, delta_H)).
    """
    e_dtype = state.log_prob.dtype
    h0 = -state.log_prob + kinetic_energy(p0, inv_mass_matrix).to(e_dtype)
    q, p, lp, grad = integrate_trajectory(
        state.position, p0, state.log_prob, state.grad_log_prob,
        value_and_grad, step_size, num_steps, inv_mass_matrix,
        friction_schedule=friction_schedule, gamma_max=gamma,
        steepness=steepness)
    p = -p  # momentum flip for reversibility
    h1 = precision.guard_energy(
        -lp + kinetic_energy(p, inv_mass_matrix).to(e_dtype))

    log_alpha = h0 - h1
    delta_h = h1 - h0
    divergent = torch.abs(delta_h) > DIVERGENCE_DELTA_H
    accept = torch.log(u) < torch.clamp(log_alpha, max=0.0)

    new_state = state._replace(
        position=torch.where(accept[:, None], q, state.position),
        log_prob=torch.where(accept, lp, state.log_prob),
        grad_log_prob=torch.where(accept[:, None], grad, state.grad_log_prob),
        accept_count=state.accept_count + accept.to(torch.int32),
        divergence_count=state.divergence_count + divergent.to(torch.int32),
    )
    return new_state, (accept, q, lp, delta_h)


def grahmc_step(generator: torch.Generator, state: ChainState, value_and_grad,
                step_size, num_steps: int, gamma, steepness,
                inv_mass_matrix: Tensor,
                friction_schedule: Optional[Callable] = None):
    """Draw momentum then the accept uniforms from `generator` (on the
    state's device) and run grahmc_transition."""
    n_chains = state.position.shape[0]
    p0 = sample_momentum(generator, state.position.shape, inv_mass_matrix,
                         state.position.dtype)
    u = torch.rand(n_chains, generator=generator, device=generator.device,
                   dtype=state.log_prob.dtype)
    return grahmc_transition(state, p0, u, value_and_grad, step_size,
                             num_steps, gamma, steepness, inv_mass_matrix,
                             friction_schedule)


def grahmc_run(
    generator: torch.Generator,
    log_prob_fn,
    init_position: Tensor,
    step_size,
    num_steps: int,
    gamma,
    steepness,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Tensor] = None,
    friction_schedule=None,
    track_proposals: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "eager",
) -> RunResult:
    """Run GRAHMC chains. friction_schedule defaults to the constant (RAHMC)
    schedule; NO_FRICTION runs plain HMC. With track_proposals, info carries
    pre/proposal positions, log-probs and delta_H.

    backend="eager" is the counterpart of the JAX package's "xla": plain
    PyTorch, any log-prob, diagonal or dense metric. backend="fused" is the
    counterpart of "pallas": the hand-written CUDA kernels of
    ``mcmc_tpu_torch.ops.fused_trajectory`` on a GPU (their plain PyTorch
    version on the CPU), for tagged targets and a diagonal metric. It runs
    the multi-transition kernel when proposals are not tracked and there are
    at most MULTISTEP_MAX_CHAINS chains, with T from (8, 4, 2, 1) dividing
    both num_samples and burn_in; otherwise one kernel call per transition.
    (The JAX dispatch also requires its TPU transposed layout; that test has
    no counterpart on the GPU and is dropped.)

    `generator` must live on the positions' device. The fused backend draws
    its two Philox key words from it once per run.
    """
    if friction_schedule is None:
        friction_schedule = constant_schedule
    elif friction_schedule is NO_FRICTION:
        friction_schedule = None

    state = grahmc_init(init_position, log_prob_fn, value_and_grad_fn)
    n_chains, n_dim = state.position.shape
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(n_dim, dtype=state.position.dtype,
                                     device=state.position.device)
    inv_mass_matrix = inv_mass_matrix.to(state.position.dtype)
    steep = steepness if steepness is not None else 1.0

    if backend == "fused":
        from mcmc_tpu_torch.ops.fused_trajectory import (
            PhiloxStream, make_fused_grahmc_multistep, make_fused_grahmc_step)
        if value_and_grad_fn is None:
            raise TypeError("the fused backend requires an analytic "
                            "value_and_grad_fn from mcmc_tpu_torch.targets")
        stream = PhiloxStream.from_generator(generator, state.position.device)
        trans_per_call = 1
        if not track_proposals and n_chains <= MULTISTEP_MAX_CHAINS:
            trans_per_call = next(t for t in (8, 4, 2, 1)
                                  if num_samples % t == 0 and burn_in % t == 0)
        if trans_per_call > 1:
            multi = make_fused_grahmc_multistep(
                value_and_grad_fn, num_steps, friction_schedule, trans_per_call)

            def multi_step(s):
                s, (_acc, hist_q, hist_lp, _dh) = multi(
                    stream, s, step_size, gamma, steep, inv_mass_matrix)
                return s, (hist_q, hist_lp)
            return run_multistep_sampler(multi_step, state, num_samples,
                                         burn_in, trans_per_call,
                                         collect_chains)
        fused = make_fused_grahmc_step(value_and_grad_fn, num_steps,
                                       friction_schedule)

        def step(s):
            return fused(stream, s, step_size, gamma, steep, inv_mass_matrix)
    elif backend == "eager":
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

        def step(s):
            return grahmc_step(generator, s, vag, step_size, num_steps, gamma,
                               steep, inv_mass_matrix, friction_schedule)
    else:
        raise ValueError(f"unknown backend {backend!r}; use 'eager' or 'fused'")

    if track_proposals:
        def extras_fn(s_prev, s, step_extras):
            _accept, q, lp, dh = step_extras
            return (s_prev.position, s_prev.log_prob, q, lp, dh)
        state, samples, log_probs, extras = run_sampler(
            step, state, num_samples, burn_in, collect_chains, extras_fn)
        pre_q, pre_lp, prop_q, prop_lp, delta_h = extras
        extra_info = {
            "pre_positions": pre_q,
            "pre_log_probs": pre_lp,
            "proposal_positions": prop_q,
            "proposal_log_probs": prop_lp,
            "delta_H": delta_h,
        }
        return finalize_run(state, samples, log_probs, num_samples, extra_info)

    state, samples, log_probs, _ = run_sampler(
        step, state, num_samples, burn_in, collect_chains)
    return finalize_run(state, samples, log_probs, num_samples)
