"""Random-Walk Metropolis-Hastings (port of ``mcmc_tpu/samplers/rwmh.py``).

Gaussian proposal x' = x + scale * eps, MH test log u < min(0, dlogp),
burn-in with counter reset. ``backend="eager"`` is the counterpart of the
JAX package's "xla": one (n_chains, n_dim) step per transition in plain
PyTorch. ``backend="fused"`` is the counterpart of "pallas": T transitions
per call of the hand-written CUDA kernel of ``mcmc_tpu_torch.ops.fused_rwmh``
on a GPU (its plain PyTorch version on the CPU).

``rwmh_step`` is split in two, as ``grahmc_step`` is: the draw of the
randomness, then the pure ``rwmh_transition(state, noise, u, ...)``, so tests
can inject the JAX package's draws.
"""

from typing import Callable, Optional

import torch

from mcmc_tpu_torch.samplers.base import (ChainState, RunResult, finalize_run,
                                          init_chain_state,
                                          run_multistep_sampler, run_sampler)
from mcmc_tpu_torch.samplers.trajectory import as_scalar

Tensor = torch.Tensor

# Transitions per fused kernel call, largest first: RWMH transitions are
# cheap, so a deep call amortizes the launch and the harness's per-call work.
FUSED_TRANSITIONS = (32, 16, 8, 4, 2, 1)


def rwmh_init(init_position, log_prob_fn) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, needs_grad=False)


def rwmh_transition(state: ChainState, noise: Tensor, u: Tensor,
                    log_prob_fn: Callable, scale):
    """One RWMH transition from the given proposal noise (n_chains, n_dim)
    and accept uniforms u (n_chains,). Returns (new_state, accept)."""
    pos_dtype = state.position.dtype
    e_dtype = state.log_prob.dtype
    proposal = state.position + as_scalar(scale, pos_dtype,
                                          state.position.device) * noise
    proposal_lp = log_prob_fn(proposal).to(e_dtype)
    accept = torch.log(u) < torch.clamp(proposal_lp - state.log_prob, max=0.0)
    new_state = state._replace(
        position=torch.where(accept[:, None], proposal, state.position),
        log_prob=torch.where(accept, proposal_lp, state.log_prob),
        accept_count=state.accept_count + accept.to(torch.int32),
    )
    return new_state, accept


def rwmh_step(generator: torch.Generator, state: ChainState, log_prob_fn,
              scale):
    """Draw the proposal noise then the accept uniforms from `generator` (on
    the state's device) and run rwmh_transition."""
    noise = torch.randn(state.position.shape, generator=generator,
                        device=generator.device, dtype=state.position.dtype)
    u = torch.rand(state.position.shape[0], generator=generator,
                   device=generator.device, dtype=state.log_prob.dtype)
    return rwmh_transition(state, noise, u, log_prob_fn, scale)


def rwmh_run(
    generator: torch.Generator,
    log_prob_fn,
    init_position: Tensor,
    num_samples: int,
    scale,
    burn_in: int = 0,
    collect_chains: Optional[int] = None,
    value_and_grad_fn: Optional[Callable] = None,
    backend: str = "eager",
) -> RunResult:
    """Run RWMH chains. Returns RunResult (see samplers.base).

    backend="fused" runs T MH transitions per kernel 3 call, T the largest
    of FUSED_TRANSITIONS dividing both num_samples and burn_in, with the
    chain state on chip; the kernel writes the history of the first
    `collect_chains` chains only. It needs a `value_and_grad_fn` tagged by
    mcmc_tpu_torch.targets (only its log-density runs) and raises TypeError
    without one -- the JAX package falls back to its scan there instead; the
    port never swaps the path a caller asked for. `generator` must live on
    the positions' device; the fused backend draws its two Philox key words
    from it once per run.
    """
    state = rwmh_init(init_position, log_prob_fn)
    if backend == "fused":
        from mcmc_tpu_torch.ops.fused_rwmh import (make_fused_rwmh_multistep,
                                                   rwmh_scale)
        from mcmc_tpu_torch.ops.fused_trajectory import PhiloxStream
        if value_and_grad_fn is None:
            raise TypeError("the fused backend requires an analytic "
                            "value_and_grad_fn from mcmc_tpu_torch.targets")
        trans_per_call = next(t for t in FUSED_TRANSITIONS
                              if num_samples % t == 0 and burn_in % t == 0)
        multi = make_fused_rwmh_multistep(value_and_grad_fn, trans_per_call,
                                          n_hist=collect_chains)
        stream = PhiloxStream.from_generator(generator, state.position.device)
        scale_t = rwmh_scale(scale, state.position.device)

        def multi_step(s):
            s, (_acc, hist_q, hist_lp) = multi(stream, s, scale_t)
            return s, (hist_q, hist_lp)
        return run_multistep_sampler(multi_step, state, num_samples, burn_in,
                                     trans_per_call, collect_chains)
    if backend != "eager":
        raise ValueError(f"unknown backend {backend!r}; use 'eager' or 'fused'")

    def step(s):
        return rwmh_step(generator, s, log_prob_fn, scale)

    state, samples, log_probs, _ = run_sampler(step, state, num_samples,
                                               burn_in, collect_chains)
    return finalize_run(state, samples, log_probs, num_samples)
