"""Shared sampler infrastructure: chain state, target adapters, run harness
(port of ``mcmc_tpu/samplers/base.py``).

Layouts are the JAX package's: positions (n_chains, n_dim), histories
(num_samples, n_collect, n_dim), log-probs (num_samples, n_collect),
accept_rate (n_chains,) float32. Log-probs are in the energy dtype, which
follows the position dtype (``mcmc_tpu_torch.precision``).

The JAX ``lax.scan`` loops become Python loops that write into preallocated
history tensors; no loop reads a value back to the host, so on a GPU every
step is queued without waiting for the previous one.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from mcmc_tpu_torch import precision

Tensor = torch.Tensor


class ChainState(NamedTuple):
    """State shared by every sampler.

    position:         (n_chains, n_dim) position dtype
    log_prob:         (n_chains,)       energy dtype
    grad_log_prob:    (n_chains, n_dim) position dtype
    accept_count:     (n_chains,)       int32
    divergence_count: (n_chains,)       int32 — |dH| > 1000 transitions
    """
    position: Tensor
    log_prob: Tensor
    grad_log_prob: Tensor
    accept_count: Tensor
    divergence_count: Tensor


class RunResult(NamedTuple):
    """Uniform sampler-run output.

    samples:     (num_samples, n_collect, n_dim)
    log_probs:   (num_samples, n_collect)
    accept_rate: (n_chains,) float32
    final_state: ChainState
    info:        dict of extras (divergence counts, proposals, ...)
    """
    samples: Tensor
    log_probs: Tensor
    accept_rate: Tensor
    final_state: ChainState
    info: Dict[str, Any]


def ensure_batched(x: Tensor) -> Tensor:
    """(n_dim,) -> (1, n_dim); (n_chains, n_dim) unchanged."""
    if x.ndim == 1:
        return x[None, :]
    if x.ndim == 2:
        return x
    raise ValueError("Input must have shape (n_dim,) or (n_chains, n_dim).")


def make_value_and_grad(log_prob_fn: Callable,
                        value_and_grad_fn: Optional[Callable] = None) -> Callable:
    """Batched (C, D) -> (lp (C,), grad (C, D)) target adapter.

    Prefers the target's analytic gradient; falls back to autograd of the
    summed log-prob (chains are independent, so d(sum lp)/dq is each chain's
    own gradient)."""
    if value_and_grad_fn is not None:
        return value_and_grad_fn

    def vag(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lp = log_prob_fn(x)
            (grad,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), grad
    return vag


def init_chain_state(init_position: Tensor, log_prob_fn: Callable,
                     value_and_grad_fn: Optional[Callable] = None,
                     needs_grad: bool = True) -> ChainState:
    """Evaluate the target at the initial positions and build ChainState."""
    pos = ensure_batched(init_position)
    n_chains = pos.shape[0]
    e_dtype = precision.energy_dtype(pos.dtype)
    if needs_grad:
        lp, grad = make_value_and_grad(log_prob_fn, value_and_grad_fn)(pos)
        grad = grad.to(pos.dtype)
    else:
        lp = log_prob_fn(pos)
        grad = torch.zeros_like(pos)
    return ChainState(
        position=pos,
        log_prob=lp.to(e_dtype),
        grad_log_prob=grad,
        accept_count=torch.zeros(n_chains, dtype=torch.int32, device=pos.device),
        divergence_count=torch.zeros(n_chains, dtype=torch.int32,
                                     device=pos.device),
    )


def reset_counters(state: ChainState) -> ChainState:
    return state._replace(
        accept_count=torch.zeros_like(state.accept_count),
        divergence_count=torch.zeros_like(state.divergence_count),
    )


def run_sampler(step_fn: Callable, state: ChainState, num_samples: int,
                burn_in: int = 0, collect_chains: Optional[int] = None,
                extras_fn: Optional[Callable] = None):
    """Generic burn-in + sampling harness.

    step_fn: state -> (state, step_extras); it owns its randomness (a
        torch.Generator or a kernel counter stream).
    extras_fn: optional (prev_state, new_state, step_extras) -> tuple of
        tensors collected per step.
    collect_chains: store history only for the first k chains (None = all).

    Returns (final_state, samples, log_probs, stacked_extras).
    """
    for _ in range(burn_in):
        state, _ = step_fn(state)
    if burn_in > 0:
        state = reset_counters(state)

    n_collect = state.position.shape[0] if collect_chains is None else collect_chains
    samples = state.position.new_empty((num_samples, n_collect,
                                        state.position.shape[1]))
    log_probs = state.log_prob.new_empty((num_samples, n_collect))
    extras = None
    for i in range(num_samples):
        prev = state
        state, step_extras = step_fn(prev)
        samples[i] = state.position[:n_collect]
        log_probs[i] = state.log_prob[:n_collect]
        if extras_fn is not None:
            out = extras_fn(prev, state, step_extras)
            if extras is None:
                extras = tuple(t.new_empty((num_samples,) + t.shape) for t in out)
            for buf, t in zip(extras, out):
                buf[i] = t
    return state, samples, log_probs, extras


def run_multistep_sampler(multi_step: Callable, state: ChainState,
                          num_samples: int, burn_in: int, trans_per_call: int,
                          collect_chains: Optional[int] = None) -> RunResult:
    """Burn-in + sampling harness for multi-transition kernels.

    multi_step: state -> (state, (hist_q (T, C, D), hist_lp (T, C))) advancing
    `trans_per_call` transitions per call; the histories land in the same
    (num_samples, n_collect, dim) layout `run_sampler` produces.
    """
    for _ in range(burn_in // trans_per_call):
        state, _ = multi_step(state)
    if burn_in > 0:
        state = reset_counters(state)

    n_collect = state.position.shape[0] if collect_chains is None else collect_chains
    samples = state.position.new_empty((num_samples, n_collect,
                                        state.position.shape[1]))
    log_probs = state.log_prob.new_empty((num_samples, n_collect))
    for i in range(num_samples // trans_per_call):
        state, (hist_q, hist_lp) = multi_step(state)
        rows = slice(i * trans_per_call, (i + 1) * trans_per_call)
        samples[rows] = hist_q[:, :n_collect]
        log_probs[rows] = hist_lp[:, :n_collect]
    return finalize_run(state, samples, log_probs, num_samples)


def finalize_run(state: ChainState, samples, log_probs, num_samples: int,
                 extra_info: Optional[Dict] = None) -> RunResult:
    """Build the uniform RunResult with accept/divergence rates."""
    accept_rate = state.accept_count.to(torch.float32) / num_samples
    n_chains = state.position.shape[0]
    total = torch.sum(state.divergence_count)
    info = {
        "divergence_count": state.divergence_count,
        "total_divergences": total,
        "divergence_rate": total.to(torch.float32) / (num_samples * n_chains),
    }
    if extra_info:
        info.update(extra_info)
    return RunResult(samples, log_probs, accept_rate, state, info)
