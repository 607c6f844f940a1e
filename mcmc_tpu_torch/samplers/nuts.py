"""No-U-Turn Sampler with iterative tree doubling (port of
``mcmc_tpu/samplers/nuts.py``), in plain batched PyTorch: the JAX package
writes it in ``jnp``/``lax`` under ``vmap`` with no Pallas kernel.

The reference's simplifications are kept, because they shape the sampled
posterior:

- iterative doubling, a random +/-1 direction per subtree;
- subtree validity checked only at the subtree ENDPOINT; a valid endpoint
  counts the whole 2^depth subtree as valid states;
- acceptance statistic alpha = exp(min(0, h0 - h)) accumulated over ALL
  integration steps; a NaN mean falls back to 0.65;
- slice variable log u = log U(0, 1) - h0; divergence when h - h0 >
  delta_max (default 1000);
- U-turn when (q_right - q_left) . p_left < 0 or . p_right < 0, on raw
  momenta for both metrics.

The JAX package's vmapped ``lax.while_loop`` runs every chain until the last
one stops, ``jnp.where`` freezing the finished ones. The port does the same
on the (C, D) batch: a live mask over the depth loop, each subtree's 2^depth
leapfrogs run on the whole batch and kept only for the live chains. The
host reads one bool per depth (whether any chain is live), never one per
leapfrog.

The randomness of a transition (momentum, slice uniform, and per depth a
direction bit and a swap uniform) is drawn up front (``draw_nuts``) or
injected (``NUTSDraws``), so tests can replay the JAX package's key splits.
"""

from typing import Callable, NamedTuple, Optional

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import (ChainState, RunResult, finalize_run,
                                          init_chain_state, make_value_and_grad,
                                          run_sampler)
from mcmc_tpu_torch.samplers.trajectory import (as_scalar, kinetic_energy,
                                                sample_momentum, velocity)

Tensor = torch.Tensor

NAN_ACCEPT_FALLBACK = 0.65


class NUTSDraws(NamedTuple):
    """One transition's randomness for every chain: the momentum p0 (C, D)
    (already drawn from N(0, M)), the slice uniforms (C,) in the energy
    dtype, and per depth d the direction bits dirs[d] (C,) bool (True:
    right) and the proposal-swap uniforms swaps[d] (C,) float32 (the JAX
    package's default uniform), (max_tree_depth, C) each."""
    p0: Tensor
    slice_u: Tensor
    dirs: Tensor
    swaps: Tensor


def draw_nuts(generator: torch.Generator, n_chains: int, dim: int, inv_mass: Tensor,
              pos_dtype: torch.dtype, max_tree_depth: int) -> NUTSDraws:
    """A transition's NUTSDraws from `generator` (on the chains' device)."""
    kw = dict(generator=generator, device=generator.device)
    p0 = sample_momentum(generator, (n_chains, dim), inv_mass, pos_dtype)
    slice_u = torch.rand(n_chains, dtype=precision.energy_dtype(pos_dtype), **kw)
    dirs = torch.rand((max_tree_depth, n_chains), **kw) < 0.5
    swaps = torch.rand((max_tree_depth, n_chains), **kw)
    return NUTSDraws(p0, slice_u, dirs, swaps)


def _energy(lp: Tensor, p: Tensor, inv_mass: Tensor) -> Tensor:
    """H = -lp + p^T M^{-1} p / 2 per chain, in the energy dtype."""
    e_dtype = precision.energy_dtype(p.dtype)
    return -lp.to(e_dtype) + kinetic_energy(p, inv_mass).to(e_dtype)


def _single_leapfrog(q, p, grad, signed_eps, value_and_grad, inv_mass):
    """One leapfrog of every chain; signed_eps is a (C, 1) (or scalar)
    step with the chain's direction. Returns (q, p, lp, grad)."""
    p = p + 0.5 * signed_eps * grad
    q = q + signed_eps * velocity(p, inv_mass)
    lp, grad = value_and_grad(q)
    grad = grad.to(q.dtype)
    p = p + 0.5 * signed_eps * grad
    return q, p, lp.to(precision.energy_dtype(q.dtype)), grad


def _integrate_subtree(q, p, grad, direction, eps, num_steps: int, value_and_grad,
                       h0, inv_mass):
    """num_steps = 2^depth leapfrogs in each chain's direction (C,),
    accumulating sum-alpha. Returns (q, p, lp, grad, sum_alpha)."""
    signed_eps = (direction * eps)[:, None]
    s_alpha = torch.zeros_like(h0)
    lp = torch.zeros_like(h0)           # overwritten at the first step
    for _ in range(num_steps):
        q, p, lp, grad = _single_leapfrog(q, p, grad, signed_eps, value_and_grad, inv_mass)
        h = _energy(lp, p, inv_mass)
        s_alpha = s_alpha + torch.exp(torch.clamp(h0 - h, max=0.0))
    return q, p, lp, grad, s_alpha


def _u_turn(q_left, q_right, p_left, p_right) -> Tensor:
    """The reference's raw-momentum U-turn test at the endpoints,
    (q_r - q_l) . p < 0 at either end, per chain (both metrics: see the JAX
    function's docstring)."""
    dq = q_right - q_left
    return (torch.sum(dq * p_left, dim=-1) < 0) | (torch.sum(dq * p_right, dim=-1) < 0)


def _nuts_chain_step(draws: NUTSDraws, q, lp, grad, value_and_grad, step_size,
                     max_tree_depth: int, delta_max, inv_mass):
    """One NUTS transition of every chain (the JAX function's vmapped over
    the chains). Returns (q', lp', grad', tree_depth (C,) int32,
    mean_accept_prob, diverged)."""
    pos_dtype = q.dtype
    e_dtype = precision.energy_dtype(pos_dtype)
    n_chains = q.shape[0]
    eps = as_scalar(step_size, pos_dtype, q.device)
    lp = lp.to(e_dtype)
    p0 = draws.p0.to(pos_dtype)
    h0 = _energy(lp, p0, inv_mass)
    log_u = torch.log(draws.slice_u.to(e_dtype)) - h0

    q_l, p_l, g_l = q, p0, grad
    q_r, p_r, g_r = q, p0, grad
    q_prop, lp_prop, g_prop = q, lp, grad
    zeros_i = torch.zeros(n_chains, dtype=torch.int32, device=q.device)
    n_valid = zeros_i + 1
    n_steps = zeros_i
    depth = zeros_i
    sum_alpha = torch.zeros_like(h0)
    diverged = torch.zeros(n_chains, dtype=torch.bool, device=q.device)

    for d in range(max_tree_depth):
        live = ~_u_turn(q_l, q_r, p_l, p_r) & ~diverged
        if d > 0 and not bool(live.any()):      # the one host read per depth
            break
        go_right = draws.dirs[d]
        direction = torch.where(go_right, 1.0, -1.0).to(pos_dtype)
        right = go_right[:, None]
        q_start = torch.where(right, q_r, q_l)
        p_start = torch.where(right, p_r, p_l)
        g_start = torch.where(right, g_r, g_l)
        num_steps = 2 ** d
        q_new, p_new, lp_new, g_new, sub_alpha = _integrate_subtree(
            q_start, p_start, g_start, direction, eps, num_steps, value_and_grad, h0, inv_mass)

        h_new = _energy(lp_new, p_new, inv_mass)
        is_divergent = (h_new - h0) > delta_max
        is_valid = (log_u <= -h_new) & ~is_divergent

        left_live = (live & ~go_right)[:, None]
        right_live = (live & go_right)[:, None]
        q_l = torch.where(left_live, q_new, q_l)
        p_l = torch.where(left_live, p_new, p_l)
        g_l = torch.where(left_live, g_new, g_l)
        q_r = torch.where(right_live, q_new, q_r)
        p_r = torch.where(right_live, p_new, p_r)
        g_r = torch.where(right_live, g_new, g_r)

        # endpoint-validity scheme: a valid endpoint counts the whole subtree
        n_valid_new = torch.where(is_valid, num_steps, 0).to(torch.int32)
        total_valid = n_valid + n_valid_new
        swap_prob = torch.where(
            is_valid & (total_valid > 0),
            n_valid_new.to(torch.float32) / torch.clamp(total_valid, min=1).to(torch.float32),
            0.0)
        take_new = live & (draws.swaps[d] < swap_prob)
        q_prop = torch.where(take_new[:, None], q_new, q_prop)
        lp_prop = torch.where(take_new, lp_new, lp_prop)
        g_prop = torch.where(take_new[:, None], g_new, g_prop)
        n_valid = torch.where(live, total_valid, n_valid)
        sum_alpha = torch.where(live, sum_alpha + sub_alpha, sum_alpha)
        n_steps = torch.where(live, n_steps + num_steps, n_steps)
        depth = torch.where(live, depth + 1, depth)
        diverged = diverged | (live & is_divergent)

    mean_alpha = sum_alpha / torch.clamp(n_steps, min=1).to(e_dtype)
    mean_alpha = torch.where(torch.isfinite(mean_alpha), mean_alpha,
                             torch.full_like(mean_alpha, NAN_ACCEPT_FALLBACK))
    return q_prop, lp_prop, g_prop, depth, mean_alpha, diverged


def nuts_init(init_position, log_prob_fn, value_and_grad_fn=None) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                            needs_grad=True)


def nuts_step(generator: Optional[torch.Generator], state: ChainState, value_and_grad,
              step_size, inv_mass_matrix: Tensor, max_tree_depth: int = 10,
              delta_max=1000.0, draws: Optional[NUTSDraws] = None):
    """One NUTS transition of every chain, its randomness from `generator`
    (on the chains' device) or `draws`. value_and_grad is batched: (C, D)
    -> (lp (C,), grad (C, D)). Returns (new_state, (depths,
    mean_accept_probs))."""
    q = state.position
    if draws is None:
        draws = draw_nuts(generator, q.shape[0], q.shape[1], inv_mass_matrix, q.dtype,
                          max_tree_depth)
    q, lp, grad, depths, mean_alpha, diverged = _nuts_chain_step(
        draws, q, state.log_prob, state.grad_log_prob, value_and_grad, step_size,
        max_tree_depth, delta_max, inv_mass_matrix)
    new_state = state._replace(
        position=q,
        log_prob=lp.to(state.log_prob.dtype),
        grad_log_prob=grad,
        accept_count=state.accept_count + 1,   # NUTS always moves via slice sampling
        divergence_count=state.divergence_count + diverged.to(torch.int32),
    )
    return new_state, (depths, mean_alpha)


def nuts_run(
    generator: torch.Generator,
    log_prob_fn,
    init_position: Tensor,
    step_size,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Tensor] = None,
    max_tree_depth: int = 10,
    delta_max=1000.0,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
) -> RunResult:
    """Run classic NUTS chains. info carries tree_depths and
    mean_accept_probs (num_samples, n_chains) plus divergence stats.
    inv_mass_matrix: None (unit), (D,) or (D, D). `generator` lives on the
    positions' device; the step size may be a device tensor."""
    state = nuts_init(init_position, log_prob_fn, value_and_grad_fn)
    n_dim = state.position.shape[1]
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(n_dim, dtype=state.position.dtype,
                                     device=state.position.device)
    inv_mass_matrix = inv_mass_matrix.to(device=state.position.device,
                                         dtype=state.position.dtype)
    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    def step(s):
        return nuts_step(generator, s, vag, step_size, inv_mass_matrix, max_tree_depth,
                         delta_max)

    def extras_fn(s_prev, s, step_extras):
        return step_extras          # (depths, mean_alpha)

    state, samples, log_probs, extras = run_sampler(step, state, num_samples, burn_in,
                                                    collect_chains, extras_fn)
    depths, mean_alpha = extras
    return finalize_run(state, samples, log_probs, num_samples,
                        {"tree_depths": depths, "mean_accept_probs": mean_alpha})
