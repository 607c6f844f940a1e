"""Sequential GRAHMC friction tuning: DA step-size phase + ESJD gamma search
(port of ``mcmc_tpu/tuning/sequential.py``).

1. Phase 1 tunes the step size by dual averaging at a conservative
   gamma = 0.5 (step size and friction move the acceptance in opposite
   directions, so one acceptance signal cannot tune both).
2. Phase 2 takes each gamma of the grid from the phase-1 end state:
   re-tunes the step by DA from the phase-1 step (``max_iter_step``
   transitions in batches of ``da_batch``), then measures
       ESJD = E[min(1, e^{-dH}) ||q_proposal - q_pre||^2]
   over ``gamma_samples_per_eval`` transitions. The largest ESJD wins, with
   its re-tuned step.
3. The steepness stays at the schedule's default.

The DA state and the statistics stay on the device; the host reads each
gamma's three numbers and, once, phase 1's accept history. Backends: "eager"
(``grahmc_step`` with the run's generator) and "fused" (kernel 1, or 1a for
a dense metric, which exports the proposal ESJD needs; one Philox stream per
evaluation drawn from the generator, the metric factored once).

With a chain mesh each rank tunes on its block of the chains with the run
generator folded by its rank, and every statistic fed back (each DA batch's
accept, the ESJD and its accept) is the mean over all ranks' chains
(`_gmean`, the JAX package's), so every rank selects the same gamma and step.
"""

import math
from typing import Dict, Optional, Tuple

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import init_chain_state, make_value_and_grad
from mcmc_tpu_torch.samplers.grahmc import (default_steepness,
                                            get_friction_schedule, grahmc_step)
from mcmc_tpu_torch.tuning.dual_averaging import (da_final_step_size, da_init,
                                                  da_step_size, da_update)

DEFAULT_GAMMA_GRID = (0.01, 0.1, 0.5, 1.0, 2.0, 5.0)
CONSERVATIVE_GAMMA = 0.5


def accept_rate(accepts) -> torch.Tensor:
    """The mean of a list of (C,) accept flags, in float32: the JAX
    package's mean of booleans is float32 even under x64, and its dual
    averaging takes `target_accept - rate` in that dtype."""
    return torch.stack(accepts).to(torch.float32).mean()


def _gmean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean over every chain: over a chain mesh's ranks too (equal
    shards make the mean of the ranks' means the global mean)."""
    m = torch.mean(x)
    if mesh is None:
        return m
    from mcmc_tpu_torch.parallel import pmean
    return pmean(m, mesh)


def sequential_tune_grahmc(
    generator: torch.Generator,
    log_prob_fn,
    grad_log_prob_fn,              # API parity; analytic grads via value_and_grad_fn
    init_position: torch.Tensor,
    num_steps: int,
    schedule_type: str = "constant",
    target_accept: float = 0.65,
    max_iter_step: int = 1000,
    inv_mass_matrix: Optional[torch.Tensor] = None,
    init_step_size: Optional[float] = None,
    gamma_coarse_values=None,
    gamma_samples_per_eval: int = 150,
    value_and_grad_fn=None,
    steepness: Optional[float] = None,
    da_batch: int = 25,
    verbose: bool = False,
    backend: str = "eager",
    mesh=None,
) -> Tuple[float, float, float, Dict]:
    """Returns (step_size, gamma, steepness, history). `generator` lives on
    the positions' device; the DA state and ESJD take the energy dtype of
    the positions, the accept rates float32 (accept_rate). mesh: a chain
    mesh over which init_position (global, the same on every rank) is
    sharded; the results are the same on every rank."""
    if mesh is not None:
        from mcmc_tpu_torch.parallel import rank_generator, shard_chains
        init_position = shard_chains(init_position, mesh)
        generator = rank_generator(generator, mesh)

    if gamma_coarse_values is None:
        gamma_coarse_values = DEFAULT_GAMMA_GRID
    if steepness is None:
        steepness = default_steepness(schedule_type)
    schedule_fn = get_friction_schedule(schedule_type)

    state = init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                             needs_grad=True)
    pos = state.position
    n_dim = pos.shape[1]
    dtype = precision.energy_dtype(pos.dtype)
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(n_dim, dtype=pos.dtype, device=pos.device)
    inv_mass_matrix = inv_mass_matrix.to(pos.dtype)
    if init_step_size is None:
        init_step_size = 0.5 / math.sqrt(n_dim)

    if backend == "fused":
        from mcmc_tpu_torch.ops.fused_trajectory import (
            PhiloxStream, make_fused_grahmc_step, prepare_dense_metric)
        fused = make_fused_grahmc_step(value_and_grad_fn, num_steps, schedule_fn)
        metric = (prepare_dense_metric(inv_mass_matrix)
                  if inv_mass_matrix.ndim == 2 else inv_mass_matrix)

        def make_transition():
            stream = PhiloxStream.from_generator(generator, pos.device)
            return lambda s, step_size, gamma: fused(stream, s, step_size, gamma,
                                                     steepness, metric)
    elif backend == "eager":
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

        def make_transition():
            return lambda s, step_size, gamma: grahmc_step(
                generator, s, vag, step_size, num_steps, gamma, steepness,
                inv_mass_matrix, schedule_fn)
    else:
        raise ValueError(f"unknown backend {backend!r}; use 'eager' or 'fused'")

    n_da_updates = max(1, max_iter_step // da_batch)

    def tune_and_measure(chain_state, gamma, start_step):
        """DA-tune the step at `gamma`, then measure ESJD at the tuned step.
        Returns (state, tuned step, ESJD, ESJD-phase accept, DA accept
        statistics), all device tensors."""
        transition = make_transition()
        da = da_init(start_step, dtype, pos.device)
        da_accepts = []
        for _ in range(n_da_updates):
            step_size = da_step_size(da)
            accepts = []
            for _ in range(da_batch):
                chain_state, (accept, *_r) = transition(chain_state, step_size, gamma)
                accepts.append(accept)
            stat = _gmean(accept_rate(accepts), mesh)
            da = da_update(da, stat, target_accept)
            da_accepts.append(stat)
        tuned_step = da_final_step_size(da)

        esjd_steps, esjd_accepts = [], []
        for _ in range(gamma_samples_per_eval):
            pre_q = chain_state.position
            chain_state, (accept, prop_q, _prop_lp, delta_h) = transition(
                chain_state, tuned_step, gamma)
            alpha = torch.exp(torch.clamp(-delta_h, max=0.0))
            jump_sq = torch.sum((prop_q - pre_q) ** 2, dim=-1)
            esjd_steps.append(alpha * jump_sq)
            esjd_accepts.append(accept)
        return (chain_state, tuned_step, _gmean(torch.stack(esjd_steps).to(dtype), mesh),
                _gmean(accept_rate(esjd_accepts), mesh), da_accepts)

    # Phase 1: conservative-gamma step tune (each gamma's DA warm start)
    state, base_step, _, _, da_accepts = tune_and_measure(
        state, CONSERVATIVE_GAMMA, init_step_size)
    history = {"gamma_grid": list(gamma_coarse_values), "esjd": [],
               "accept": [], "per_gamma_step": [],
               "da_accept_history": torch.stack(da_accepts).tolist()}
    if verbose:
        print(f"    [sequential] phase 1: step={float(base_step):.5f} "
              f"(accept {history['da_accept_history'][-1]:.3f} at "
              f"gamma={CONSERVATIVE_GAMMA})")

    # Phase 2: per-gamma step re-tune + ESJD measurement, each from the
    # phase-1 end state
    best = None  # (esjd, gamma, step)
    for g in gamma_coarse_values:
        _, step_g, esjd, acc, _ = tune_and_measure(state, g, base_step)
        esjd_f, acc_f, step_f = torch.stack([esjd, acc.to(dtype), step_g]).tolist()
        history["esjd"].append(esjd_f)
        history["accept"].append(acc_f)
        history["per_gamma_step"].append(step_f)
        if verbose:
            print(f"    [sequential] gamma={g}: step={step_f:.4f} "
                  f"ESJD={esjd_f:.4f} accept={acc_f:.3f}")
        if best is None or esjd_f > best[0]:
            best = (esjd_f, g, step_f)

    _, best_gamma, best_step = best
    history["selected_gamma"] = best_gamma
    history["step_size"] = best_step
    return float(best_step), float(best_gamma), float(steepness), history
