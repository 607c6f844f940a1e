"""Parallel tempering (replica exchange) over the HMC/GRAHMC transition
(port of ``mcmc_tpu/samplers/tempered.py``).

K tempered replicas sample pi^{beta_k}, flat enough at small beta to cross
between modes, and adjacent replicas exchange configurations with the
Metropolis probability

    A = min(1, exp((beta_i - beta_j) * (logp(x_j) - logp(x_i)))),

which preserves the product measure prod_k pi^{beta_k}; the beta = 1
replica is then an exact sampler of pi with mode-hopping from the ladder.

The K x C replica-chain grid is one replica-major (K C, D) batch: row r is
replica r // C, chain r % C. Tempering enters as a (K C,) beta row scaling
the target's value and gradient, and a per-chain step-size row (eps_k =
eps / sqrt(beta_k) by default: the tempered target's curvature scales with
beta). The eager backend runs ``grahmc_step`` on that batch with a (K C, 1)
step row; the fused one runs kernel 1b (``ops/fused_trajectory.py``), ONE
launch per sweep for all K rungs, each row reading its rung's (eps_k,
beta_k) (the JAX package launches its scaled kernel once per rung). Swap
moves are where-selects between adjacent rows of the (K, C, ...) view with
alternating even/odd pairing, in plain PyTorch on the state's device, with
their uniforms drawn from the run's generator.

The state carries the TEMPERED log-prob and gradient (what the transition
needs); swaps convert through the exact per-replica betas. The emitted
samples and log-probs are the beta = 1 replica's, untempered.
"""

from typing import Callable, Optional

import numpy as np
import torch

from mcmc_tpu_torch.samplers.base import (ChainState, RunResult, init_chain_state,
                                          make_value_and_grad, reset_counters)
from mcmc_tpu_torch.samplers.grahmc import grahmc_step

Tensor = torch.Tensor


def geometric_ladder(n_temps: int, beta_min: float = 0.05, device="cuda") -> Tensor:
    """Geometrically spaced inverse temperatures 1 = beta_0 > ... > beta_min,
    float32, on the card unless `device` names another.

    Geometric spacing equalizes the per-pair log-density overlap for
    targets whose energy scales roughly linearly in beta (swap acceptance
    then stays about flat along the ladder)."""
    if n_temps < 1:
        raise ValueError("n_temps must be >= 1")
    if n_temps == 1:
        return torch.ones(1, dtype=torch.float32, device=device)
    if not 0.0 < beta_min < 1.0:
        raise ValueError("beta_min must be in (0, 1)")
    k = torch.arange(n_temps, dtype=torch.float32, device=device) / (n_temps - 1)
    return torch.full((), beta_min, dtype=torch.float32, device=device) ** k


def _validate_betas(betas) -> None:
    """Host-side ladder sanity. A bad explicit ladder must error loudly:
    betas[0] != 1 silently emits draws of pi^beta_0 while labeling their
    log-probs untempered, and beta <= 0 NaNs the swap phase."""
    if isinstance(betas, torch.Tensor):
        betas = betas.detach().cpu()
    b = np.asarray(betas, np.float64)
    if b.ndim != 1 or b.size < 1:
        raise ValueError(f"betas must be a 1-D ladder, got shape {b.shape}")
    if not np.all(np.isfinite(b)) or np.any(b <= 0.0):
        raise ValueError(f"betas must be finite and strictly positive: {b}")
    if abs(b[0] - 1.0) > 1e-6:
        raise ValueError("betas[0] must be 1.0 (the cold, untempered rung "
                         f"whose draws are emitted), got {b[0]}")
    if b.size > 1 and np.any(np.diff(b) >= 0.0):
        raise ValueError(f"betas must be strictly descending: {b}")


def swap_phase(state: ChainState, betas: Tensor, phase: int, u: Tensor, swap_acc):
    """One exchange attempt over the adjacent pairs (k, k+1) with k = phase
    (mod 2), on the (K, C, ...) view of the replica-major state. Every
    neighbour access is a roll of the replica axis, the wrapped rows masked
    off by the pairs' activity.

    betas (K,) float32; u (K, C) uniforms in the log-prob dtype (row k's
    decides pair (k, k+1)); swap_acc ((K-1,) accepted, (K-1,) attempted)
    float32. Returns (state, swap_acc)."""
    n_temps = betas.shape[0]
    n_rows, dim = state.position.shape
    chains = n_rows // n_temps
    lp_t = state.log_prob.reshape(n_temps, chains)                    # tempered
    lp_un = lp_t / betas[:, None].to(lp_t.dtype)                      # exact: lp_t = b lp
    q = state.position.reshape(n_temps, chains, dim)
    g_un = (state.grad_log_prob.reshape(n_temps, chains, dim)
            / betas[:, None, None].to(state.grad_log_prob.dtype))

    def nxt(a):
        return torch.roll(a, -1, dims=0)

    d_beta = (betas - torch.roll(betas, -1)).to(lp_un.dtype)           # b_k - b_{k+1}
    log_acc = d_beta[:, None] * (nxt(lp_un) - lp_un)                   # (K, C)
    pair_idx = torch.arange(n_temps, device=betas.device)
    active = ((pair_idx < n_temps - 1) & (pair_idx % 2 == phase))[:, None]
    take_next = active & (torch.log(u) < log_acc)                      # row k adopts k+1
    take_prev = torch.roll(take_next, 1, dims=0)                       # row k+1 adopts k
    # the roll's wrap is harmless: row 0's take_prev comes from row K-1,
    # which is never the low end of an active pair

    def mix(x, m_next, m_prev):
        return torch.where(m_next, nxt(x), torch.where(m_prev, torch.roll(x, 1, dims=0), x))

    q_new = mix(q, take_next[..., None], take_prev[..., None])
    lp_new = mix(lp_un, take_next, take_prev)
    g_new = mix(g_un, take_next[..., None], take_prev[..., None])
    state = state._replace(
        position=q_new.reshape(n_rows, dim),
        log_prob=(betas[:, None].to(lp_new.dtype) * lp_new).reshape(n_rows),
        grad_log_prob=(betas[:, None, None].to(g_new.dtype) * g_new).reshape(n_rows, dim),
    )
    accepted = (active & take_next).sum(dim=1).to(torch.float32)[:n_temps - 1]
    attempted = active[:, 0].to(torch.float32)[:n_temps - 1] * chains
    return state, (swap_acc[0] + accepted, swap_acc[1] + attempted)


def _resolve_backend(backend: str, value_and_grad_fn, device) -> str:
    """"auto" is fused where kernel 1b takes the target on this device
    (padded_targets.fusable); eager otherwise."""
    if backend not in ("auto", "eager", "fused"):
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'eager' or 'fused'")
    if backend != "auto":
        return backend
    from mcmc_tpu_torch.ops.padded_targets import fusable
    return "fused" if fusable("grahmc", value_and_grad_fn, device) else "eager"


def tempered_run(
    generator: torch.Generator,
    log_prob_fn,
    init_position: Tensor,
    step_size,
    num_steps: int,
    num_samples: int,
    betas=None,
    n_temps: int = 6,
    beta_min: float = 0.05,
    burn_in: int = 0,
    swap_interval: int = 1,
    inv_mass_matrix: Optional[Tensor] = None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
    init_replica_position: Optional[Tensor] = None,
) -> RunResult:
    """Replica-exchange HMC/GRAHMC. Returns the beta = 1 replica's RunResult.

    init_position: (C, D), replicated across the K temperatures.
    step_size: a number or 0-d tensor (scaled per replica as eps /
    sqrt(beta_k)) or an explicit (K,) tensor of per-temperature step sizes.
    betas: explicit descending ladder with betas[0] == 1, or None for
    geometric_ladder(n_temps, beta_min).
    friction_schedule/gamma/steepness: optional GRAHMC friction (None =
    plain HMC), shared across replicas.
    swap_interval: transitions between exchange attempts (1 = every step;
    pairing alternates even/odd, so a configuration can traverse the
    ladder in ~K swap phases).

    Output as the other samplers': samples (num_samples, n_collect, D) and
    UNtempered log_probs (num_samples, n_collect) of the cold replica,
    accept_rate and divergences from its transitions. info adds
    `swap_accept_rate` / `swap_attempts` ((K-1,) per adjacent pair),
    `betas`, `replica_step_sizes`, `n_temps`, `replica_accept_rate` (K,) and
    `replica_final_positions` ((K C, D); pass it back as
    `init_replica_position` to continue the ladder without re-equilibrating
    the hot rungs).

    backend: "eager" (grahmc_step on the batch, any log-prob and metric),
    "fused" (kernel 1b, one launch per sweep for all rungs: a tagged target,
    the five named schedules, a diagonal or dense metric) or "auto" (fused
    for CUDA positions and a target kernel 1b dispatches on). `generator`
    lives on the positions' device: the eager backend draws its momenta and
    both backends their swap uniforms from it; the fused one draws its
    Philox key from it once per run.
    """
    if betas is not None:
        _validate_betas(betas)
    if swap_interval < 1:
        raise ValueError("swap_interval must be >= 1")
    n_chains, dim = init_position.shape
    dev = init_position.device
    backend = _resolve_backend(backend, value_and_grad_fn, dev)
    if betas is None:
        betas = geometric_ladder(n_temps, beta_min, device=dev)
    betas = torch.as_tensor(betas, dtype=torch.float32).to(dev)
    n_temps = betas.shape[0]
    n_rows = n_temps * n_chains

    # replica-major batch: row r = replica r // C, chain r % C
    if init_replica_position is not None:
        pos0 = torch.as_tensor(init_replica_position).to(device=dev,
                                                           dtype=init_position.dtype)
        if tuple(pos0.shape) != (n_rows, dim):
            raise ValueError(f"init_replica_position must be ({n_rows}, {dim}), "
                             f"got {tuple(pos0.shape)}")
    else:
        pos0 = init_position.repeat(n_temps, 1)
    beta_row = betas.repeat_interleave(n_chains)
    base_vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    def tempered_vag(q):
        lp, g = base_vag(q)
        return beta_row.to(lp.dtype) * lp, beta_row[:, None].to(g.dtype) * g

    state = init_chain_state(pos0, None, tempered_vag, needs_grad=True)

    # hotter targets are flatter (curvature ~ beta), so the stable step
    # grows like 1 / sqrt(beta) -- unless given per replica
    step = torch.as_tensor(step_size, dtype=torch.float32).to(dev)
    if step.ndim == 0:
        replica_steps = step / torch.sqrt(betas)
    elif tuple(step.shape) == (n_temps,):
        replica_steps = step
    else:
        raise ValueError(f"step_size must be scalar or shape ({n_temps},), "
                         f"got {tuple(step.shape)}")

    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(dim, dtype=state.position.dtype, device=dev)
    inv_mass = inv_mass_matrix.to(device=dev, dtype=state.position.dtype)

    if backend == "fused":
        from mcmc_tpu_torch.ops.fused_trajectory import (
            PhiloxStream, make_fused_grahmc_step, prepare_dense_metric)
        if value_and_grad_fn is None:
            raise TypeError("the fused backend requires an analytic "
                            "value_and_grad_fn from mcmc_tpu_torch.targets")
        fused = make_fused_grahmc_step(value_and_grad_fn, num_steps, friction_schedule)
        if inv_mass.ndim == 2:
            inv_mass = prepare_dense_metric(inv_mass)       # factored once per run
        stream = PhiloxStream.from_generator(generator, dev)

        def replica_sweep(s):
            return fused(stream, s, replica_steps, gamma, steepness, inv_mass,
                         lp_scale=betas)[0]
    else:
        eps_row = replica_steps.repeat_interleave(n_chains)[:, None]     # (K C, 1)

        def replica_sweep(s):
            return grahmc_step(generator, s, tempered_vag, eps_row, num_steps, gamma,
                               steepness, inv_mass, friction_schedule)[0]

    def transition(s, swap_acc, it):
        s = replica_sweep(s)
        if it % swap_interval == swap_interval - 1:
            u = torch.rand((n_temps, n_chains), generator=generator, device=generator.device,
                           dtype=s.log_prob.dtype)
            s, swap_acc = swap_phase(s, betas, (it // swap_interval) % 2, u, swap_acc)
        return s, swap_acc

    def no_swaps():
        # (K-1,) per adjacent pair; shape (0,) at K = 1
        return (torch.zeros(n_temps - 1, dtype=torch.float32, device=dev),
                torch.zeros(n_temps - 1, dtype=torch.float32, device=dev))

    swap_acc = no_swaps()
    for it in range(burn_in):
        state, swap_acc = transition(state, swap_acc, it)
    if burn_in > 0:
        state = reset_counters(state)
        swap_acc = no_swaps()

    n_collect = collect_chains or n_chains
    samples = state.position.new_empty((num_samples, n_collect, dim))
    log_probs = state.log_prob.new_empty((num_samples, n_collect))
    for i in range(num_samples):
        state, swap_acc = transition(state, swap_acc, i + burn_in)
        samples[i] = state.position[:n_collect]
        log_probs[i] = (state.log_prob[:n_chains]
                        / betas[0].to(state.log_prob.dtype))[:n_collect]

    cold = ChainState(*(f[:n_chains] for f in state))
    accept_rate = cold.accept_count.to(torch.float32) / max(num_samples, 1)
    total_div = torch.sum(cold.divergence_count)
    info = {
        "divergence_count": cold.divergence_count,
        "total_divergences": total_div,
        "divergence_rate": total_div.to(torch.float32) / max(num_samples * n_chains, 1),
        "final_positions": cold.position,
        "replica_final_positions": state.position,
        "swap_accept_rate": swap_acc[0] / torch.clamp(swap_acc[1], min=1.0),
        # attempts per adjacent pair: 0 means never tried (a burst shorter
        # than one even/odd cycle), which a rate of 0 alone cannot tell
        # from always rejected (tuning/ladder.py checks it)
        "swap_attempts": swap_acc[1],
        "betas": betas,
        "replica_step_sizes": replica_steps,
        "n_temps": torch.tensor(n_temps, dtype=torch.int32),
        "replica_accept_rate": (state.accept_count.reshape(n_temps, n_chains)
                                .to(torch.float32).mean(dim=1) / max(num_samples, 1)),
    }
    return RunResult(samples, log_probs, accept_rate, cold, info)
