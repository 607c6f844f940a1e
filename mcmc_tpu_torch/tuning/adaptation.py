"""Stan-style windowed warmup: step-size DA + mass-matrix learning (port of
``mcmc_tpu/tuning/adaptation.py``).

- schedule: exploration 500 + adaptation windows [25, 50, 100, 200, 500,
  1000] + cooldown 125 (2,500 steps);
- every window runs in fixed-width batches of `update_freq` steps, one DA
  update per batch from the batch-mean acceptance statistic; a window
  shorter than a batch, or a remainder, is padded with masked steps, which
  still advance the chains (a valid transition, left out of the DA and
  Welford statistics), so the default warmup runs 2,700 transitions;
- during an adaptation window the mass matrix accumulates: per-chain
  Welford (diagonal, learn_mass_matrix=True) or pooled second moments
  (dense, "dense"), re-initialised at each window's start (at the mean
  position for dense, from zero for diagonal); at its end the estimate is
  shrunk toward the identity (n = count / n_chains draws per chain for
  dense, n = count for diagonal) and dual averaging restarts (da_reset);
- a dense warmup starts from a dense identity metric, so even the
  exploration window runs the dense kernel;
- GRAHMC: gamma tuned after the mass matrix by sequential ESJD tuning
  (tuning/sequential.py);
- NUTS: the accept statistic is the mean trajectory alpha. Classic NUTS
  (samplers/nuts.py) runs one transition a step. The persistent machine
  (backend="persistent") runs `steps_per_warmup_step` (G, 32) leapfrog
  slots a step and takes the statistic from its accumulators' deltas over
  the chains that completed a transition (_persistent_accept_stat); for
  CUDA positions and a target kernel 4 dispatches on, a step is ONE kernel-4
  window of G slots at W = 4, 2 or 1 (the largest dividing G), the packed
  state carried from step to step, else the eager machine's G iterations;
  `nuts_proposal` ("endpoint", "multinomial") and a dense metric pick
  kernel 4a and 4b as in sampling;
- initial step 0.5/sqrt(d), final step exp(log_step_bar).

The DA state and the batch statistics stay on the device: the host reads
the accept trace once, after the loop, as the JAX package does. With the
fused backend (kernel 1; 1a for the dense metric) a dense metric is
factored when it changes, at window ends, without waiting for the device.

Not ported yet (it raises NotImplementedError): `mesh=`.
"""

import math
import time
from typing import Any, Dict, Optional, Tuple

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import init_chain_state, make_value_and_grad
from mcmc_tpu_torch.tuning.dual_averaging import (da_final_step_size, da_init,
                                                  da_reset, da_step_size,
                                                  da_update)
from mcmc_tpu_torch.tuning.sequential import accept_rate, sequential_tune_grahmc
from mcmc_tpu_torch.tuning.welford import (chain_averaged_variance,
                                           dense_covariance, dense_moment_init,
                                           dense_moment_update,
                                           shrink_covariance, shrink_variance,
                                           welford_init, welford_update)


def build_schedule(
    num_steps: Optional[int] = None,
    exploration_steps: int = 500,
    adaptation_windows: Optional[list] = None,
    cooldown_steps: int = 125,
) -> list:
    """[(start, end, phase)] with phases exploration/adaptation/cooldown.

    Default totals 2500 = 500 + (25+50+100+200+500+1000) + 125.
    """
    if adaptation_windows is None:
        adaptation_windows = [25, 50, 100, 200, 500, 1000]

    schedule = []
    start = 0
    schedule.append((start, start + exploration_steps, "exploration"))
    start += exploration_steps
    for w in adaptation_windows:
        schedule.append((start, start + w, "adaptation"))
        start += w
    schedule.append((start, start + cooldown_steps, "cooldown"))
    start += cooldown_steps

    if num_steps is not None and start != num_steps:
        print(f"Warning: computed warmup ({start}) != num_steps ({num_steps}); "
              f"using computed schedule")
    return schedule


def fixed_width_batches(window_len: int, batch_width: int):
    """Yield (n_real, live_mask) fixed-width batches covering a window: every
    batch has batch_width steps, of which the first n_real are live and the
    rest, in a short window or its remainder, masked (live_mask a
    (batch_width,) bool tensor on the host). A window not divisible by
    batch_width gets one extra DA update on its remainder batch."""
    B = max(1, int(batch_width))
    remaining = int(window_len)
    while remaining > 0:
        n_real = min(B, remaining)
        remaining -= n_real
        yield n_real, torch.arange(B) < n_real


def _persistent_accept_stat(d_alpha: torch.Tensor, d_transitions: torch.Tensor,
                            fallback: float = 0.65) -> torch.Tensor:
    """A persistent-NUTS warmup step's accept statistic from the per-chain
    accumulator deltas: the mean over the chains that completed a
    transition of their mean alpha, `fallback` when none did (the JAX
    package's statistic, shared by its machine and fused backends)."""
    valid = d_transitions > 0
    per_chain = torch.where(valid, d_alpha / torch.clamp(d_transitions, min=1.0),
                            torch.zeros_like(d_alpha))
    num = torch.sum(per_chain)
    den = torch.sum(valid.to(per_chain.dtype))
    stat = num / torch.clamp(den, min=1.0)
    return torch.where(den > 0, stat, torch.full_like(stat, fallback))


def _resolve_backend(sampler: str, backend: str, value_and_grad_fn,
                     device) -> str:
    """"auto" -> "fused" for GRAHMC with CUDA positions and a target kernel
    1 dispatches on, else "eager". NUTS: "persistent" runs the persistent
    machine (kernel 4 or the eager machine, _make_step_fn), "auto" and
    "eager" classic NUTS, eager. No other path is taken than the one asked
    for: an explicit "fused" runs the kernel or raises."""
    from mcmc_tpu_torch.ops.padded_targets import KERNEL_FAMILIES
    if sampler == "nuts":
        if backend in ("auto", "eager"):
            return "eager"
        if backend == "persistent":
            return backend
        raise ValueError(f"the NUTS warmup takes backend 'auto' or 'eager' (classic "
                         f"NUTS) or 'persistent', got {backend!r}")
    if backend == "persistent":
        raise ValueError("backend='persistent' is the NUTS warmup's")
    if sampler not in ("hmc", "grahmc", "rahmc"):
        raise ValueError(f"Unknown sampler: {sampler}")
    if backend == "auto":
        info = getattr(value_and_grad_fn, "kernel_info", None)
        if (sampler != "hmc" and torch.device(device).type == "cuda"
                and info is not None and info["family"] in KERNEL_FAMILIES["grahmc"]):
            return "fused"
        return "eager"
    if backend == "fused" and sampler == "hmc":
        raise ValueError("the HMC warmup runs eager; the fused warmup is GRAHMC's")
    if backend not in ("eager", "fused"):
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'eager' "
                         f"or 'fused'")
    return backend


def _persistent_step_fn(generator: torch.Generator, log_prob_fn, value_and_grad_fn,
                        kwargs, device):
    """The persistent-NUTS warmup's (step, make_state, get_position): one
    step advances every chain's machine by G = steps_per_warmup_step
    leapfrog slots. For CUDA positions and a target kernel 4 dispatches on
    (or kwargs["fused_warmup"] True, which on CPU positions runs the
    kernel's plain version), ONE kernel-4 window of G slots at W = 4, 2 or
    1, the largest dividing G, on the float32 machine state carried from
    step to step; its Philox key is drawn from `generator` whenever the
    metric changes. Otherwise the eager machine's G iterations, its draws
    from `generator`."""
    from mcmc_tpu_torch.ops.padded_targets import KERNEL_FAMILIES
    from mcmc_tpu_torch.samplers.nuts_persistent import (_init_pstate, _make_window_step,
                                                         draw_window)
    max_tree_depth = kwargs.get("max_tree_depth", 10)
    G = kwargs.get("steps_per_warmup_step", 32)
    # warmup runs the sampling's proposal scheme, so the step and metric
    # adapt to the dynamics sampling will run
    scheme = kwargs.get("nuts_proposal", "endpoint")
    multinomial = scheme == "multinomial"
    use_fused = kwargs.get("fused_warmup")
    if use_fused is None:
        info = getattr(value_and_grad_fn, "kernel_info", None)
        use_fused = (torch.device(device).type == "cuda" and info is not None
                     and info["family"] in KERNEL_FAMILIES["nuts"])

    def chain_state(pos):
        return init_chain_state(pos, log_prob_fn, value_and_grad_fn, needs_grad=True)

    if use_fused:
        from mcmc_tpu_torch.ops.fused_nuts import make_fused_nuts_window
        W = next(w for w in (4, 2, 1) if G % w == 0)
        built = {}

        def make_state(pos):
            built["dtype"] = pos.dtype
            cs = chain_state(pos)
            return _init_pstate(cs.position.to(torch.float32), cs.log_prob,
                                cs.grad_log_prob.to(torch.float32), torch.float32,
                                multinomial=multinomial, max_tree_depth=max_tree_depth)

        def step(ps, step_size, metric):
            if built.get("metric") is not metric:
                built["metric"] = metric
                built["window"] = make_fused_nuts_window(
                    value_and_grad_fn, generator, step_size, metric, max_tree_depth, 1000.0,
                    W, ps.q.device)
            a0, t0 = ps.alpha_acc.clone(), ps.transitions.clone()
            ps = built["window"](ps, G, step_size)
            return ps, _persistent_accept_stat(ps.alpha_acc - a0,
                                               (ps.transitions - t0).to(torch.float32))
        return step, make_state, lambda ps: ps.q.to(built["dtype"])

    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    def make_state(pos):
        cs = chain_state(pos)
        return _init_pstate(cs.position, cs.log_prob, cs.grad_log_prob,
                            precision.energy_dtype(cs.position.dtype),
                            multinomial=multinomial, max_tree_depth=max_tree_depth)

    def step(ps, step_size, inv_mass):
        e_dtype = ps.sum_alpha.dtype
        wstep = _make_window_step(vag, step_size, inv_mass.to(ps.q.dtype), max_tree_depth,
                                  1000.0, proposal_scheme=scheme)
        C, D = ps.q.shape
        a0, t0 = ps.alpha_acc, ps.transitions
        for xs in zip(*draw_window(generator, G, C, D, ps.q.dtype)):
            ps = wstep(ps, xs)
        return ps, _persistent_accept_stat((ps.alpha_acc - a0).to(e_dtype),
                                           (ps.transitions - t0).to(e_dtype))
    return step, make_state, lambda ps: ps.q


def _make_step_fn(sampler: str, generator: torch.Generator, log_prob_fn,
                  value_and_grad_fn, kwargs, schedule_type, gamma, steepness,
                  backend: str):
    """Build the warmup stepping triple (step, make_state, get_position):
    step(state, step_size, metric) -> (state, accept_stat), its randomness
    from `generator` (a Philox stream drawn from it for the fused backend);
    make_state(initial_position) -> the chain state; get_position(state) ->
    (n_chains, dim) for the moments and the returned position. The accept
    statistic is a float32 device tensor (sequential.accept_rate)."""
    if backend == "persistent":
        return _persistent_step_fn(generator, log_prob_fn, value_and_grad_fn, kwargs,
                                   generator.device)
    num_steps = kwargs.get("num_steps", 20)

    def make_state(pos):
        return init_chain_state(pos, log_prob_fn, value_and_grad_fn, needs_grad=True)

    def get_position(state):
        return state.position

    if sampler == "nuts":
        from mcmc_tpu_torch.samplers.nuts import nuts_step
        max_tree_depth = kwargs.get("max_tree_depth", 10)
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

        def step(state, step_size, inv_mass):
            state, (_depths, mean_alpha) = nuts_step(generator, state, vag, step_size,
                                                     inv_mass, max_tree_depth)
            return state, torch.mean(mean_alpha)     # the mean trajectory alpha
        return step, make_state, get_position

    if sampler == "hmc":
        from mcmc_tpu_torch.samplers.hmc import hmc_step
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

        def step(state, step_size, inv_mass):
            state, (accept, *_r) = hmc_step(generator, state, vag, step_size,
                                            num_steps, inv_mass)
            return state, accept_rate([accept])
        return step, make_state, get_position

    from mcmc_tpu_torch.samplers.grahmc import get_friction_schedule, grahmc_step
    schedule_fn = get_friction_schedule(schedule_type or "constant")
    if backend == "fused":
        from mcmc_tpu_torch.ops.fused_trajectory import (PhiloxStream,
                                                         make_fused_grahmc_step)
        fused = make_fused_grahmc_step(value_and_grad_fn, num_steps, schedule_fn)
        stream = PhiloxStream.from_generator(generator, generator.device)

        def step(state, step_size, metric):
            state, (accept, *_r) = fused(stream, state, step_size, gamma,
                                         steepness, metric)
            return state, accept_rate([accept])
        return step, make_state, get_position

    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    def step(state, step_size, inv_mass):
        state, (accept, *_r) = grahmc_step(generator, state, vag, step_size,
                                           num_steps, gamma, steepness, inv_mass,
                                           schedule_fn)
        return state, accept_rate([accept])
    return step, make_state, get_position


def run_adaptive_warmup(
    sampler: str,
    target_log_prob,
    target_grad_log_prob,          # kept for API parity; analytic grads via value_and_grad_fn
    initial_position: torch.Tensor,
    generator: torch.Generator,
    num_warmup: int = 1000,
    target_accept: float = 0.65,
    schedule_type: Optional[str] = None,
    update_freq: int = 100,
    learn_mass_matrix=True,
    value_and_grad_fn=None,
    verbose: bool = False,
    backend: str = "auto",
    mesh=None,
    **kwargs,
) -> Tuple[float, torch.Tensor, torch.Tensor, Dict]:
    """Windowed warmup. Returns (step_size, inv_mass_matrix, position, info).

    sampler: "hmc" (eager), "grahmc", "rahmc" or "nuts". learn_mass_matrix:
    False (identity), True (diagonal) or "dense" (full covariance, Stan's
    dense_e). backend: "eager", "fused" (GRAHMC through kernel 1, or 1a for
    the dense metric; the counterpart of the JAX package's "pallas") or
    "auto" (fused for GRAHMC on CUDA positions and a tagged target); for
    NUTS "auto"/"eager" (classic NUTS) or "persistent" (the persistent
    machine: kernel 4 windows on CUDA positions and a tagged target, see
    _persistent_step_fn; kwargs max_tree_depth, steps_per_warmup_step,
    nuts_proposal, fused_warmup). The returned position is in the initial
    position's dtype.
    `generator` lives on the positions' device and drives every draw,
    the sequential gamma tune's included. kwargs as in the JAX package:
    num_steps, gamma, steepness, exploration_steps, adaptation_windows,
    cooldown_steps, max_iter_step, gamma_coarse_values,
    gamma_samples_per_eval."""
    if mesh is not None:
        raise NotImplementedError("the mesh warmup waits for parallel/ "
                                  "(ROADMAP Queue 1, item 14)")
    n_chains, n_dim = initial_position.shape
    device = initial_position.device
    start_time = time.time()
    dense_mass = learn_mass_matrix == "dense"
    backend = _resolve_backend(sampler, backend, value_and_grad_fn, device)

    if sampler in ("grahmc", "rahmc"):
        gamma = kwargs.get("gamma", 1.0)
        steepness = kwargs.get("steepness", 0.5 if schedule_type == "tanh" else 2.0)
    else:
        gamma = steepness = None

    step_fn, make_state, get_position = _make_step_fn(
        sampler, generator, target_log_prob, value_and_grad_fn, kwargs,
        schedule_type, gamma, steepness, backend)

    def step_metric(inv_mass):
        """What the step takes: the fused kernels a dense metric factored
        here, once per change (no wait on the device)."""
        if backend == "fused" and dense_mass:
            from mcmc_tpu_torch.ops.fused_trajectory import prepare_dense_metric
            return prepare_dense_metric(inv_mass, check_errors=False)
        return inv_mass

    # --- initial state ---------------------------------------------------
    pos_dtype = initial_position.dtype
    initial_step = 0.5 / math.sqrt(n_dim)
    da_state = da_init(initial_step, precision.energy_dtype(pos_dtype), device)
    chain_state = make_state(initial_position)
    if dense_mass:
        # identity as a dense matrix and a dense accumulator from the start
        # (re-initialised with a real center at each adaptation window)
        inv_mass = torch.eye(n_dim, dtype=pos_dtype, device=device)
        welford = dense_moment_init(torch.zeros(n_dim, dtype=pos_dtype, device=device))
    else:
        inv_mass = torch.ones(n_dim, dtype=pos_dtype, device=device)
        welford = welford_init((n_chains, n_dim), pos_dtype, device)
    metric = step_metric(inv_mass)

    schedule = build_schedule(
        num_warmup,
        exploration_steps=kwargs.get("exploration_steps", 500),
        adaptation_windows=kwargs.get("adaptation_windows"),
        cooldown_steps=kwargs.get("cooldown_steps", 125))
    if verbose:
        print(f"Adaptation schedule ({sum(e - s for s, e, _ in schedule)} steps):")
        for s, e, t in schedule:
            print(f"  [{s:4d} - {e:4d}] {t}")
        if not learn_mass_matrix:
            print("  [mass matrix learning disabled - identity metric]")

    accept_trace = []
    # --- windowed adaptation (fixed-width DA batches) ---------------------
    for start_idx, end_idx, phase in schedule:
        accumulate = phase == "adaptation" and bool(learn_mass_matrix)
        if accumulate:
            if dense_mass:
                welford = dense_moment_init(torch.mean(get_position(chain_state), dim=0))
            else:
                welford = welford_init((n_chains, n_dim), pos_dtype, device)
        update = dense_moment_update if dense_mass else welford_update

        for _n_real, mask in fixed_width_batches(end_idx - start_idx, update_freq):
            step_size = da_step_size(da_state)
            stats = []
            for live in mask.tolist():
                # a masked step still advances the chains
                chain_state, stat = step_fn(chain_state, step_size, metric)
                if live:
                    stats.append(stat)
                    if accumulate:
                        welford = update(welford, get_position(chain_state))
            acc = torch.stack(stats).mean()
            da_state = da_update(da_state, acc, target_accept)
            accept_trace.append(acc)

        if accumulate:
            if dense_mass:
                cov = dense_covariance(welford)
                inv_mass = shrink_covariance(cov, welford.count / n_chains).to(pos_dtype)
            else:
                variance = chain_averaged_variance(welford)
                inv_mass = shrink_variance(variance, welford.count).to(pos_dtype)
            metric = step_metric(inv_mass)
            da_state = da_reset(da_state)
            if verbose:
                n_pc = float(welford.count) / (n_chains if dense_mass else 1)
                print(f"  window [{start_idx}-{end_idx}]: mass matrix range "
                      f"[{float(torch.min(inv_mass)):.4f}, "
                      f"{float(torch.max(inv_mass)):.4f}] (n={n_pc:.0f}/chain)")

    accept_trace = torch.stack(accept_trace).tolist()
    final_step_size = float(da_final_step_size(da_state))
    position = get_position(chain_state).to(pos_dtype)
    if verbose:
        print(f"Warmup complete. Final step_size: {final_step_size:.5f}")

    # --- GRAHMC phase 3: friction tuning on the sphered geometry ----------
    if sampler in ("grahmc", "rahmc"):
        tuned_step, tuned_gamma, tuned_steepness, _history = sequential_tune_grahmc(
            generator, target_log_prob, target_grad_log_prob, position,
            num_steps=kwargs.get("num_steps", 20),
            schedule_type=schedule_type or "constant",
            target_accept=target_accept,
            max_iter_step=kwargs.get("max_iter_step", 1000),
            inv_mass_matrix=inv_mass,
            init_step_size=final_step_size,
            gamma_coarse_values=kwargs.get("gamma_coarse_values"),
            gamma_samples_per_eval=kwargs.get("gamma_samples_per_eval", 150),
            value_and_grad_fn=value_and_grad_fn,
            verbose=verbose,
            backend=backend,
        )
        gamma, steepness, final_step_size = tuned_gamma, tuned_steepness, tuned_step
        if verbose:
            print(f"  friction tuned: gamma={gamma:.5f} steepness={steepness:.3f} "
                  f"step={final_step_size:.5f}")

    info: Dict[str, Any] = {
        "elapsed_time": time.time() - start_time,
        "final_step_size": final_step_size,
        "inv_mass_matrix": inv_mass,
        "mass_matrix_learned": learn_mass_matrix,
        "accept_trace": accept_trace,
    }
    if sampler in ("grahmc", "rahmc"):
        info["gamma"] = float(gamma) if gamma is not None else 1.0
        info["steepness"] = float(steepness) if steepness is not None else 5.0

    # inv_mass is still the identity when learning was disabled
    return final_step_size, inv_mass, position, info
