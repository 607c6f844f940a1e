"""Nesterov dual averaging for step-size adaptation (Hoffman & Gelman 2014),
the core of ``mcmc_tpu/tuning/dual_averaging.py`` (without its per-sampler
convergence-driven tuners and the deprecated joint GRAHMC tuner).

Stan constants gamma=0.05, t0=10, kappa=0.75. The state is 0-d tensors on the
device, so a tune loop can feed a batch-mean acceptance tensor straight back
into the next step size without reading anything on the host.
"""

from typing import NamedTuple

import torch

from mcmc_tpu_torch.samplers.trajectory import as_scalar

DA_GAMMA = 0.05   # shrinkage toward mu (Stan)
DA_T0 = 10.0      # iteration offset (Stan)
DA_KAPPA = 0.75   # smoothing decay (Stan)

TARGET_ACCEPT_HMC = 0.65
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
