"""Carry the JAX package's state across to the port.

MCMC has no weights: what moves between the two packages is the target's
parameters, the chain state, the mass matrix and the dual-averaging state.
Everything here takes numpy arrays (``np.asarray`` of the JAX arrays), so this
module, like the rest of the port, never imports ``jax``.
"""

import numpy as np
import torch

from mcmc_tpu_torch.samplers.base import ChainState
from mcmc_tpu_torch.targets import TargetDistribution, get_target
from mcmc_tpu_torch.tuning.dual_averaging import DualAveragingState


def target_from_tag(info: dict) -> TargetDistribution:
    """The port's target for a JAX target's ``pallas_info`` tag
    ``{"family", "dim", "params"}``. Raises for families not yet ported and
    for parameters these families do not take."""
    target = get_target(info["family"], dim=int(info["dim"]))
    if dict(info.get("params", {})) != target.params:
        raise ValueError(f"{info['family']} takes params {target.params}, "
                         f"got {info['params']}")
    return target


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def chain_state_from_numpy(position, log_prob, grad_log_prob, accept_count,
                           divergence_count, device="cpu") -> ChainState:
    """ChainState from the five arrays of a JAX ChainState, dtypes kept
    (counters as int32)."""
    return ChainState(
        position=_tensor(position, device),
        log_prob=_tensor(log_prob, device),
        grad_log_prob=_tensor(grad_log_prob, device),
        accept_count=_tensor(accept_count, device, torch.int32),
        divergence_count=_tensor(divergence_count, device, torch.int32),
    )


def da_state_from_numpy(log_step, log_step_bar, h_bar, mu, count,
                        device="cpu") -> DualAveragingState:
    """DualAveragingState from the five scalars of a JAX one."""
    return DualAveragingState(*(_tensor(v, device).reshape(())
                                for v in (log_step, log_step_bar, h_bar, mu,
                                          count)))
