"""Carry the JAX package's state across to the port.

MCMC has no weights: what moves between the two packages is the target's
parameters, the chain state (and the persistent-NUTS machine state), the
mass matrix and the dual-averaging state.
Everything here takes numpy arrays (``np.asarray`` of the JAX arrays), so this
module, like the rest of the port, never imports ``jax``.
"""

import numpy as np
import torch

from mcmc_tpu_torch.ops.fused_nuts import BOOL_FIELDS, INT_FIELDS
from mcmc_tpu_torch.samplers.base import ChainState
from mcmc_tpu_torch.samplers.nuts_persistent import _PState
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


def nuts_state_from_numpy(device="cpu", **fields) -> _PState:
    """The port's persistent-NUTS machine state from the JAX machine's, as
    numpy arrays keyed by the JAX `_PState` field names (``ps._asdict()``,
    or the fields of an unpacked kernel-layout `TState`: (C, D) arrays and
    (C,) rows). Float fields keep their dtype (`direction` takes the
    positions'), counters become int32 and flags bool (a float row counts as
    set above 0.5). `n_exec`, which the JAX machine does not carry, defaults
    to zeros. Fields of the multinomial scheme must be absent or None: the
    port runs the endpoint scheme only."""
    extra = sorted(k for k, v in fields.items()
                   if k not in _PState._fields and v is not None)
    if extra:
        raise ValueError(f"fields the port's endpoint machine does not carry: {extra}")
    missing = [f for f in _PState._fields if f != "n_exec" and fields.get(f) is None]
    if missing:
        raise ValueError(f"missing machine state fields: {missing}")
    if fields.get("n_exec") is None:
        fields["n_exec"] = np.zeros(np.shape(fields["lp"]), np.int32)
    q_dtype = np.asarray(fields["q"]).dtype
    out = {}
    for name in _PState._fields:
        a = np.asarray(fields[name])
        if name in BOOL_FIELDS:
            a = a > 0.5 if a.dtype.kind == "f" else a.astype(bool)
        elif name in INT_FIELDS:
            a = a.astype(np.int32)
        elif name == "direction":
            a = a.astype(q_dtype)
        out[name] = _tensor(a, device)
    return _PState(**out)
