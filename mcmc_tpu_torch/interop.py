"""Carry the JAX package's state across to the port.

MCMC has no weights: what moves between the two packages is the target's
parameters, the chain state (and the persistent-NUTS machine state), the
mass matrix (a factored dense one too), the dual-averaging, ChEES and
friction-SPSA states and the warmup's Welford and dense-moment
accumulators.
Everything here takes numpy arrays (``np.asarray`` of the JAX arrays), so this
module, like the rest of the port, never imports ``jax``.
"""

import math

import numpy as np
import torch

from mcmc_tpu_torch.ops.fused_nuts import (BOOL_FIELDS, INT_FIELDS,
                                           MULTI_BOOL_FIELDS, MULTI_FLOAT_FIELDS,
                                           MULTI_FULL_FIELDS, STACK_FIELDS)
from mcmc_tpu_torch.ops.fused_trajectory import PreparedDenseMetric
from mcmc_tpu_torch.samplers.base import ChainState
from mcmc_tpu_torch.samplers.nuts_persistent import _PState
from mcmc_tpu_torch.targets import TargetDistribution, get_target
from mcmc_tpu_torch.tuning.chees import ChEESState, GammaSPSAState
from mcmc_tpu_torch.tuning.dual_averaging import DualAveragingState
from mcmc_tpu_torch.tuning.welford import DenseMomentState, WelfordState


def target_from_tag(info: dict) -> TargetDistribution:
    """The port's target for a JAX target's ``pallas_info`` tag
    ``{"family", "dim", "params"}``. Raises for unknown families and for
    parameters that differ from the port target's own tag: numbers must
    agree to 1e-12; arrays (the hierarchical posterior's data set X, y),
    tuples (the concentric shells' radii) and integers (the nested shells'
    n_inner) exactly."""
    from mcmc_tpu_torch.targets import rahmc_paper
    params = dict(info.get("params", {}))
    factories = {"multimodal_funnel_2d": rahmc_paper.multimodal_funnel_2d,
                 "concentric_l1_balls": rahmc_paper.concentric_l1_balls,
                 "nested_l1_balls": rahmc_paper.nested_l1_balls}
    if info["family"] in factories:
        dim = {} if info["family"] == "multimodal_funnel_2d" else {"dim": int(info["dim"])}
        try:
            target = factories[info["family"]](**dim, **params)
        except TypeError as err:        # a parameter the factory does not take
            raise ValueError(f"{info['family']}: params {sorted(params)}: {err}") from err
        return _checked(info, params, target)
    kwargs = {}
    if info["family"] == "correlated_gaussian" and "a" in params:
        kwargs["correlation"] = 1.0 - 1.0 / params["a"]    # a = 1 / (1 - rho)
    if info["family"] == "gaussian_mixture" and "separation" in params:
        kwargs["separation"] = params["separation"]
    if info["family"] == "hierarchical_logistic":
        kwargs.update({k: int(params[k]) for k in ("n_data", "data_seed") if k in params})
    if info["family"] in ("ill_conditioned_gaussian", "student_t", "log_gamma",
                          "log_gamma_unconstrained", "rosenbrock"):
        kwargs.update(params)           # the factory's own keyword arguments
    try:
        target = get_target(info["family"], dim=int(info["dim"]), **kwargs)
    except TypeError as err:            # a parameter the factory does not take
        raise ValueError(f"{info['family']}: params {sorted(params)}: {err}") from err
    return _checked(info, params, target)


def _checked(info: dict, params: dict, target: TargetDistribution) -> TargetDistribution:
    """`target` if its tag has the dim and exactly the params of `info`
    (_same), else ValueError."""
    tag = target.value_and_grad_fn.kernel_info
    if tag["dim"] != int(info["dim"]):
        raise ValueError(f"{info['family']} has dim {tag['dim']}, the tag {info['dim']}")
    ours = tag["params"]
    if set(params) != set(ours):
        raise ValueError(f"{info['family']} takes params {sorted(ours)}, got {sorted(params)}")
    differ = sorted(k for k in ours if not _same(params[k], ours[k]))
    if differ:
        raise ValueError(f"{info['family']}: params {differ} differ from the port target's")
    return target


def _same(theirs, ours) -> bool:
    """A tag parameter equal to the port's: arrays, tuples and integers
    exactly, other numbers to 1e-12."""
    if isinstance(ours, np.ndarray):
        theirs = np.asarray(theirs)
        return theirs.shape == ours.shape and bool(np.array_equal(theirs, ours))
    if isinstance(ours, tuple):
        return tuple(theirs) == ours
    if isinstance(ours, int):
        return theirs == ours
    return math.isclose(theirs, ours, rel_tol=1e-12)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def chain_state_from_numpy(position, log_prob, grad_log_prob, accept_count,
                           divergence_count, device="cuda") -> ChainState:
    """ChainState from the five arrays of a JAX ChainState, dtypes kept
    (counters as int32), on the card unless `device` names another."""
    return ChainState(
        position=_tensor(position, device),
        log_prob=_tensor(log_prob, device),
        grad_log_prob=_tensor(grad_log_prob, device),
        accept_count=_tensor(accept_count, device, torch.int32),
        divergence_count=_tensor(divergence_count, device, torch.int32),
    )


def da_state_from_numpy(log_step, log_step_bar, h_bar, mu, count,
                        device="cuda") -> DualAveragingState:
    """DualAveragingState from the five scalars of a JAX one, on the card
    unless `device` names another."""
    return DualAveragingState(*(_tensor(v, device).reshape(())
                                for v in (log_step, log_step_bar, h_bar, mu,
                                          count)))


def chees_state_from_numpy(log_t, m, v, count, device="cuda") -> ChEESState:
    """ChEESState from the four scalars of a JAX one, dtypes kept, on the
    card unless `device` names another."""
    return ChEESState(*(_tensor(x, device).reshape(()) for x in (log_t, m, v, count)))


def gamma_spsa_state_from_numpy(log_gamma, sum_p, sum_m, n_p, n_m,
                                device="cuda") -> GammaSPSAState:
    """GammaSPSAState from the five scalars of a JAX one, dtypes kept, on
    the card unless `device` names another."""
    return GammaSPSAState(*(_tensor(x, device).reshape(())
                            for x in (log_gamma, sum_p, sum_m, n_p, n_m)))


def nuts_state_from_numpy(device="cuda", **fields) -> _PState:
    """The port's persistent-NUTS machine state from the JAX machine's, as
    numpy arrays keyed by the JAX `_PState` field names (``ps._asdict()``,
    or the fields of an unpacked kernel-layout `TState`: (C, D) arrays,
    (C,) rows and (C, max_tree_depth, D) checkpoint stacks), on the card
    unless `device` names another. Float fields keep their dtype
    (`direction` takes the positions'), counters become int32 and flags
    bool (a float row counts as set above 0.5). `n_exec`, which the JAX
    machine does not carry, defaults to zeros. The multinomial scheme's
    fields come all together (that scheme's state) or not at all (the
    endpoint scheme's)."""
    extra = sorted(k for k, v in fields.items()
                   if k not in _PState._fields and v is not None)
    if extra:
        raise ValueError(f"fields the port's machine does not carry: {extra}")
    multi = MULTI_FULL_FIELDS + MULTI_FLOAT_FIELDS + MULTI_BOOL_FIELDS + STACK_FIELDS
    given = [f for f in multi if fields.get(f) is not None]
    if given and len(given) != len(multi):
        raise ValueError(f"partial multinomial state: missing "
                         f"{sorted(set(multi) - set(given))}")
    names = [f for f in _PState._fields if given or f not in multi]
    missing = [f for f in names if f != "n_exec" and fields.get(f) is None]
    if missing:
        raise ValueError(f"missing machine state fields: {missing}")
    if fields.get("n_exec") is None:
        fields["n_exec"] = np.zeros(np.shape(fields["lp"]), np.int32)
    q_dtype = np.asarray(fields["q"]).dtype
    out = {}
    for name in names:
        a = np.asarray(fields[name])
        if name in BOOL_FIELDS + MULTI_BOOL_FIELDS:
            a = a > 0.5 if a.dtype.kind == "f" else a.astype(bool)
        elif name in INT_FIELDS:
            a = a.astype(np.int32)
        elif name == "direction":
            a = a.astype(q_dtype)
        out[name] = _tensor(a, device)
    return _PState(**out)


def welford_state_from_numpy(count, mean, m2, device="cuda") -> WelfordState:
    """WelfordState from the three arrays of a JAX one, dtypes kept, on the
    card unless `device` names another."""
    return WelfordState(_tensor(count, device).reshape(()), _tensor(mean, device),
                        _tensor(m2, device))


def dense_moment_state_from_numpy(count, center, sum_d, sum_o,
                                  device="cuda") -> DenseMomentState:
    """DenseMomentState from the four arrays of a JAX one, dtypes kept, on
    the card unless `device` names another."""
    return DenseMomentState(_tensor(count, device).reshape(()), _tensor(center, device),
                            _tensor(sum_d, device), _tensor(sum_o, device))


def metric_from_numpy(inv_mass, l_inv=None, dim=None, device="cuda"):
    """The port's metric from the JAX package's: a (D,) or (D, D) inv_mass
    array as a tensor (dtype kept), or the two arrays (invm, l_inv) of a
    JAX PreparedDenseMetric, with the target's `dim`, as a
    PreparedDenseMetric in float32. The JAX one is padded to its TPU block
    d_pad with an identity block, so L^{-1} is block diagonal too and its
    leading (dim, dim) block is the factor of the leading block of M^{-1}:
    that block is kept (L^{-1}'s lower triangle, as the kernels take it).
    On the card unless `device` names another."""
    if l_inv is None:
        return _tensor(inv_mass, device)
    if dim is None:
        raise ValueError("a JAX PreparedDenseMetric is padded to its TPU block: "
                         "pass the target's dim to cut it")
    dim = int(dim)
    invm, l_inv = (np.asarray(a)[:dim, :dim] for a in (inv_mass, l_inv))
    return PreparedDenseMetric(
        *(_tensor(np.ascontiguousarray(a), device, torch.float32)
          for a in (invm, np.tril(l_inv))))
