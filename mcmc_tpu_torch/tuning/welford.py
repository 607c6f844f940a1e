"""Welford online mean/variance and pooled dense moments, vectorized over
chains (port of ``mcmc_tpu/tuning/welford.py``).

The windowed warmup learns the mass matrix from these: per-chain Welford
states (Stan's diagonal estimate, averaged over chains) or one pooled
second-moment accumulator (the dense metric). Every update is a few tensor
operations on the device; nothing is read on the host.

Dtype: the JAX package picks float64 from its global x64 flag. PyTorch has
no such flag, so the port's states take the dtype they are built with, and
the warmup builds them in the positions' dtype. `psum_increment` is the
mesh warmup's reduction of the pooled dense moments.
"""

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class WelfordState(NamedTuple):
    """Running statistics. Leading axes of mean/m2 are arbitrary batch axes
    (typically (n_chains, dim)); count is shared across the batch."""
    count: Tensor  # 0-d
    mean: Tensor
    m2: Tensor


def welford_init(shape, dtype: torch.dtype = torch.float32,
                 device="cuda") -> WelfordState:
    """Zero statistics. shape may be an int (dim) or a tuple ((n_chains,
    dim)); on the card unless `device` names another."""
    if isinstance(shape, int):
        shape = (shape,)
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros(shape, dtype=dtype, device=device),
        m2=torch.zeros(shape, dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x: Tensor) -> WelfordState:
    """Add one observation (batched over the state's leading axes)."""
    x = x.to(state.mean.dtype)
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_update_batch(state: WelfordState, batch: Tensor) -> WelfordState:
    """Add a batch of observations (leading axis = time)."""
    for x in batch:
        state = welford_update(state, x)
    return state


def welford_covariance(state: WelfordState) -> Tuple[Tensor, Tensor]:
    """(mean, sample variance m2/(n-1)) with a count floor of 2."""
    n = torch.clamp(state.count, min=2.0)
    return state.mean, state.m2 / (n - 1.0)


def chain_averaged_variance(state: WelfordState, mesh=None) -> Tensor:
    """Stan-style estimate for (n_chains, dim) states: per-chain variances
    averaged over chains. Returns (dim,). With a chain mesh the state is a
    rank's chains and the average spans every rank's: the variances are
    gathered, so every rank averages the same rows in the same order."""
    _, var = welford_covariance(state)
    if mesh is not None:
        from mcmc_tpu_torch.parallel import all_gather
        var = all_gather(var, mesh)
    return torch.mean(var, dim=0)


def shrink_variance(variance: Tensor, n_samples) -> Tensor:
    """Stan's regularization toward the identity metric:
    n/(n+5) * var + 5/(n+5) * 1.0, floored at 1e-8."""
    w = n_samples / (n_samples + 5.0)
    reg = w * variance + (1.0 - w) * 1.0
    return torch.clamp(reg, min=1e-8)


class DenseMomentState(NamedTuple):
    """Pooled second-moment accumulator for the dense metric (Stan's
    dense_e). Draws are pooled over chains and steps; `center` is a fixed
    shift (the window-start position mean) that bounds float32 cancellation
    without changing the covariance."""
    count: Tensor    # 0-d: pooled draw count (chains x steps)
    center: Tensor   # (dim,)
    sum_d: Tensor    # (dim,) sum of centered draws
    sum_o: Tensor    # (dim, dim) sum of centered outer products


def dense_moment_init(center: Tensor) -> DenseMomentState:
    """An empty accumulator around `center`, in its dtype and on its device."""
    d = center.shape[-1]
    return DenseMomentState(
        count=torch.zeros((), dtype=center.dtype, device=center.device),
        center=center,
        sum_d=torch.zeros((d,), dtype=center.dtype, device=center.device),
        sum_o=torch.zeros((d, d), dtype=center.dtype, device=center.device))


def psum_increment(new, old, mesh):
    """A replicated accumulator's update made global over a chain mesh: each
    rank computed `new` from its own chains, so old + psum(new - old) is
    the update of every rank's chains together, the same on every rank.
    `new` and `old` are NamedTuples of tensors (or tensors)."""
    from mcmc_tpu_torch.parallel import psum
    if isinstance(new, torch.Tensor):
        return old + psum(new - old, mesh)
    return type(new)(*(b + psum(a - b, mesh) for a, b in zip(new, old)))


def dense_moment_update(state: DenseMomentState,
                        positions: Tensor) -> DenseMomentState:
    """Accumulate a (n_chains, dim) batch of draws; d^T d is one plain
    matrix product, as the JAX package leaves it to XLA."""
    d = positions.to(state.center.dtype) - state.center
    return state._replace(
        count=state.count + d.shape[0],
        sum_d=state.sum_d + torch.sum(d, dim=0),
        sum_o=state.sum_o + d.T @ d)


def dense_covariance(state: DenseMomentState) -> Tensor:
    """Pooled sample covariance (dim, dim)."""
    n = torch.clamp(state.count, min=2.0)
    mu = state.sum_d / n
    return state.sum_o / n - torch.outer(mu, mu)


def shrink_covariance(cov: Tensor, n_samples) -> Tensor:
    """Stan's dense-metric regularization toward the identity:
    n/(n+5) * cov + 5/(n+5) * I, plus a 1e-8 diagonal jitter so the
    Cholesky factor never meets a semidefinite matrix."""
    w = n_samples / (n_samples + 5.0)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return w * cov + ((1.0 - w) + 1e-8) * eye
