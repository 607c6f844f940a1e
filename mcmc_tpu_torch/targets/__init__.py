"""Target distributions, first slice (port of ``mcmc_tpu/targets/__init__.py``).

Each target carries a batched analytic value-and-grad, an ``init_sampler``
taking a ``torch.Generator``, and a ``kernel_info`` tag
``{"family", "dim", "params"}`` on its value-and-grad closure — the
counterpart of the JAX package's ``pallas_info``, and what the fused kernels
dispatch on (``mcmc_tpu_torch.ops.padded_targets``).

Only the two main-path targets are ported so far: ``standard_normal`` and
``neals_funnel``. ``get_target`` raises for every other name.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

LOG_2PI = math.log(2.0 * math.pi)


class TargetDistribution(NamedTuple):
    """Target specification; the field names of the JAX package's
    TargetDistribution that this slice needs."""
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor]
    dim: int
    true_mean: Optional[torch.Tensor]
    true_cov: Optional[torch.Tensor]
    name: str
    description: str
    init_sampler: Optional[Callable] = None       # (generator, n_chains) -> (n_chains, dim)
    value_and_grad_fn: Optional[Callable] = None  # x (..., dim) -> (lp (...,), grad (..., dim))
    family: str = ""
    params: Dict[str, Any] = {}


def _tag(fn, family, dim, **params):
    """Attach the kernel dispatch tag to an analytic value-and-grad closure."""
    fn.kernel_info = {"family": family, "dim": dim, "params": params}
    return fn


def _randn(generator: torch.Generator, shape, dtype):
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=dtype)


def standard_normal(dim: int = 10) -> TargetDistribution:
    """N(0, I). log p = -0.5*(sum x^2 + D log 2pi); grad = -x."""
    def value_and_grad_fn(x):
        lp = -0.5 * (torch.sum(x * x, dim=-1) + x.shape[-1] * LOG_2PI)
        return lp, -x

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        return _randn(generator, (n_chains, dim), dtype)

    _tag(value_and_grad_fn, "standard_normal", dim)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=torch.eye(dim, dtype=torch.float64),
        name=f"StandardNormal{dim}D",
        description=f"{dim}D standard normal N(0, I) - tests basic correctness",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="standard_normal",
        params={},
    )


def neals_funnel(dim: int = 10) -> TargetDistribution:
    """Neal's funnel: x0 ~ N(0, 9); x_i | x0 ~ N(0, exp(x0)).

    Gradients:
      d/dx0 = -x0/9 + 0.5 * exp(-x0) * sum(x_rest^2) - D_rest/2
      d/dxi = -x_i * exp(-x0)
    """
    d_rest = dim - 1
    log_2pi9 = math.log(2.0 * math.pi * 9.0)

    def value_and_grad_fn(x):
        x0 = x[..., 0]
        x_rest = x[..., 1:]
        sum_sq = torch.sum(x_rest * x_rest, dim=-1)
        inv_var = torch.exp(-x0)
        lp = (-0.5 * (x0 * x0 / 9.0 + log_2pi9)
              - 0.5 * (sum_sq * inv_var + d_rest * x0 + d_rest * LOG_2PI))
        g0 = -x0 / 9.0 + 0.5 * inv_var * sum_sq - 0.5 * d_rest
        g_rest = -x_rest * inv_var[..., None]
        return lp, torch.cat([g0[..., None], g_rest], dim=-1)

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        # neck from its prior; the rest at unit scale (exp(0) = 1) to avoid
        # extreme initial gradients, as the JAX package does
        x0 = _randn(generator, (n_chains, 1), dtype) * 3.0
        x_rest = _randn(generator, (n_chains, dim - 1), dtype)
        return torch.cat([x0, x_rest], dim=1)

    true_cov_diag = torch.cat([
        torch.tensor([9.0], dtype=torch.float64),
        torch.full((dim - 1,), math.exp(4.5), dtype=torch.float64)])
    _tag(value_and_grad_fn, "neals_funnel", dim)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=torch.diag(true_cov_diag),
        name=f"NealsFunnel{dim}D",
        description=f"{dim}D Neal's funnel - tests varying curvature and scale",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="neals_funnel",
        params={},
    )


_TARGETS = {
    "standard_normal": standard_normal,
    "neals_funnel": neals_funnel,
}


def get_target(name: str, dim: int = 10) -> TargetDistribution:
    """A ported target by name; raises ValueError for any other name."""
    if name not in _TARGETS:
        raise ValueError(f"Unknown or not yet ported target '{name}'. "
                         f"Available: {sorted(_TARGETS)}")
    return _TARGETS[name](dim=dim)
