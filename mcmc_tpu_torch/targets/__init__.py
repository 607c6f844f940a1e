"""Target distributions, first slice (port of ``mcmc_tpu/targets/__init__.py``).

Each target carries a batched analytic value-and-grad, an ``init_sampler``
taking a ``torch.Generator``, and a ``kernel_info`` tag
``{"family", "dim", "params"}`` on its value-and-grad closure — the
counterpart of the JAX package's ``pallas_info``, and what the fused kernels
dispatch on (``mcmc_tpu_torch.ops.padded_targets``).

Ported so far: ``standard_normal``, ``neals_funnel``,
``correlated_gaussian`` (the dense-metric NUTS row's target),
``gaussian_mixture`` (the tempered and SMC rows' target) and
``hierarchical_logistic`` (BASELINE config 5, ``targets/hierarchical.py``;
its tag carries the data set X and y). ``get_target`` raises for every other
name; ``get_reference_sampler`` gives the exact i.i.d. samplers of the ported
targets that have one.
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


def correlated_gaussian(dim: int = 10, correlation: float = 0.9) -> TargetDistribution:
    """Compound-symmetry Gaussian: Sigma = (1 - rho) I + rho J.

    Closed forms:
      Sigma^{-1} = a I + b J, a = 1/(1-rho), b = -rho/((1-rho)(1+(D-1)rho))
      log|Sigma| = (D-1) log(1-rho) + log(1+(D-1)rho)
    grad log p = -(Sigma^{-1} x) = -(a x + b sum(x) 1), O(D), no matmul.
    """
    rho = correlation
    a = 1.0 / (1.0 - rho)
    b = -rho / ((1.0 - rho) * (1.0 + (dim - 1) * rho))
    log_det_cov = (dim - 1) * math.log(1.0 - rho) + math.log(1.0 + (dim - 1) * rho)
    cov = (1.0 - rho) * torch.eye(dim, dtype=torch.float64) + rho

    def value_and_grad_fn(x):
        s = torch.sum(x, dim=-1, keepdim=True)
        sigma_inv_x = a * x + b * s
        mahal = torch.sum(sigma_inv_x * x, dim=-1)
        lp = -0.5 * (mahal + log_det_cov + x.shape[-1] * LOG_2PI)
        return lp, -sigma_inv_x

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        return _randn(generator, (n_chains, dim), dtype)

    _tag(value_and_grad_fn, "correlated_gaussian", dim, a=a, b=b,
         log_det_cov=log_det_cov)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=cov,
        name=f"CorrelatedGaussian{dim}D_rho{correlation}",
        description=f"{dim}D Gaussian with correlation rho={correlation} - "
                    f"tests handling of correlation",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="correlated_gaussian",
        params={"correlation": correlation},
    )


def gaussian_mixture(dim: int = 10, n_modes: int = 2,
                     separation: float = 5.0) -> TargetDistribution:
    """x0 ~ 0.5 N(-sep/2, 1) + 0.5 N(+sep/2, 1); x_i ~ N(0, 1) for i > 0.

    Var[x0] = 1 + (sep/2)^2. d log p / d x0 = -(x0 + s/2) w1 - (x0 - s/2) w2
    with the softmax weights w of the two modes.
    """
    if n_modes != 2:
        raise NotImplementedError("Only 2-mode mixture currently supported")
    half_sep = separation / 2.0

    def value_and_grad_fn(x):
        x0 = x[..., 0]
        x_rest = x[..., 1:]
        d_rest = x.shape[-1] - 1
        m1 = -0.5 * (x0 + half_sep) ** 2
        m2 = -0.5 * (x0 - half_sep) ** 2
        mx = torch.maximum(m1, m2)
        e1 = torch.exp(m1 - mx)
        e2 = torch.exp(m2 - mx)
        lse = e1 + e2
        log_p_x0 = math.log(0.5) + mx + torch.log(lse) - 0.5 * LOG_2PI
        lp = log_p_x0 - 0.5 * (torch.sum(x_rest * x_rest, dim=-1) + d_rest * LOG_2PI)
        w1 = e1 / lse
        w2 = e2 / lse
        g0 = -(x0 + half_sep) * w1 - (x0 - half_sep) * w2
        return lp, torch.cat([g0[..., None], -x_rest], dim=-1)

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        # half the chains near each mode; the two halves' x0 noise is one
        # draw's prefix, as the JAX package's reuse of one key for both
        # halves gives
        n_half = n_chains // 2
        z = _randn(generator, (max(n_half, n_chains - n_half),), dtype)
        x0 = torch.cat([z[:n_half] - half_sep, z[:n_chains - n_half] + half_sep])
        x_rest = _randn(generator, (n_chains, dim - 1), dtype)
        return torch.cat([x0[:, None], x_rest], dim=1)

    true_cov_diag = torch.cat([torch.tensor([1.0 + half_sep ** 2], dtype=torch.float64),
                               torch.ones(dim - 1, dtype=torch.float64)])
    _tag(value_and_grad_fn, "gaussian_mixture", dim, separation=separation)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=torch.diag(true_cov_diag),
        name=f"GaussianMixture{dim}D_modes{n_modes}_sep{separation}",
        description=f"{dim}D Gaussian mixture (x[0] bimodal) - tests mode-switching",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="gaussian_mixture",
        params={"n_modes": n_modes, "separation": separation},
    )


from mcmc_tpu_torch.targets.hierarchical import hierarchical_logistic  # noqa: E402

_TARGETS = {
    "standard_normal": standard_normal,
    "neals_funnel": neals_funnel,
    "correlated_gaussian": correlated_gaussian,
    "gaussian_mixture": gaussian_mixture,
    "hierarchical_logistic": hierarchical_logistic,
}


def get_target(name: str, dim: int = 10, **kwargs) -> TargetDistribution:
    """A ported target by name (keyword parameters go to its factory);
    raises ValueError for any other name."""
    if name not in _TARGETS:
        raise ValueError(f"Unknown or not yet ported target '{name}'. "
                         f"Available: {sorted(_TARGETS)}")
    return _TARGETS[name](dim=dim, **kwargs)


def get_reference_sampler(name: str, dim: int = 10, **kwargs):
    """Exact i.i.d. sampler (generator, n) -> (n, dim) float64 of a ported
    target, or None where it has none (the hierarchical posterior, a mixture
    of other than two modes), as the JAX package's get_reference_sampler
    (`mcmc_tpu/targets/__init__.py:655`). The draws come from the
    generator, so they are the JAX sampler's in distribution, not in value."""
    def normal(g, shape):
        return _randn(g, shape, torch.float64)

    if name == "standard_normal":
        return lambda g, n: normal(g, (n, dim))
    if name == "correlated_gaussian":
        rho = kwargs.get("correlation", 0.9)
        cov = (1.0 - rho) * torch.eye(dim, dtype=torch.float64) + rho
        chol = torch.linalg.cholesky(cov)
        return lambda g, n: normal(g, (n, dim)) @ chol.to(g.device).T
    if name == "neals_funnel":
        def funnel(g, n):
            v = normal(g, (n,)) * 3.0
            rest = normal(g, (n, dim - 1)) * torch.exp(v / 2.0)[:, None]
            return torch.cat([v[:, None], rest], dim=1)
        return funnel
    if name == "gaussian_mixture":
        if kwargs.get("n_modes", 2) != 2:
            return None
        half_sep = kwargs.get("separation", 5.0) / 2.0

        def mixture(g, n):
            right = torch.rand((n,), generator=g, device=g.device) < 0.5
            x0 = normal(g, (n,)) + half_sep * (2.0 * right.to(torch.float64) - 1.0)
            return torch.cat([x0[:, None], normal(g, (n, dim - 1))], dim=1)
        return mixture
    return None


def has_reference_sampler(name: str) -> bool:
    """Whether get_reference_sampler(name) gives a sampler (with the
    factory's default parameters): the JAX package's answer for every
    ported target (`mcmc_tpu/targets/__init__.py:751`); False for names not
    ported yet."""
    return name in ("standard_normal", "correlated_gaussian", "neals_funnel",
                    "gaussian_mixture")
