"""The RAHMC paper's benchmark targets (port of
``mcmc_tpu/targets/rahmc_paper.py``; the densities are the JAX package's
reconstruction of the reference's missing module):

- ``multimodal_funnel_2d(mu, sigma, c)``: bimodal neck prior
  ``v ~ 0.5 N(+mu, sigma^2) + 0.5 N(-mu, sigma^2)`` with a funnel conditional
  ``x | v ~ N(0, c e^v)``; tractable moments and an exact sampler;
- ``concentric_l1_balls(dim, radii, sigma)``: a mixture of Gaussian shells in
  the L1 norm, ``p(x) ∝ sum_k exp(-(|x|_1 - r_k)^2 / (2 sigma^2))``;
- ``nested_l1_balls(dim, r_outer, r_inner, mu_norm, sigma, n_inner)``: one
  outer L1 shell plus ``n_inner`` small L1 shells about +/- axis points at
  L1 distance ``mu_norm`` from the origin.

Each carries a batched analytic value-and-grad and a ``kernel_info`` tag
(the kernels' device functions: ``ops/padded_targets.py``,
``csrc/targets.cuh``); draws come from an explicit ``torch.Generator``.
"""

import math

import torch

from mcmc_tpu_torch.targets import TargetDistribution, _randn, _tag


def multimodal_funnel_2d(mu: float = 3.0, sigma: float = 1.0,
                         c: float = 1.0) -> TargetDistribution:
    """2-D bimodal funnel: v ~ 0.5 N(+mu, s^2) + 0.5 N(-mu, s^2);
    x | v ~ N(0, c e^v)."""
    sig2 = sigma * sigma

    def value_and_grad_fn(xy):
        v, x = xy[..., 0], xy[..., 1]
        terms = torch.stack([-0.5 * (v - mu) ** 2 / sig2, -0.5 * (v + mu) ** 2 / sig2], dim=-1)
        log_prior = (math.log(0.5) + torch.logsumexp(terms, dim=-1)
                     - 0.5 * math.log(2.0 * math.pi * sig2))
        inv_var = torch.exp(-v) / c
        log_cond = -0.5 * (x ** 2 * inv_var + v + math.log(2.0 * math.pi * c))
        w = torch.softmax(terms, dim=-1)
        gv = -(w[..., 0] * (v - mu) + w[..., 1] * (v + mu)) / sig2 + 0.5 * x ** 2 * inv_var - 0.5
        return log_prior + log_cond, torch.stack([gv, -x * inv_var], dim=-1)

    def log_prob_fn(xy):
        return value_and_grad_fn(xy)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        right = torch.rand((n_chains,), generator=generator, device=generator.device) < 0.5
        v = _randn(generator, (n_chains,), dtype) * sigma + torch.where(right, mu, -mu).to(dtype)
        x = _randn(generator, (n_chains,), dtype) * math.sqrt(c)
        return torch.stack([v, x], dim=-1)

    _tag(value_and_grad_fn, "multimodal_funnel_2d", 2, mu=mu, sigma=sigma, c=c)
    # Var[x] = c E[e^v] = c exp(s^2 / 2) cosh(mu) (the lognormal mixture's moment)
    var_x = c * math.exp(sig2 / 2.0) * math.cosh(mu)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=2,
        true_mean=torch.zeros(2, dtype=torch.float64),
        true_cov=torch.diag(torch.tensor([mu ** 2 + sig2, var_x], dtype=torch.float64)),
        name=f"MultimodalFunnel2D_mu{mu}",
        description="2D bimodal funnel - tests mode switching under varying curvature",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="multimodal_funnel_2d",
        params={"mu": mu, "sigma": sigma, "c": c},
    )


def multimodal_funnel_2d_sampler(mu: float = 3.0, sigma: float = 1.0, c: float = 1.0):
    """Exact i.i.d. sampler of multimodal_funnel_2d: (generator, n) -> (n, 2)
    float64."""
    def sampler(g, n):
        right = torch.rand((n,), generator=g, device=g.device) < 0.5
        v = _randn(g, (n,), torch.float64) * sigma + torch.where(right, mu, -mu).to(torch.float64)
        x = _randn(g, (n,), torch.float64) * torch.sqrt(c * torch.exp(v))
        return torch.stack([v, x], dim=-1)
    return sampler


def _on_l1_sphere(generator, n_chains, dim, dtype):
    """Directions on the unit L1 sphere: normals over their L1 norm."""
    d = _randn(generator, (n_chains, dim), dtype)
    return d / torch.sum(torch.abs(d), dim=-1, keepdim=True)


def concentric_l1_balls(dim: int = 2, radii=(4.0, 8.0, 16.0),
                        sigma: float = 0.5) -> TargetDistribution:
    """Mixture of Gaussian shells in the L1 norm:
    p ∝ sum_k exp(-(|x|_1 - r_k)^2 / (2 s^2))."""
    radii = tuple(float(r) for r in radii)
    sig2 = sigma * sigma

    def value_and_grad_fn(x):
        r = torch.tensor(radii, dtype=x.dtype, device=x.device)
        u = torch.sum(torch.abs(x), dim=-1)
        terms = -0.5 * (u[..., None] - r) ** 2 / sig2
        w = torch.softmax(terms, dim=-1)
        du = torch.sum(w * (-(u[..., None] - r) / sig2), dim=-1)
        return torch.logsumexp(terms, dim=-1), du[..., None] * torch.sign(x)

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        # on a random shell: a direction on the L1 sphere at its radius
        which = torch.randint(0, len(radii), (n_chains,), generator=generator,
                              device=generator.device)
        r = torch.tensor(radii, dtype=dtype, device=generator.device)[which]
        d = _on_l1_sphere(generator, n_chains, dim, dtype)
        return d * r[:, None] + _randn(generator, (n_chains, dim), dtype) * sigma

    _tag(value_and_grad_fn, "concentric_l1_balls", dim, radii=radii, sigma=sigma)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),   # symmetric about the origin
        true_cov=None,
        name=f"ConcentricL1_{dim}D_r{'-'.join(str(r) for r in radii)}",
        description=f"{dim}D concentric L1 shells - tests crossing low-density gaps",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="concentric_l1_balls",
        params={"radii": radii, "sigma": sigma},
    )


def nested_l1_balls(dim: int = 2, r_outer: float = 20.0, r_inner: float = 2.0,
                    mu_norm: float = 2.0, sigma: float = 0.5,
                    n_inner: int = 4) -> TargetDistribution:
    """An outer L1 shell at r_outer plus n_inner small L1 shells about the
    axis points (+m, 0, ..), (-m, 0, ..), (0, +m, ..), ... at L1 distance
    mu_norm; an even n_inner keeps the true mean at the origin."""
    sig2 = sigma * sigma
    centers = torch.zeros((n_inner + 1, dim), dtype=torch.float64)
    for j in range(n_inner):
        centers[j + 1, (j // 2) % dim] = mu_norm if j % 2 == 0 else -mu_norm
    radii = torch.tensor([r_outer] + [r_inner] * n_inner, dtype=torch.float64)

    def value_and_grad_fn(x):
        c = centers.to(dtype=x.dtype, device=x.device)
        r = radii.to(dtype=x.dtype, device=x.device)
        diff = x[..., None, :] - c
        u = torch.sum(torch.abs(diff), dim=-1)
        terms = -0.5 * (u - r) ** 2 / sig2
        du = torch.softmax(terms, dim=-1) * (-(u - r) / sig2)
        grad = torch.sum(du[..., None] * torch.sign(diff), dim=-2)
        return torch.logsumexp(terms, dim=-1), grad

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        which = torch.randint(0, n_inner + 1, (n_chains,), generator=generator,
                              device=generator.device)
        c = centers.to(dtype=dtype, device=generator.device)[which]
        r = radii.to(dtype=dtype, device=generator.device)[which]
        d = _on_l1_sphere(generator, n_chains, dim, dtype)
        return c + d * r[:, None] + _randn(generator, (n_chains, dim), dtype) * sigma

    _tag(value_and_grad_fn, "nested_l1_balls", dim, r_outer=r_outer, r_inner=r_inner,
         mu_norm=mu_norm, sigma=sigma, n_inner=n_inner)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64) if n_inner % 2 == 0 else None,
        true_cov=None,
        name=f"NestedL1_{dim}D_ro{r_outer}_ri{r_inner}",
        description=f"{dim}D nested L1 shells - tests escaping nested modes",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="nested_l1_balls",
        params={"r_outer": r_outer, "r_inner": r_inner, "mu_norm": mu_norm,
                "sigma": sigma, "n_inner": n_inner},
    )
