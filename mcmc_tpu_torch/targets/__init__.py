"""Target distributions, first slice (port of ``mcmc_tpu/targets/__init__.py``).

Each target carries a batched analytic value-and-grad, an ``init_sampler``
taking a ``torch.Generator``, and a ``kernel_info`` tag
``{"family", "dim", "params"}`` on its value-and-grad closure — the
counterpart of the JAX package's ``pallas_info``, and what the fused kernels
dispatch on (``mcmc_tpu_torch.ops.padded_targets``).

Ported: every target of the JAX package. ``standard_normal``, ``neals_funnel``,
``neals_funnel_noncentered`` (the ChEES row's target, with
``funnel_transform``), ``ill_conditioned_gaussian``, ``student_t``,
``log_gamma`` (support "positive"), ``correlated_gaussian`` (the
dense-metric NUTS row's target), ``gaussian_mixture`` (the tempered and SMC
rows' target) and ``hierarchical_logistic`` (BASELINE config 5,
``targets/hierarchical.py``; its tag carries the data set X and y),
``rosenbrock`` (its ground truth a cached classic-NUTS run,
``targets/rosenbrock_reference.py``), the RAHMC paper's
``multimodal_funnel_2d``, ``concentric_l1_balls`` and ``nested_l1_balls``
(``targets/rahmc_paper.py``; ``get_target`` names ``multimodal_funnel_2d``,
``concentric_l1_{2,3}d`` and ``nested_l1_{2,3}d``), and the
``unconstrain_target`` layer: ``<name>_unconstrained`` is the
log-transformed reparameterization of a positive-support target
(``log_gamma_unconstrained``, tagged for the kernels, or a generic
chain-rule wrapper without a tag). ``get_target`` raises for every other
name; ``get_reference_sampler`` gives the exact i.i.d. samplers of the
ported targets that have one.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

LOG_2PI = math.log(2.0 * math.pi)


class TargetDistribution(NamedTuple):
    """Target specification, with the JAX package's TargetDistribution
    fields and defaults.

    transform: an optional map from the sampled coordinates to the
    coordinates of interest (a non-centered or unconstrained
    parameterization), transform_target the registered target whose exact
    sampler lives in the transformed coordinates. support: "real" or
    "positive" (x > 0 coordinate-wise; unconstrain_target builds the
    log-transformed target from it). transform_true_mean/cov: the analytic
    moments of transform(samples), set by reparameterized targets."""
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
    transform: Optional[Callable] = None
    transform_target: Optional[str] = None
    support: str = "real"
    transform_true_mean: Optional[torch.Tensor] = None
    transform_true_cov: Optional[torch.Tensor] = None


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


def funnel_transform(y: torch.Tensor) -> torch.Tensor:
    """Map non-centered funnel draws y = (v, z) to centered funnel
    coordinates x = (v, z exp(v / 2)); batched over leading axes."""
    v = y[..., :1]
    return torch.cat([v, y[..., 1:] * torch.exp(v / 2.0)], dim=-1)


def neals_funnel_noncentered(dim: int = 10) -> TargetDistribution:
    """Neal's funnel, non-centered: sample v ~ N(0, 9) and z_i ~ N(0, 1)
    i.i.d. (a diagonal Gaussian) and recover funnel draws with
    funnel_transform (x0 = v, x_i = z_i exp(v / 2)), which has the funnel's
    exact moments. Gradients: d/dv = -v / 9, d/dz_i = -z_i."""
    d_rest = dim - 1
    log_2pi9 = math.log(2.0 * math.pi * 9.0)

    def value_and_grad_fn(y):
        v = y[..., 0]
        z = y[..., 1:]
        lp = (-0.5 * (v * v / 9.0 + log_2pi9)
              - 0.5 * (torch.sum(z * z, dim=-1) + d_rest * LOG_2PI))
        return lp, torch.cat([(-v / 9.0)[..., None], -z], dim=-1)

    def log_prob_fn(y):
        return value_and_grad_fn(y)[0]

    true_cov_diag = torch.cat([torch.tensor([9.0], dtype=torch.float64),
                               torch.ones(dim - 1, dtype=torch.float64)])
    _tag(value_and_grad_fn, "neals_funnel_noncentered", dim)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=torch.diag(true_cov_diag),
        name=f"NealsFunnelNonCentered{dim}D",
        description=(f"{dim}D Neal's funnel, non-centered parameterization - "
                     f"same funnel moments via funnel_transform"),
        value_and_grad_fn=value_and_grad_fn,
        family="neals_funnel_noncentered",
        params={},
        transform=funnel_transform,
        transform_target="neals_funnel",
    )


def ill_conditioned_gaussian(dim: int = 10,
                             condition_number: float = 100.0) -> TargetDistribution:
    """Diagonal Gaussian with eigenvalues linspace(1, kappa, D):
    grad = -x / lambda."""
    eigenvalues = torch.linspace(1.0, condition_number, dim, dtype=torch.float64)
    inv_eig = 1.0 / eigenvalues
    log_det_cov = float(torch.sum(torch.log(eigenvalues)))

    def value_and_grad_fn(x):
        sigma_inv_x = x * inv_eig.to(device=x.device, dtype=x.dtype)
        mahal = torch.sum(sigma_inv_x * x, dim=-1)
        lp = -0.5 * (mahal + log_det_cov + x.shape[-1] * LOG_2PI)
        return lp, -sigma_inv_x

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    _tag(value_and_grad_fn, "ill_conditioned_gaussian", dim,
         condition_number=condition_number)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=torch.diag(eigenvalues),
        name=f"IllConditioned{dim}D_kappa{int(condition_number)}",
        description=f"{dim}D Gaussian with kappa={condition_number} - tests ill-conditioning",
        value_and_grad_fn=value_and_grad_fn,
        family="ill_conditioned_gaussian",
        params={"condition_number": condition_number},
    )


def student_t_log_norm(df: float) -> float:
    """log of the Student-t(df) density's normalizer, in double."""
    return (math.lgamma((df + 1.0) / 2.0) - math.lgamma(df / 2.0)
            - 0.5 * math.log(df * math.pi))


def student_t(dim: int = 10, df: float = 3.0) -> TargetDistribution:
    """Independent Student-t(df) per coordinate:
    grad_i = -(df + 1) x_i / (df + x_i^2)."""
    log_norm = student_t_log_norm(df)

    def value_and_grad_fn(x):
        lp = (x.shape[-1] * log_norm
              - ((df + 1.0) / 2.0) * torch.sum(torch.log1p(x * x / df), dim=-1))
        return lp, -(df + 1.0) * x / (df + x * x)

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        # overdispersed (sd 2) to cover the heavy tails, as the JAX package's
        return _randn(generator, (n_chains, dim), dtype) * 2.0

    true_cov = (torch.eye(dim, dtype=torch.float64) * (df / (df - 2.0))
                if df > 2 else None)
    _tag(value_and_grad_fn, "student_t", dim, df=df)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.zeros(dim, dtype=torch.float64),
        true_cov=true_cov,
        name=f"StudentT{dim}D_df{df}",
        description=(f"{dim}D independent Student-t(df={df}) - tests heavy tails "
                     f"and non-Gaussian geometry"),
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="student_t",
        params={"df": df},
    )


def gamma_log_norm(shape: float, rate: float) -> float:
    """log Z of the Gamma(shape, rate) density as the JAX package writes it,
    gammaln(shape) + shape log(rate), in double."""
    return math.lgamma(shape) + shape * math.log(rate)


def standard_gamma(generator: torch.Generator, shape: float, size,
                   dtype=torch.float64) -> torch.Tensor:
    """Gamma(shape, 1) draws from `generator` on its device (Marsaglia and
    Tsang's squeeze-free rejection, in float64; shape < 1 through
    Gamma(shape + 1) U^(1 / shape)). The rounds of the rejection loop read
    one count back to the host each."""
    boost = shape < 1.0
    d = (shape + 1.0 if boost else shape) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    dev = generator.device
    out = torch.empty(size, dtype=torch.float64, device=dev).reshape(-1)
    todo = torch.arange(out.numel(), device=dev)
    while todo.numel():
        z = torch.randn(todo.numel(), generator=generator, device=dev, dtype=torch.float64)
        u = torch.rand(todo.numel(), generator=generator, device=dev, dtype=torch.float64)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(out.shape, generator=generator, device=dev, dtype=torch.float64)
        out = out * u ** (1.0 / shape)
    return out.reshape(size).to(dtype)


def log_gamma(dim: int = 10, shape: float = 2.0, rate: float = 1.0) -> TargetDistribution:
    """Independent Gamma(shape, rate) per coordinate, -inf outside x > 0
    (the log(max(x, 1e-10)) clamp of the JAX package): grad_i = (shape - 1)
    1{x_i > eps} / max(x_i, eps) - rate, zero when any coordinate is
    non-positive."""
    eps = 1e-10
    log_normalizer = gamma_log_norm(shape, rate)

    def value_and_grad_fn(x):
        valid = torch.all(x > 0, dim=-1)
        xc = torch.clamp(x, min=eps)
        log_pdf = (shape - 1.0) * torch.log(xc) - rate * x - log_normalizer
        lp = torch.where(valid, torch.sum(log_pdf, dim=-1),
                         torch.full_like(log_pdf[..., 0], -math.inf))
        g = (shape - 1.0) * torch.where(x > eps, 1.0 / xc, torch.zeros_like(x)) - rate
        return lp, torch.where(valid[..., None], g, torch.zeros_like(g))

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        return standard_gamma(generator, shape, (n_chains, dim), dtype) / rate

    _tag(value_and_grad_fn, "log_gamma", dim, shape=shape, rate=rate)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.full((dim,), shape / rate, dtype=torch.float64),
        true_cov=torch.eye(dim, dtype=torch.float64) * (shape / rate ** 2),
        name=f"LogGamma{dim}D_shape{shape}_rate{rate}",
        description=f"{dim}D independent Gamma - tests heavy tails and asymmetry",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="log_gamma",
        params={"shape": shape, "rate": rate},
        support="positive",
    )


def _digamma_trigamma(x: float):
    """(digamma(x), trigamma(x)) for x > 0 in double: the recurrences up to
    x >= 20, then the asymptotic series (error below 1e-16 there)."""
    psi, psi1 = 0.0, 0.0
    while x < 20.0:
        psi -= 1.0 / x
        psi1 += 1.0 / (x * x)
        x += 1.0
    z2 = 1.0 / (x * x)
    psi += (math.log(x) - 0.5 / x
            - z2 * (1.0 / 12 - z2 * (1.0 / 120 - z2 * (1.0 / 252 - z2 * (1.0 / 240
                                                                      - z2 / 132)))))
    psi1 += (1.0 / x + 0.5 * z2
             + z2 / x * (1.0 / 6 - z2 * (1.0 / 30 - z2 * (1.0 / 42 - z2 * (1.0 / 30
                                                                         - z2 * 5.0 / 66)))))
    return psi, psi1


def exp_transform(y: torch.Tensor) -> torch.Tensor:
    """Map unconstrained draws y back to the positive orthant, x = e^y."""
    return torch.exp(y)


def unconstrain_target(target: TargetDistribution,
                       registry_name: Optional[str] = None) -> TargetDistribution:
    """The log-transformed reparameterization of a positive-support target
    (Stan's transform layer): sample y = log x over R^D with log p_y(y) =
    log p_x(e^y) + sum(y), and map draws back with exp. A support="real"
    target comes back unchanged.

    For log_gamma the density is analytic (expGamma): lp = sum(shape y -
    rate e^y) - D log Z, E[y] = digamma(shape) - log(rate), Var[y] =
    trigamma(shape), tagged "log_gamma_unconstrained" for the fused
    kernels. Any other positive-support target gets a chain-rule wrapper
    (grad_y = grad_x(e^y) e^y + 1) with no tag, so it runs eager.
    registry_name: the registry key of `target`, whose exact sampler lives
    in the transformed coordinates."""
    if target.support == "real":
        return target
    if target.support != "positive":
        raise ValueError(f"No unconstraining transform for support="
                         f"{target.support!r} (target {target.name})")
    dim = target.dim
    if target.family == "log_gamma":
        shape, rate = target.params["shape"], target.params["rate"]
        log_normalizer = gamma_log_norm(shape, rate)

        def value_and_grad_fn(y):
            ey = torch.exp(y)
            lp = torch.sum(shape * y - rate * ey, dim=-1) - dim * log_normalizer
            return lp, shape - rate * ey

        _tag(value_and_grad_fn, "log_gamma_unconstrained", dim, shape=shape, rate=rate)
        psi, psi1 = _digamma_trigamma(shape)
        true_mean = torch.full((dim,), psi - math.log(rate), dtype=torch.float64)
        true_cov = torch.eye(dim, dtype=torch.float64) * psi1
        family = "log_gamma_unconstrained"
    else:
        base_vag = target.value_and_grad_fn

        def value_and_grad_fn(y):
            x = torch.exp(y)
            lp_x, g_x = base_vag(x)
            return lp_x + torch.sum(y, dim=-1), g_x * x + 1.0

        true_mean = true_cov = None
        family = f"{target.family}_unconstrained"

    def log_prob_fn(y):
        return value_and_grad_fn(y)[0]

    init_sampler = None
    if target.init_sampler is not None:
        base_init = target.init_sampler

        def init_sampler(generator, n_chains, dtype=torch.float32):
            return torch.log(torch.clamp(base_init(generator, n_chains, dtype), min=1e-12))

    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=true_mean,
        true_cov=true_cov,
        name=f"{target.name}_log",
        description=(f"log-transformed (unconstrained) reparameterization "
                     f"of {target.name}; draws map back via exp"),
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family=family,
        params=dict(target.params),
        transform=exp_transform,
        transform_target=registry_name,
        support="real",
        transform_true_mean=target.true_mean,
        transform_true_cov=target.true_cov,
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


def rosenbrock(dim: int = 10, scale: float = 0.1) -> TargetDistribution:
    """Rosenbrock density: log p = -sum[(1 - x_i)^2 + a (x_{i+1} - x_i^2)^2],
    a = 1 / scale^2.

    dU/dx_i = -2 (1 - x_i) - 4 a x_i (x_{i+1} - x_i^2)   for i < D - 1
              + 2 a (x_i - x_{i-1}^2)                     for i > 0.
    No exact sampler: its ground truth is a long classic-NUTS run
    (targets/rosenbrock_reference.py)."""
    a = 1.0 / (scale ** 2)

    def value_and_grad_fn(x):
        x_cur, x_next = x[..., :-1], x[..., 1:]
        resid = x_next - x_cur ** 2
        u = torch.sum((1.0 - x_cur) ** 2 + a * resid ** 2, dim=-1)
        zeros = torch.zeros_like(x[..., :1])
        du_fwd = torch.cat([-2.0 * (1.0 - x_cur) - 4.0 * a * x_cur * resid, zeros], dim=-1)
        du_bwd = torch.cat([zeros, 2.0 * a * resid], dim=-1)
        return -u, -(du_fwd + du_bwd)

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(generator, n_chains, dtype=torch.float32):
        # near the mode (1, ..., 1), as the JAX package starts
        return 1.0 + _randn(generator, (n_chains, dim), dtype) * 0.5

    _tag(value_and_grad_fn, "rosenbrock", dim, scale=scale)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=torch.ones(dim, dtype=torch.float64),   # the mode as a proxy
        true_cov=None,
        name=f"Rosenbrock{dim}D_scale{scale}",
        description=f"{dim}D Rosenbrock(scale={scale}) - tests curved valleys and "
                    f"non-linear geometry",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="rosenbrock",
        params={"scale": scale},
    )


from mcmc_tpu_torch.targets.hierarchical import hierarchical_logistic  # noqa: E402
from mcmc_tpu_torch.targets.rahmc_paper import (  # noqa: E402
    concentric_l1_balls, multimodal_funnel_2d, multimodal_funnel_2d_sampler, nested_l1_balls)

_TARGETS = {
    "standard_normal": standard_normal,
    "neals_funnel": neals_funnel,
    "neals_funnel_noncentered": neals_funnel_noncentered,
    "ill_conditioned_gaussian": ill_conditioned_gaussian,
    "student_t": student_t,
    "log_gamma": log_gamma,
    "correlated_gaussian": correlated_gaussian,
    "gaussian_mixture": gaussian_mixture,
    "hierarchical_logistic": hierarchical_logistic,
    "rosenbrock": rosenbrock,
    # the RAHMC paper's targets, at the JAX package's fixed parameters
    # (mcmc_tpu/targets/__init__.py:625-629)
    "multimodal_funnel_2d": lambda dim=2, **kw: multimodal_funnel_2d(mu=3.0, sigma=1.0, c=1.0),
    "concentric_l1_2d": lambda dim=2, **kw: concentric_l1_balls(
        dim=2, radii=(4.0, 8.0, 16.0), sigma=0.5),
    "concentric_l1_3d": lambda dim=3, **kw: concentric_l1_balls(
        dim=3, radii=(4.0, 8.0, 16.0), sigma=0.5),
    "nested_l1_2d": lambda dim=2, **kw: nested_l1_balls(
        dim=2, r_outer=20.0, r_inner=2.0, mu_norm=2.0, sigma=0.5, n_inner=4),
    "nested_l1_3d": lambda dim=3, **kw: nested_l1_balls(
        dim=3, r_outer=20.0, r_inner=2.0, mu_norm=2.0, sigma=0.5, n_inner=4),
}


def get_target(name: str, dim: int = 10, **kwargs) -> TargetDistribution:
    """A ported target by name (keyword parameters go to its factory);
    '<name>_unconstrained' is unconstrain_target of the target <name>.
    Raises ValueError for any other name."""
    if name.endswith("_unconstrained"):
        base = name[:-len("_unconstrained")]
        return unconstrain_target(get_target(base, dim=dim, **kwargs), registry_name=base)
    if name not in _TARGETS:
        raise ValueError(f"Unknown target '{name}'. "
                         f"Available: {sorted(_TARGETS)}")
    return _TARGETS[name](dim=dim, **kwargs)


def get_reference_sampler(name: str, dim: int = 10, **kwargs):
    """Exact i.i.d. sampler (generator, n) -> (n, dim) float64 of a ported
    target, or None where it has none (the hierarchical posterior, a mixture
    of other than two modes, the L1 shells; Rosenbrock without a cached
    reference run, whose sampler draws from that run), as the JAX package's
    get_reference_sampler
    (`mcmc_tpu/targets/__init__.py:655`). The draws come from the
    generator, so they are the JAX sampler's in distribution, not in value.
    '<name>_unconstrained' samples log x from the base target's exact draws,
    clamped at finfo(float64).tiny (the JAX package's 1e-300 clamp, which
    does nothing in float32, is a known fault there)."""
    def normal(g, shape):
        return _randn(g, shape, torch.float64)

    if name.endswith("_unconstrained"):
        inner = get_reference_sampler(name[:-len("_unconstrained")], dim, **kwargs)
        if inner is None:
            return None

        def logged(g, n):
            x = inner(g, n)
            return torch.log(torch.clamp(x, min=torch.finfo(x.dtype).tiny))
        return logged
    if name == "standard_normal":
        return lambda g, n: normal(g, (n, dim))
    if name == "correlated_gaussian":
        rho = kwargs.get("correlation", 0.9)
        cov = (1.0 - rho) * torch.eye(dim, dtype=torch.float64) + rho
        chol = torch.linalg.cholesky(cov)
        return lambda g, n: normal(g, (n, dim)) @ chol.to(g.device).T
    if name == "ill_conditioned_gaussian":
        kappa = kwargs.get("condition_number", 100.0)
        scales = torch.sqrt(torch.linspace(1.0, kappa, dim, dtype=torch.float64))
        return lambda g, n: normal(g, (n, dim)) * scales.to(g.device)
    if name == "student_t":
        df = kwargs.get("df", 3.0)

        def student(g, n):
            z = normal(g, (n, dim))
            chi2 = standard_gamma(g, df / 2.0, (n, 1)) * 2.0
            return z / torch.sqrt(chi2 / df)
        return student
    if name == "log_gamma":
        shape, rate = kwargs.get("shape", 2.0), kwargs.get("rate", 1.0)
        return lambda g, n: standard_gamma(g, shape, (n, dim)) / rate
    if name == "neals_funnel":
        def funnel(g, n):
            v = normal(g, (n,)) * 3.0
            rest = normal(g, (n, dim - 1)) * torch.exp(v / 2.0)[:, None]
            return torch.cat([v[:, None], rest], dim=1)
        return funnel
    if name == "neals_funnel_noncentered":
        def noncentered(g, n):
            v = normal(g, (n, 1)) * 3.0
            return torch.cat([v, normal(g, (n, dim - 1))], dim=1)
        return noncentered
    if name == "gaussian_mixture":
        if kwargs.get("n_modes", 2) != 2:
            return None
        half_sep = kwargs.get("separation", 5.0) / 2.0

        def mixture(g, n):
            right = torch.rand((n,), generator=g, device=g.device) < 0.5
            x0 = normal(g, (n,)) + half_sep * (2.0 * right.to(torch.float64) - 1.0)
            return torch.cat([x0[:, None], normal(g, (n, dim - 1))], dim=1)
        return mixture
    if name == "multimodal_funnel_2d":
        return multimodal_funnel_2d_sampler(mu=kwargs.get("mu", 3.0),
                                            sigma=kwargs.get("sigma", 1.0),
                                            c=kwargs.get("c", 1.0))
    if name == "rosenbrock":
        # no exact sampler: draws without replacement from the cached
        # long classic-NUTS run, where one exists for this dim and scale
        from mcmc_tpu_torch.targets.rosenbrock_reference import load_rosenbrock_reference
        reference = load_rosenbrock_reference(dim, scale=kwargs.get("scale", 0.1))
        if reference is None:
            return None

        def cached(g, n):
            idx = torch.randperm(reference.shape[0], generator=g, device=g.device)[:n]
            return reference.to(g.device)[idx]
        return cached
    return None


def has_reference_sampler(name: str) -> bool:
    """Whether get_reference_sampler(name) gives a sampler (with the
    factory's default parameters): the JAX package's answer for every
    target (`mcmc_tpu/targets/__init__.py:751`), '<name>_unconstrained'
    included; True for `rosenbrock`, whose sampler exists only where its
    cached reference run does, as in the JAX package."""
    if name.endswith("_unconstrained"):
        return has_reference_sampler(name[:-len("_unconstrained")])
    return name in ("standard_normal", "correlated_gaussian", "ill_conditioned_gaussian",
                    "student_t", "log_gamma", "neals_funnel", "neals_funnel_noncentered",
                    "gaussian_mixture", "rosenbrock", "multimodal_funnel_2d")
