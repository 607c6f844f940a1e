"""Model comparison: WAIC and PSIS-LOO cross-validation (port of
``mcmc_tpu/diagnostics/model_comparison.py``).

Everything runs batched on the (draws, n_data) pointwise log-likelihood
matrix ``ll[s, i] = log p(y_i | theta_s)``: each datapoint is a column, and
the Pareto fits of all columns run together (sorts along the draws and a
fixed grid of the profile likelihood).

- WAIC: Watanabe (2010) in the elpd form of Vehtari, Gelman & Gabry (2017),
  eq. (11)-(13).
- PSIS-LOO: Vehtari, Gelman & Gabry (2017) eq. (3)-(10) and Vehtari,
  Simpson, Gelman, Yao & Gabry (2024): tail of min(0.2 S, 3 sqrt(S)) draws,
  a generalized-Pareto fit to the exceedances, the tail weights replaced by
  the fit's expected order statistics, truncated at the raw maximum; k-hat
  above 0.7 flags an unreliable datapoint.
- GPD fit: Zhang & Stephens (2009), the profile-posterior grid estimator,
  with the weak prior (M k + 10 * 0.5) / (M + 10) of Vehtari et al.
"""

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

KHAT_GOOD = 0.7


class LooResult(NamedTuple):
    """PSIS-LOO estimate: elpd (summed over the data), its standard error
    sqrt(n var(elpd_i)), p_eff = lppd - elpd, elpd_i (n,), the Pareto khat
    (n,) and the count of khat > 0.7."""
    elpd: float
    se: float
    p_eff: float
    elpd_i: Tensor
    khat: Tensor
    n_bad_khat: int


class WaicResult(NamedTuple):
    """WAIC estimate on the elpd scale; n_high_penalty counts datapoints
    with p_waic_i > 0.4, where WAIC is unreliable (Vehtari et al. 2017,
    sec. 2.2)."""
    elpd: float
    se: float
    p_eff: float
    elpd_i: Tensor
    p_waic_i: Tensor
    n_high_penalty: int


def pointwise_log_likelihood(ll_fn: Callable, samples) -> Tensor:
    """The (S, n_data) log-likelihood matrix from ll_fn: theta (dim,) ->
    (n_data,), mapped over the draws of an (S, C, dim) history or (S, dim)
    flat draws with torch.vmap."""
    samples = torch.as_tensor(samples)
    if samples.ndim == 3:
        samples = samples.reshape(-1, samples.shape[-1])
    return torch.vmap(ll_fn)(samples)


def _gpd_fit(x: Tensor):
    """Generalized-Pareto (k, sigma) fit to exceedances x > 0 along dim 0
    (any order; trailing dims are independent columns), cdf(y) = 1 - (1 +
    k y / sigma)^(-1/k). Zhang-Stephens' grid over theta = k / sigma with
    the shrinkage prior on k; all-equal exceedances give (k, mean(x)),
    never NaN."""
    x = torch.as_tensor(x)
    M = x.shape[0]
    xs = torch.sort(x, dim=0).values
    x_star = xs[(M - 1) // 4]                      # first-quartile order statistic
    x_max = xs[-1]
    m_grid = 30 + int(np.floor(np.sqrt(M)))
    j = torch.arange(1, m_grid + 1, dtype=x.dtype, device=x.device)
    grid = (1.0 - torch.sqrt(m_grid / (j - 0.5))).reshape((m_grid,) + (1,) * (x.ndim - 1))
    x_star = torch.maximum(x_star, 1e-12 * torch.clamp(x_max, min=1.0))
    theta = 1.0 / x_max + grid / (3.0 * x_star)    # (G, ...)
    one_m = torch.clamp(1.0 - theta[:, None] * xs[None], min=1e-30)
    k_prof = -torch.mean(torch.log(one_m), dim=1)
    # k(theta) carries theta's sign; guard only its k -> 0 neighbourhood
    tiny = torch.where(k_prof < 0, -1e-12, 1e-12).to(k_prof.dtype)
    k_safe = torch.where(torch.abs(k_prof) < 1e-12, tiny, k_prof)
    log_lik = M * (torch.log(torch.abs(theta / k_safe)) + k_prof - 1.0)
    w = torch.exp(log_lik - torch.max(log_lik, dim=0).values)
    w = w / torch.sum(w, dim=0)
    theta_hat = torch.sum(w * theta, dim=0)
    # the standard-convention shape (Zhang-Stephens' k has the other sign)
    k_hat = torch.mean(torch.log(torch.clamp(1.0 - theta_hat * xs, min=1e-30)), dim=0)
    sigma_hat = -k_hat / theta_hat
    k_hat = (M * k_hat + 10.0 * 0.5) / (M + 10.0)
    sigma_hat = torch.where(torch.isfinite(sigma_hat) & (sigma_hat > 0.0), sigma_hat,
                            torch.mean(xs, dim=0))
    return k_hat, sigma_hat


def _gpd_quantile(q, k, sigma) -> Tensor:
    """Inverse cdf of the generalized Pareto, sigma / k ((1 - q)^-k - 1),
    -sigma log(1 - q) as k -> 0."""
    q, k, sigma = (torch.as_tensor(v) for v in (q, k, sigma))
    small = torch.abs(k) < 1e-6
    k_safe = torch.where(small, torch.ones_like(k), k)
    main = sigma / k_safe * (torch.pow(1.0 - q, -k_safe) - 1.0)
    return torch.where(small, -sigma * torch.log1p(-q), main)


def _psis(lr: Tensor, n_tail: int):
    """Pareto-smooth each column of raw log importance ratios (S, n).
    Returns the self-normalized smoothed log-weights and khat (n,); a
    column whose tail is flat keeps its raw weights with khat = -inf."""
    S = lr.shape[0]
    lr = lr - torch.max(lr, dim=0).values
    order = torch.argsort(lr, dim=0, stable=True)
    sorted_lr = torch.gather(lr, 0, order)
    cutoff = torch.exp(sorted_lr[S - n_tail - 1])
    exceed = torch.exp(sorted_lr[S - n_tail:]) - cutoff
    degenerate = exceed[-1] <= 0.0
    ranks = torch.arange(1, n_tail + 1, dtype=lr.dtype, device=lr.device)[:, None]
    khat, sigma = _gpd_fit(torch.where(degenerate, ranks, exceed))
    q = (ranks - 0.5) / n_tail
    smoothed = torch.clamp(cutoff + _gpd_quantile(q, khat, sigma), max=1.0)
    new_sorted = torch.cat([sorted_lr[:S - n_tail],
                            torch.log(torch.clamp(smoothed, min=1e-300))])
    new_lr = torch.zeros_like(lr).scatter_(0, order, new_sorted)
    new_lr = torch.where(degenerate, lr, new_lr)
    khat = torch.where(degenerate, -math.inf, khat)
    return new_lr - torch.logsumexp(new_lr, dim=0), khat


def _as_matrix(ll) -> Tensor:
    ll = torch.as_tensor(ll)
    return ll.reshape(-1, ll.shape[-1]) if ll.ndim == 3 else ll


def _lppd_i(ll: Tensor) -> Tensor:
    return torch.logsumexp(ll, dim=0) - math.log(ll.shape[0])


def _host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def psis_loo(ll) -> LooResult:
    """PSIS-LOO: leave-one-out elpd from one posterior sample. ll: (S, n)
    (or a (draws, chains, n) history); the ratios 1 / p(y_i | theta_s) are
    Pareto-smoothed per datapoint; trust elpd_i where khat < 0.7."""
    ll = _as_matrix(ll)
    S, n = ll.shape
    if S < 25:
        raise ValueError(f"PSIS needs >= 25 draws, got {S}")
    n_tail = int(min(np.ceil(0.2 * S), np.ceil(3.0 * np.sqrt(S))))
    lw, khat = _psis(-ll, n_tail)
    elpd_i = torch.logsumexp(ll + lw, dim=0)
    e = _host(elpd_i)
    elpd = float(e.sum())
    return LooResult(elpd, float(np.sqrt(n * np.var(e))), float(_host(_lppd_i(ll)).sum() - elpd),
                     elpd_i, khat, int((_host(khat) > KHAT_GOOD).sum()))


def waic(ll) -> WaicResult:
    """WAIC on the elpd scale: lppd_i - var_s(ll_si), summed over the data."""
    ll = _as_matrix(ll)
    p_i = torch.var(ll, dim=0, correction=1)
    elpd_i = _lppd_i(ll) - p_i
    e, p = _host(elpd_i), _host(p_i)
    return WaicResult(elpd=float(e.sum()), se=float(np.sqrt(e.shape[0] * np.var(e))),
                      p_eff=float(p.sum()), elpd_i=elpd_i, p_waic_i=p_i,
                      n_high_penalty=int((p > 0.4).sum()))


def compare(results: Dict[str, LooResult]) -> Dict:
    """Rank models on the same data by elpd, best first, with d_elpd and
    its paired standard error d_se against the best (Vehtari et al. 2017
    eq. 24). Returns {"ranking": [...], "table": {name: {elpd, se, p_eff,
    d_elpd, d_se, n_bad_khat}}}."""
    if not results:
        raise ValueError("compare() needs at least one model")
    lens = {torch.as_tensor(r.elpd_i).shape[0] for r in results.values()}
    if len(lens) != 1:
        raise ValueError(f"models were evaluated on different data sizes: {lens}")
    ranking = sorted(results, key=lambda m: results[m].elpd, reverse=True)
    best_i = _host(torch.as_tensor(results[ranking[0]].elpd_i))
    n = best_i.shape[0]
    table = {}
    for name in ranking:
        r = results[name]
        diff = _host(torch.as_tensor(r.elpd_i)) - best_i
        table[name] = {
            "elpd": float(r.elpd), "se": float(r.se), "p_eff": float(r.p_eff),
            "d_elpd": float(diff.sum()), "d_se": float(np.sqrt(n * np.var(diff))),
            "n_bad_khat": int(getattr(r, "n_bad_khat", 0)),
        }
    return {"ranking": ranking, "table": table}
