"""Convergence diagnostics as batched tensor reductions (port of
``mcmc_tpu/diagnostics/rhat_ess.py``): split R-hat, bulk, tail and mean
ESS, and the MCSE of the mean.

Vehtari, Gelman, Simpson, Carpenter & Buerkner (2021): split chains in half,
rank-normalize with the (r - 3/8)/(S + 1/4) normal-scores transform, R-hat as
the max of the bulk and folded statistics, ESS from the FFT autocovariance
with Geyer's initial monotone sequence. Everything is vectorized over the
trailing dim axis and runs where the samples live.

Sample layout: (num_samples, n_chains, dim).
"""

import math

import torch
from torch.special import ndtri

Tensor = torch.Tensor


def _split_chains(x: Tensor) -> Tensor:
    """(n, m, d) -> (n//2, 2m, d): split each chain into halves."""
    half = x.shape[0] // 2
    return torch.cat([x[:half], x[half:2 * half]], dim=1)


def _z_from_rank2(k: Tensor, N: int) -> Tensor:
    """z = ndtri((rank - 3/8) / (N + 1/4)) from k = 2 * rank (integer), in
    float64.

    Two-sided so the upper tail stays finite: near u = 1 the ratio would
    round to 1.0 (ndtri -> +inf), so it is computed from the exact integer
    complement 2N - k.
      u     = (k - 0.75)        / (2N + 0.5)
      1 - u = (2N - k + 1.25)   / (2N + 0.5)
    """
    denom = 2.0 * N + 0.5
    z_low = ndtri((k.to(torch.float64) - 0.75) / denom)
    z_high = -ndtri(((2 * N - k).to(torch.float64) + 1.25) / denom)
    return torch.where(k <= N, z_low, z_high)


def _rank_normalize(x: Tensor) -> Tensor:
    """Normal scores of pooled average ranks, per trailing dim.

    Average ranks for ties match scipy.stats.rankdata(method='average'): in
    sort order an element's tie run spans [lo, hi) with lo and hi its left
    and right insertion points, so 2 * (1-based average rank) = lo + hi + 1.
    Each dim is sorted as one contiguous row; the scores go back to the
    original order with a scatter.
    """
    n, m, d = x.shape
    N = n * m
    rows = x.reshape(N, d).T.contiguous()                  # (d, N)
    srt, perm = torch.sort(rows, dim=1)
    k2 = (torch.searchsorted(srt, srt, side="left")
          + torch.searchsorted(srt, srt, side="right") + 1)
    z_sorted = _z_from_rank2(k2, N).to(rows.dtype)
    z = torch.empty_like(rows).scatter_(1, perm, z_sorted)
    return z.T.reshape(n, m, d)


def _median0(flat: Tensor) -> Tensor:
    """Median along axis 0, the mean of the two middle values for an even
    count (numpy's definition; torch.median returns the lower one)."""
    s = torch.sort(flat, dim=0).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def _rhat_classic(x: Tensor) -> Tensor:
    """Classic split-R-hat on (n, m, d), already split/transformed: (d,)."""
    n = x.shape[0]
    chain_means = torch.mean(x, dim=0)
    W = torch.mean(torch.var(x, dim=0, correction=1), dim=0)
    B = n * torch.var(chain_means, dim=0, correction=1)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / W)


def split_rhat(samples: Tensor) -> Tensor:
    """Rank-normalized split R-hat, max of bulk and folded: (S, C, D) -> (D,)."""
    x = _split_chains(samples)
    z_bulk = _rank_normalize(x)
    folded = torch.abs(x - _median0(x.reshape(-1, x.shape[-1])))
    z_tail = _rank_normalize(folded)
    return torch.maximum(_rhat_classic(z_bulk), _rhat_classic(z_tail))


def _autocovariance_fft(x: Tensor) -> Tensor:
    """Biased autocovariance per chain via FFT: (n, m, d) -> (n, m, d)."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    size = 1 << (2 * n - 1).bit_length()   # >= 2n: linear, not circular
    f = torch.fft.rfft(xc, n=size, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=0)[:n]
    return acov / n


def _ess_combine(mean_var, mean_acov, var_chain_means, n: int,
                 total_chains: int) -> Tensor:
    """ESS from per-chain moments (Geyer initial monotone sequence).

    mean_var: (d,) mean over chains of unbiased per-chain variances (W).
    mean_acov: (n, d) mean over chains of biased autocovariances.
    var_chain_means: (d,) ddof=1 variance over chains of per-chain means.
    Shared by ess_bulk and the chain-chunked streaming path.
    """
    d = mean_acov.shape[-1]
    var_plus = mean_var * (n - 1.0) / n + var_chain_means
    rho = 1.0 - (mean_var[None, :] - mean_acov) / var_plus[None, :]
    rho[0] = 1.0

    n_pairs = n // 2
    P = rho[: 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)   # Geyer pairs
    # initial positive sequence (always keeping k = 0), then its running min
    pos = P > 0.0
    pos[0] = True
    valid = torch.cumprod(pos.to(torch.int32), dim=0).to(torch.bool)
    P_mono = torch.cummin(torch.where(valid, P, math.inf), dim=0).values
    P_used = torch.where(valid, P_mono, 0.0)
    tau = torch.clamp(-1.0 + 2.0 * torch.sum(P_used, dim=0),
                      min=1.0 / math.log10(n * total_chains + 10.0))
    ess = n * total_chains / tau
    return torch.where(var_plus > 0, ess,
                       torch.full_like(ess, float(n * total_chains)))


def _ess_core(x: Tensor) -> Tensor:
    """ESS of (n, m, d) split chains: (d,)."""
    n, m, _ = x.shape
    acov = _autocovariance_fft(x)
    mean_var = torch.mean(acov[0] * n / (n - 1.0), dim=0)
    mean_acov = torch.mean(acov, dim=1)
    var_chain_means = torch.var(torch.mean(x, dim=0), dim=0, correction=1)
    return _ess_combine(mean_var, mean_acov, var_chain_means, n, m)


def ess_bulk(samples: Tensor) -> Tensor:
    """Bulk ESS: ESS of rank-normalized split chains. (S, C, D) -> (D,)."""
    return _ess_core(_rank_normalize(_split_chains(samples)))


def _quantile0(flat: Tensor, q: float) -> Tensor:
    """Quantile q along axis 0 by linear interpolation between order
    statistics at q (n - 1), as jnp.quantile's default method weighs them.
    Sorted here rather than by torch.quantile, which refuses inputs past
    2^24 elements (a 10,000-draw x 1,024-chain column has 10.2M)."""
    s = torch.sort(flat, dim=0).values
    n = s.shape[0]
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def ess_tail(samples: Tensor) -> Tensor:
    """Tail ESS: the smaller ESS of the 5% and 95% quantile indicator
    series of the split chains. (S, C, D) -> (D,)."""
    x = _split_chains(samples)
    flat = x.reshape(-1, x.shape[-1])
    ess = [_ess_core((x <= _quantile0(flat, q)).to(flat.dtype)) for q in (0.05, 0.95)]
    return torch.minimum(*ess)


def ess_mean(samples: Tensor) -> Tensor:
    """ESS of the raw split draws (the 'mean' method), used for the MCSE."""
    return _ess_core(_split_chains(samples))


def mcse_mean(samples: Tensor) -> Tensor:
    """Monte Carlo standard error of the mean: sd (ddof 1, over every draw)
    / sqrt(ess_mean)."""
    flat = samples.reshape(-1, samples.shape[-1])
    return torch.std(flat, dim=0, correction=1) / torch.sqrt(ess_mean(samples))
