"""Chain-chunked (streaming) diagnostics for large histories (port of
``mcmc_tpu/diagnostics/streaming.py``: bulk, tail and mean ESS, split R-hat,
the MCSE of the mean and ``compute_diagnostics_chunked``). The JAX
package's per-dim-sharded path for a history sharded over a device mesh has
no counterpart: the port's chain-sharded runs (``parallel.fused_sharded``)
return their histories gathered on every rank, and a history sharded as a
DTensor is gathered first.

At the main path's size — a (192, 65536, 50) float32 history, 2.5 GB — the
pooled rank normalization runs once per block of dims, and the ESS / R-hat
moments (chain means, unbiased chain variances, chain-averaged
autocovariance) accumulate over chunks of chains, then combine with the same
formulas as the monolithic estimators: chunked == monolithic up to
summation order.
"""

import torch

import numpy as np

from mcmc_tpu_torch.diagnostics.rhat_ess import (
    _autocovariance_fft, _ess_combine, _median0, _quantile0, _rank_normalize,
    _split_chains,
)

DEFAULT_CHAIN_CHUNK = 8192
DEFAULT_DIM_CHUNK = 8


def _as_history(samples):
    """The (S, C, D) history as a tensor (numpy arrays are taken as they
    are); a history sharded over a device mesh (a DTensor) is gathered."""
    if hasattr(samples, "device_mesh"):
        samples = samples.full_tensor()
    return torch.as_tensor(samples)


def _chunk_moments(z_chunk, center):
    """Sums over the chunk's 2c split chains of chain variance,
    autocovariance, chain mean, squared chain mean and ddof=1 chain variance,
    plus the split-chain count. Values are centred first so the one-pass
    sum / sum-of-squares stays accurate in float32 when |mean| >> sd."""
    x = _split_chains(z_chunk) - center
    n = x.shape[0]
    acov = _autocovariance_fft(x)
    chain_var = acov[0] * n / (n - 1.0)
    zmean = torch.mean(x, dim=0)
    zvar = torch.var(x, dim=0, correction=1)
    return (torch.sum(chain_var, dim=0), torch.sum(acov, dim=1),
            torch.sum(zmean, dim=0), torch.sum(zmean * zmean, dim=0),
            torch.sum(zvar, dim=0), x.shape[1])


def _moments_over_chunks(get_chunk, S: int, C: int, chain_chunk: int) -> dict:
    """Accumulate `_chunk_moments` over chain chunks; get_chunk(c0, c1)
    returns the (S, c1 - c0, dd) values."""
    center = torch.mean(get_chunk(0, min(chain_chunk, C)), dim=(0, 1))
    sums, M = None, 0
    for c0 in range(0, C, chain_chunk):
        *parts, m = _chunk_moments(get_chunk(c0, min(c0 + chain_chunk, C)),
                                   center)
        M += m
        sums = parts if sums is None else [a + b for a, b in zip(sums, parts)]
    cv, ac, zm, zm2, zv = sums
    return {
        "n": S // 2, "M": M,
        "mean_var": cv / M, "mean_acov": ac / M,
        "var_means": (zm2 - zm * zm / M) / (M - 1),
        "W": zv / M,
    }


def _accumulate_block(block, chain_chunk: int) -> dict:
    """Rank-normalize one dim block, then accumulate moments per chain chunk."""
    S, C, _ = block.shape
    z = _rank_normalize(block)
    return _moments_over_chunks(lambda a, b: z[:, a:b], S, C, chain_chunk)


def ess_bulk_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                     dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Bulk ESS of (S, C, D) samples, chunked over chains and dims; equal to
    ess_bulk(samples) up to summation order."""
    samples = _as_history(samples)
    S = samples.shape[0]
    samples = samples[: 2 * (S // 2)]     # match _split_chains truncation
    out = []
    for d0 in range(0, samples.shape[2], dim_chunk):
        mo = _accumulate_block(samples[:, :, d0:d0 + dim_chunk], chain_chunk)
        out.append(_ess_combine(mo["mean_var"], mo["mean_acov"],
                                mo["var_means"], mo["n"], mo["M"]))
    return torch.cat(out)


def split_rhat_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                       dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Rank-normalized split R-hat (max of bulk and folded), chunked; equal to
    split_rhat(samples) up to summation order."""
    samples = _as_history(samples)
    S = samples.shape[0]
    samples = samples[: 2 * (S // 2)]
    S, C, D = samples.shape
    out = []
    for d0 in range(0, D, dim_chunk):
        block = samples[:, :, d0:d0 + dim_chunk]
        folded = torch.abs(block - _median0(block.reshape(S * C, -1)))
        rhats = []
        for b in (block, folded):
            mo = _accumulate_block(b, chain_chunk)
            n, W = mo["n"], mo["W"]
            var_plus = (n - 1) / n * W + mo["var_means"]
            rhats.append(torch.sqrt(var_plus / W))
        out.append(torch.maximum(*rhats))
    return torch.cat(out)


def _ess_of_moments(mo) -> torch.Tensor:
    return _ess_combine(mo["mean_var"], mo["mean_acov"], mo["var_means"], mo["n"], mo["M"])


def ess_tail_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                     dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Tail ESS (the smaller ESS of the 5% and 95% quantile indicator
    series), chunked; equal to ess_tail(samples) up to summation order. The
    pooled quantiles are taken once per dim block (they do not depend on
    the split), then the indicators' moments accumulate per chain chunk."""
    samples = _as_history(samples)
    S = samples.shape[0]
    samples = samples[: 2 * (S // 2)]
    S, C, D = samples.shape
    out = []
    for d0 in range(0, D, dim_chunk):
        block = samples[:, :, d0:d0 + dim_chunk]
        flat = block.reshape(S * C, -1)
        esss = []
        for q in (_quantile0(flat, 0.05), _quantile0(flat, 0.95)):
            mo = _moments_over_chunks(
                lambda a, b, q=q: (block[:, a:b] <= q).to(block.dtype), S, C, chain_chunk)
            esss.append(_ess_of_moments(mo))
        out.append(torch.minimum(*esss))
    return torch.cat(out)


def ess_mean_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                     dim_chunk: int = DEFAULT_DIM_CHUNK):
    """ESS of the raw split draws (the 'mean' method), chunked; equal to
    ess_mean(samples) up to summation order."""
    samples = _as_history(samples)
    S = samples.shape[0]
    samples = samples[: 2 * (S // 2)]
    S, C, D = samples.shape
    out = []
    for d0 in range(0, D, dim_chunk):
        block = samples[:, :, d0:d0 + dim_chunk]
        out.append(_ess_of_moments(
            _moments_over_chunks(lambda a, b: block[:, a:b], S, C, chain_chunk)))
    return torch.cat(out)


def _pooled_mean_sq_chunked(samples, chain_chunk: int, dim_chunk: int):
    """(mean, sum of squared deviations, count) over every pooled draw (an
    odd last draw included), chunked. Two passes, the mean first, so a
    float32 sum of squares does not cancel at 10^7 pooled draws."""
    samples = _as_history(samples)
    S, C, D = samples.shape
    means, sqs = [], []
    for d0 in range(0, D, dim_chunk):
        block = samples[:, :, d0:d0 + dim_chunk]
        total = sum(torch.sum(block[:, c0:c0 + chain_chunk], dim=(0, 1))
                    for c0 in range(0, C, chain_chunk))
        mean = total / (S * C)
        sq = sum(torch.sum((block[:, c0:c0 + chain_chunk] - mean) ** 2, dim=(0, 1))
                 for c0 in range(0, C, chain_chunk))
        means.append(mean)
        sqs.append(sq)
    return torch.cat(means), torch.cat(sqs), S * C


def mcse_mean_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                      dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Monte Carlo standard error of the mean, chunked: sd / sqrt(ess_mean),
    the sd over every draw (an odd last one included) as mcse_mean's."""
    _, sq, count = _pooled_mean_sq_chunked(samples, chain_chunk, dim_chunk)
    return torch.sqrt(sq / (count - 1)) / torch.sqrt(
        ess_mean_chunked(samples, chain_chunk, dim_chunk))


def diagnostics_dict(rhat, bulk, tail, mcse, mean, std) -> dict:
    """compute_diagnostics' dict from the per-dim statistics (host numpy)."""
    rhat, bulk, tail, mcse, mean, std = (
        np.asarray(x.detach().cpu()) for x in (rhat, bulk, tail, mcse, mean, std))
    return {
        "rhat_max": float(np.max(rhat)),
        "rhat_mean": float(np.mean(rhat)),
        "ess_bulk_min": float(np.min(bulk)),
        "ess_bulk_mean": float(np.mean(bulk)),
        "ess_tail_min": float(np.min(tail)),
        "ess_tail_mean": float(np.mean(tail)),
        "mean_estimate": mean,
        "std_estimate": std,
        "summary": {"mean": mean, "sd": std, "mcse_mean": mcse, "ess_bulk": bulk,
                    "ess_tail": tail, "r_hat": rhat},
    }


def compute_diagnostics_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                                dim_chunk: int = DEFAULT_DIM_CHUNK) -> dict:
    """compute_diagnostics' dict for a history too large for one pass, every
    statistic over all chains through the chain- and dim-chunked
    estimators; only the (D,) statistics leave the device. The summary's sd
    is ddof 0, the MCSE's ddof 1, as the JAX package's."""
    samples = _as_history(samples)
    rhat = split_rhat_chunked(samples, chain_chunk, dim_chunk)
    bulk = ess_bulk_chunked(samples, chain_chunk, dim_chunk)
    tail = ess_tail_chunked(samples, chain_chunk, dim_chunk)
    mean, sq, count = _pooled_mean_sq_chunked(samples, chain_chunk, dim_chunk)
    mcse = torch.sqrt(sq / (count - 1)) / torch.sqrt(
        ess_mean_chunked(samples, chain_chunk, dim_chunk))
    return diagnostics_dict(rhat, bulk, tail, mcse, mean, torch.sqrt(sq / count))
