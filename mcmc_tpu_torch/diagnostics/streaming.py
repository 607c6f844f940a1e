"""Chain-chunked (streaming) diagnostics for large histories (port of
``ess_bulk_chunked`` and ``split_rhat_chunked`` from
``mcmc_tpu/diagnostics/streaming.py``; the mesh-sharded path is not ported).

At the main path's size — a (192, 65536, 50) float32 history, 2.5 GB — the
pooled rank normalization runs once per block of dims, and the ESS / R-hat
moments (chain means, unbiased chain variances, chain-averaged
autocovariance) accumulate over chunks of chains, then combine with the same
formulas as the monolithic estimators: chunked == monolithic up to
summation order.
"""

import torch

from mcmc_tpu_torch.diagnostics.rhat_ess import (
    _autocovariance_fft, _ess_combine, _median0, _rank_normalize,
    _split_chains,
)

DEFAULT_CHAIN_CHUNK = 8192
DEFAULT_DIM_CHUNK = 8


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
