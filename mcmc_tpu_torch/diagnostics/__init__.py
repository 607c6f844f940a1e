"""MCMC diagnostics as tensor reductions where the samples live (port of
``mcmc_tpu/diagnostics``): R-hat, bulk/tail/mean ESS and MCSE, monolithic
and chain-chunked, the quality gates, Sliced-W2, PSIS-LOO / WAIC model
comparison, the HDI and the summary table."""

import numpy as np
import torch

from mcmc_tpu_torch.diagnostics.gates import (
    DIVERGENCE_DELTA_H, HIGH_EFFICIENCY_THRESHOLD, INEFFICIENT_THRESHOLD, MIN_ESS_HARD_GATE,
    MIN_ESS_QUALITY, MIN_ESS_TAIL_HARD_GATE, MIN_ESS_TAIL_QUALITY, check_summary_statistics,
    detect_divergences, evaluate_gates, evaluate_smc_gates,
)
from mcmc_tpu_torch.diagnostics.model_comparison import (
    LooResult, WaicResult, compare, pointwise_log_likelihood, psis_loo, waic,
)
from mcmc_tpu_torch.diagnostics.rhat_ess import (
    ess_bulk, ess_mean, ess_tail, mcse_mean, split_rhat,
)
from mcmc_tpu_torch.diagnostics.streaming import (
    DEFAULT_CHAIN_CHUNK, _as_history, compute_diagnostics_chunked, diagnostics_dict,
    ess_bulk_chunked, ess_mean_chunked, ess_tail_chunked, mcse_mean_chunked,
    split_rhat_chunked,
)
from mcmc_tpu_torch.diagnostics.wasserstein import (
    ConvergenceW2Tracker, compute_sliced_w2, sliced_wasserstein_distance,
)

# Histories past this size go through the chain-chunked estimators, as in
# the JAX package (identical statistics up to summation order).
_CHUNKED_THRESHOLD_BYTES = 1 << 28
# What one pass of the ESS estimators may hold in FFT buffers.
FFT_BUFFER_BYTES = 1 << 30


def _fft_dim_chunk(n_draws: int, n_chains: int, itemsize: int, dim: int) -> int:
    """Dims per pass so that the autocovariance's FFT buffers of one pass
    (the half-spectrum, complex, and the inverse transform's real output,
    both over the 2 n_chains split chains) stay within FFT_BUFFER_BYTES."""
    half = max(n_draws // 2, 1)
    size = 1 << (2 * half - 1).bit_length()
    per_dim = 2 * n_chains * itemsize * (2 * (size // 2 + 1) + size)
    return max(1, min(dim, FFT_BUFFER_BYTES // per_dim))


def compute_diagnostics(samples) -> dict:
    """Convergence diagnostics and summary statistics of an (S, C, D)
    history, with the JAX package's keys (its summary a dict of arrays).

    The statistics are computed a block of dims at a time, the block sized
    by the bytes of the FFT buffers on the device (_fft_dim_chunk, at most
    FFT_BUFFER_BYTES); a history past 256 MB goes through the chain-chunked
    estimators (compute_diagnostics_chunked, DEFAULT_CHAIN_CHUNK chains a
    chunk), equal up to summation order. At 10,000 x 1,024 x 10 a float32
    history is 0.41 GB and its FFT buffers 0.27 GB a dim.
    """
    samples = _as_history(samples)
    S, C, D = samples.shape
    itemsize = samples.element_size()
    if samples.numel() * itemsize > _CHUNKED_THRESHOLD_BYTES:
        chains = min(C, DEFAULT_CHAIN_CHUNK)
        return compute_diagnostics_chunked(
            samples, chain_chunk=chains, dim_chunk=_fft_dim_chunk(S, chains, itemsize, D))
    step = _fft_dim_chunk(S, C, itemsize, D)
    parts = [[], [], [], []]
    for d0 in range(0, D, step):
        block = samples[:, :, d0:d0 + step]
        for out, fn in zip(parts, (split_rhat, ess_bulk, ess_tail, mcse_mean)):
            out.append(fn(block))
    flat = samples.reshape(-1, D)
    mean = torch.mean(flat, dim=0)
    std = torch.std(flat, dim=0, correction=0)
    return diagnostics_dict(*(torch.cat(p) for p in parts), mean, std)


def hdi(samples, hdi_prob: float = 0.94):
    """Highest-density interval per dimension: (lo (D,), hi (D,)) numpy.

    The narrowest window holding hdi_prob of the pooled draws (arviz's
    algorithm, exact for unimodal marginals): one sort per dimension and a
    sliding-window argmin. samples: (S, C, D) or (n, D).
    """
    if not 0.0 < hdi_prob < 1.0:
        raise ValueError("hdi_prob must be in (0, 1)")
    x = torch.as_tensor(samples)
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    n = x.shape[0]
    w = max(1, int(np.floor(hdi_prob * n)))
    if w >= n:
        w = n - 1
    xs = torch.sort(x, dim=0).values
    i = torch.argmin(xs[w:] - xs[: n - w], dim=0)
    cols = torch.arange(x.shape[1], device=x.device)
    return xs[i, cols].cpu().numpy(), xs[i + w, cols].cpu().numpy()


def summary(samples, hdi_prob: float = 0.94, var_names=None):
    """arviz ``az.summary``-style per-dimension table as a pandas DataFrame:
    mean, sd, hdi_lo, hdi_hi, mcse_mean, ess_bulk, ess_tail, r_hat, from
    compute_diagnostics and hdi. samples: (S, C, D), or flat (n, D) draws
    taken as one chain. Needs pandas (imported here only)."""
    import pandas as pd

    samples = torch.as_tensor(samples)
    if samples.ndim == 2:
        samples = samples[:, None, :]
    d = compute_diagnostics(samples)["summary"]
    lo, hi = hdi(samples, hdi_prob)
    if var_names is None:
        var_names = [f"x{i}" for i in range(len(d["mean"]))]
    pct = f"{hdi_prob * 100:g}%"
    return pd.DataFrame({
        "mean": d["mean"], "sd": d["sd"], f"hdi_lo_{pct}": lo, f"hdi_hi_{pct}": hi,
        "mcse_mean": d["mcse_mean"], "ess_bulk": d["ess_bulk"], "ess_tail": d["ess_tail"],
        "r_hat": d["r_hat"],
    }, index=var_names)


__all__ = [
    "split_rhat", "ess_bulk", "ess_tail", "ess_mean", "mcse_mean",
    "hdi", "summary",
    "ess_bulk_chunked", "split_rhat_chunked", "ess_tail_chunked",
    "ess_mean_chunked", "mcse_mean_chunked", "compute_diagnostics_chunked",
    "sliced_wasserstein_distance", "compute_sliced_w2",
    "ConvergenceW2Tracker",
    "psis_loo", "waic", "compare", "pointwise_log_likelihood",
    "LooResult", "WaicResult",
    "detect_divergences", "check_summary_statistics", "evaluate_gates",
    "evaluate_smc_gates",
    "compute_diagnostics",
    "MIN_ESS_HARD_GATE", "MIN_ESS_TAIL_HARD_GATE", "MIN_ESS_QUALITY",
    "MIN_ESS_TAIL_QUALITY", "INEFFICIENT_THRESHOLD", "HIGH_EFFICIENCY_THRESHOLD",
    "DIVERGENCE_DELTA_H",
]
