"""Two-tier statistical quality gates and the Bonferroni z-test of the
posterior mean (port of ``mcmc_tpu/diagnostics/gates.py``).

Thresholds as the reference's (run_benchmarks.py:41-62, 777-804):
- usable (hard gate): R-hat < 1.05, bulk ESS >= 400, tail ESS >= 100,
  divergence rate < 5%;
- quality_pass: R-hat < 1.01, bulk ESS >= 400, tail ESS >= 200, divergence
  rate < 1%, and the z-test where the target has ground truth;
- efficiency flags: ESS/N < 1% inefficient, > 10% high efficiency.
The divergence rate is the samplers' real |dH| > 1000 count (the reference
hard-codes 0.0). The z-test runs on the host (scipy.stats).
"""

from typing import Dict

import numpy as np
import scipy.stats
import torch

MIN_ESS_HARD_GATE = 400
MIN_ESS_TAIL_HARD_GATE = 100
MIN_ESS_QUALITY = 400
MIN_ESS_TAIL_QUALITY = 200
INEFFICIENT_THRESHOLD = 0.01
HIGH_EFFICIENCY_THRESHOLD = 0.1

RHAT_USABLE = 1.05
RHAT_QUALITY = 1.01
DIVERGENCE_USABLE = 0.05
DIVERGENCE_QUALITY = 0.01

# |delta_H| in nats past which a transition is divergent (reference NUTS
# delta_max default)
DIVERGENCE_DELTA_H = 1000.0


def detect_divergences(delta_H, threshold: float = DIVERGENCE_DELTA_H):
    """Boolean mask of divergent transitions: |delta_H| > threshold."""
    return torch.abs(torch.as_tensor(delta_H)) > threshold


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def check_summary_statistics(diagnostics: Dict, target, significance: float = 0.05) -> Dict:
    """Bonferroni-corrected z-test of the posterior mean against the
    target's true mean: z_i = (mean_i - true_i) / mcse_i (with the
    reference's relative epsilon on the MCSE), rejected when max |z|
    reaches the two-sided threshold at level significance / dim."""
    if target.true_mean is None or target.true_cov is None:
        return {"pass": True, "max_z": 0.0, "threshold": None, "reason": "No ground truth"}

    summary = diagnostics["summary"]
    means = _host(summary["mean"])
    mcse = _host(summary["mcse_mean"])
    true_mean = _host(target.true_mean)

    n_dim = means.shape[0]
    z_threshold = float(scipy.stats.norm.ppf(1 - significance / n_dim / 2))
    epsilon = 1e-8 * np.maximum(np.abs(true_mean), 1.0) + 1e-16
    z_scores = (means - true_mean) / (mcse + epsilon)
    max_z = float(np.max(np.abs(z_scores)))
    passed = max_z < z_threshold
    return {
        "pass": passed,
        "max_z": max_z,
        "threshold": z_threshold,
        "z_scores": z_scores,
        "reason": None if passed else f"max |z|={max_z:.2f} > {z_threshold:.2f}",
    }


def _efficiency(usable: bool, quality_pass: bool, ess_per_sample: float) -> Dict:
    return {
        "usable": usable,
        "quality_pass": quality_pass if usable else False,
        "ess_per_sample": ess_per_sample,
        "is_inefficient": usable and ess_per_sample < INEFFICIENT_THRESHOLD,
        "is_high_efficiency": usable and ess_per_sample > HIGH_EFFICIENCY_THRESHOLD,
    }


def evaluate_gates(rhat_max: float, ess_bulk_min: float, ess_tail_min: float,
                   divergence_rate: float, num_samples: int, stats_pass: bool = True,
                   has_true_mean: bool = False) -> Dict:
    """The two-tier usable / quality_pass gates and the efficiency flags."""
    ess_per_sample = ess_bulk_min / num_samples if num_samples > 0 else 0.0
    usable = (rhat_max < RHAT_USABLE and ess_bulk_min >= MIN_ESS_HARD_GATE
              and ess_tail_min >= MIN_ESS_TAIL_HARD_GATE
              and divergence_rate < DIVERGENCE_USABLE)
    quality = (rhat_max < RHAT_QUALITY and ess_bulk_min >= MIN_ESS_QUALITY
               and ess_tail_min >= MIN_ESS_TAIL_QUALITY
               and divergence_rate < DIVERGENCE_QUALITY
               and (not has_true_mean or stats_pass))
    return _efficiency(usable, quality, ess_per_sample)


def evaluate_smc_gates(ess: float, divergence_rate: float, log_z: float, n_particles: int,
                       stats_pass: bool = True, has_true_mean: bool = False) -> Dict:
    """Two-tier gates of an annealed-SMC row (one weighted population):
    no R-hat (an exchangeable population always reads ~1), the importance
    ESS 1/sum(w^2) in place of bulk ESS (no separate tail estimate), the
    moves' divergences, and a finite log Z. Efficiency flags per particle."""
    ess_per_sample = ess / n_particles if n_particles > 0 else 0.0
    usable = (bool(np.isfinite(log_z)) and ess >= MIN_ESS_HARD_GATE
              and divergence_rate < DIVERGENCE_USABLE)
    quality = (ess >= MIN_ESS_QUALITY and divergence_rate < DIVERGENCE_QUALITY
               and (not has_true_mean or stats_pass))
    return _efficiency(usable, quality, ess_per_sample)
