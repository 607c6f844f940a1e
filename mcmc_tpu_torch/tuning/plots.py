"""Tuning-diagnostic plots (port of ``mcmc_tpu/tuning/plots.py``; API
parity with the reference's tuning/plots.py: plot_tuning_history,
plot_sampling_diagnostics, plot_grid_comparison,
plot_grahmc_grid_comparison, plot_coordinate_tuning_history,
plot_w2_convergence, plus plot_chees_history).

Host-side matplotlib, a leaf module: the tune-and-sample CLI imports it
only under --plot, and nothing on the card's path imports it. Every input
may be a tensor (detached and moved to host numpy) or an array.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from mcmc_tpu_torch.utils import setup_headless_backend

setup_headless_backend()
import matplotlib.pyplot as plt  # noqa: E402


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return np.asarray([_host(v) for v in x])
    return np.asarray(x)


def _scalar(x):
    return None if x is None else float(_host(x))


def _is_sequence(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.ndim >= 1
    return isinstance(x, (list, tuple, np.ndarray))


def _finish(fig, output_file: Optional[str]):
    fig.tight_layout()
    if output_file:
        fig.savefig(output_file, bbox_inches="tight", dpi=120)
        print(f"  saved {output_file}")
        plt.close(fig)
    else:
        plt.show()


def plot_tuning_history(history: Dict, sampler_name: str = "RWMH",
                        output_file: Optional[str] = None):
    """Parameter + acceptance traces from a DA tuning history dict
    (scale_history/step_size_history, accept_history, optional
    tree_depth_history)."""
    param = history.get("scale_history")
    if param is None or len(param) == 0:
        param = history.get("step_size_history")
    if param is None:
        raise ValueError(
            "history has neither 'scale_history' nor 'step_size_history'; "
            f"keys: {sorted(history)}")
    param = _host(param)
    # DA histories carry the same trace under BOTH keys (dual_averaging.py),
    # so key presence cannot distinguish the parameter -- the sampler can:
    # RWMH tunes a proposal scale, gradient samplers tune a step size.
    if "scale_history" in history and "step_size_history" in history:
        param_name = "scale" if "rwmh" in sampler_name.lower() else "step size"
    else:
        param_name = "scale" if "scale_history" in history else "step size"
    has_depth = "tree_depth_history" in history
    n_plots = 3 if has_depth else 2

    fig, axes = plt.subplots(n_plots, 1, figsize=(10, 3.5 * n_plots), sharex=True)
    it = np.arange(1, len(param) + 1)
    axes[0].plot(it, param, lw=1.5)
    axes[0].set_ylabel(param_name)
    axes[0].set_title(f"{sampler_name} dual-averaging history")
    axes[1].plot(it, _host(history["accept_history"]), color="green", lw=1.5)
    target = _scalar(history.get("target_accept"))
    if target is not None:
        axes[1].axhline(target, color="red", ls="--", alpha=0.7,
                        label=f"target {target}")
        axes[1].legend()
    axes[1].set_ylabel("acceptance")
    if has_depth:
        axes[2].plot(it, _host(history["tree_depth_history"]), color="purple", lw=1.5)
        axes[2].set_ylabel("avg tree depth")
    axes[-1].set_xlabel("tuning iteration")
    conv = history.get("converged_iter")
    if conv is not None and conv <= len(param):
        for ax in axes:
            ax.axvline(conv, color="gray", ls=":", alpha=0.7)
    for ax in axes:
        ax.grid(alpha=0.3)
    _finish(fig, output_file)


def plot_sampling_diagnostics(samples, diagnostics: Dict,
                              sampler_name: str = "Sampler",
                              output_file: Optional[str] = None):
    """Trace plots (left) and marginal histograms (right) for up to 4 dims."""
    samples = _host(samples)          # (n, chains, dim)
    n, n_chains, n_dim = samples.shape
    dims = min(4, n_dim)
    fig, axes = plt.subplots(dims, 2, figsize=(12, 3 * dims), squeeze=False)
    for i in range(dims):
        for c in range(n_chains):
            axes[i, 0].plot(samples[:, c, i], alpha=0.6, lw=0.5)
        axes[i, 0].set_ylabel(f"x[{i}]")
        axes[i, 1].hist(samples[:, :, i].ravel(), bins=60, density=True,
                        alpha=0.7)
    axes[0, 0].set_title("traces")
    axes[0, 1].set_title("marginals")
    fig.suptitle(f"{sampler_name} sampling diagnostics "
                 f"(R-hat max {diagnostics.get('rhat_max', float('nan')):.3f}, "
                 f"bulk ESS min {diagnostics.get('ess_bulk_min', float('nan')):.0f})",
                 fontweight="bold")
    _finish(fig, output_file)


def _grid_panels(axes, grid_results, num_steps_grid, panels, xlabel):
    for ax, (field, label) in zip(axes.flat, panels):
        ys = [_scalar(r.get(field)) for r in grid_results]
        pairs = [(l, y) for l, y in zip(num_steps_grid, ys) if y is not None]
        if pairs:
            xs, vals = zip(*pairs)
            ax.plot(xs, vals, "o-", lw=2, markersize=8)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)


def plot_grid_comparison(grid_results: List[Dict], num_steps_grid: List[int],
                         output_file: Optional[str] = None):
    """2x2 L-grid comparison: ESS/grad, ESS/sample, R-hat, step size."""
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    _grid_panels(axes, grid_results, num_steps_grid,
                 [("ess_per_gradient", "ESS / gradient"),
                  ("ess_per_sample", "ESS / sample"),
                  ("rhat_max", "R-hat max"),
                  ("step_size", "tuned step size")], "trajectory length L")
    fig.suptitle("Trajectory-length grid comparison", fontweight="bold")
    _finish(fig, output_file)


def plot_grahmc_grid_comparison(grid_results: List[Dict],
                                num_steps_grid: List[int],
                                output_file: Optional[str] = None):
    """GRAHMC L-grid comparison incl. tuned gamma per L."""
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    _grid_panels(axes, grid_results, num_steps_grid,
                 [("ess_per_gradient", "ESS / gradient"),
                  ("ess_bulk_min", "bulk ESS min"),
                  ("rhat_max", "R-hat max"),
                  ("accept_rate", "acceptance"),
                  ("gamma", "tuned gamma"),
                  ("step_size", "tuned step size")], "L")
    fig.suptitle("GRAHMC trajectory-length grid comparison", fontweight="bold")
    _finish(fig, output_file)


def plot_coordinate_tuning_history(history: Dict,
                                   output_file: Optional[str] = None):
    """Per-coordinate traces (e.g. joint [step, gamma] DA tuning).

    Scalar entries (converged_iter, target_accept, ...) are skipped when
    sizing the grid -- only sequence-valued entries get a panel."""
    traces = [(name, _host(values)) for name, values in history.items()
              if _is_sequence(values)]
    if not traces:
        raise ValueError(
            "history has no sequence-valued entries to plot; "
            f"keys: {sorted(history)}")
    fig, axes = plt.subplots(len(traces), 1,
                             figsize=(10, 3 * len(traces)),
                             squeeze=False)
    for ax, (name, values) in zip(axes[:, 0], traces):
        ax.plot(np.arange(1, len(values) + 1), values, lw=1.5)
        ax.set_ylabel(name)
        ax.grid(alpha=0.3)
    axes[-1, 0].set_xlabel("iteration")
    fig.suptitle("Coordinate tuning history", fontweight="bold")
    _finish(fig, output_file)


def plot_w2_convergence(convergence_traces: Dict[str, List[Dict]],
                        output_file: Optional[str] = None):
    """Log-log Sliced-W2 vs gradient evaluations, one line per labeled run.

    convergence_traces: {label: [checkpoint dicts with n_gradients,
    w2_distance]} as produced by the runner's --track-convergence path."""
    fig, ax = plt.subplots(figsize=(9, 6))
    for label, trace in convergence_traces.items():
        xs = [_scalar(c["n_gradients"]) for c in trace if c.get("w2_distance")]
        ys = [_scalar(c["w2_distance"]) for c in trace if c.get("w2_distance")]
        if xs:
            ax.plot(xs, ys, "o-", lw=2, label=label)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("gradient evaluations")
    ax.set_ylabel("Sliced W2 distance")
    ax.set_title("Convergence: W2 vs computational cost", fontweight="bold")
    ax.legend()
    ax.grid(alpha=0.3, which="both")
    _finish(fig, output_file)


def plot_chees_history(info: Dict, sampler_name: str = "HMC",
                       output_file: Optional[str] = None):
    """ChEES adaptation traces from a run_chees_warmup info dict: the
    tuned trajectory length exp(log T) with its final (Polyak-averaged)
    value, the realized mean leapfrog counts, and the per-batch acceptance
    against the jittered-HMC target. No reference counterpart (the
    reference selects L by grid search); companion to plot_tuning_history."""
    log_t = info.get("log_t_history")
    if log_t is None:
        raise ValueError("info has no 'log_t_history' -- not a ChEES warmup "
                         f"info dict; keys: {sorted(info)}")
    log_t = _host(log_t)
    fig, axes = plt.subplots(3, 1, figsize=(10, 10.5), sharex=True)
    it = np.arange(1, len(log_t) + 1)
    axes[0].plot(it, np.exp(log_t), lw=1.5)
    final_t = _scalar(info.get("trajectory_length"))
    if final_t is not None:
        axes[0].axhline(final_t, color="red", ls="--", alpha=0.7,
                        label=f"tuned T = {final_t:.3f}"
                              f" (L = {info.get('num_steps')})")
        axes[0].legend()
    axes[0].set_ylabel("trajectory length T")
    axes[0].set_yscale("log")
    axes[0].set_title(f"{sampler_name} ChEES adaptation history")
    axes[1].plot(it, _host(info["mean_leapfrogs_history"]), color="purple", lw=1.5)
    axes[1].set_ylabel("mean leapfrogs / draw")
    axes[2].plot(it, _host(info["accept_history"]), color="green", lw=1.5)
    target = _scalar(info.get("target_accept"))
    if target is not None:
        axes[2].axhline(target, color="red", ls="--", alpha=0.7,
                        label=f"target {target}")
        axes[2].legend()
    axes[2].set_ylabel("acceptance")
    axes[2].set_xlabel("DA batch")
    _finish(fig, output_file)
