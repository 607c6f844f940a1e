"""The port's tuning plots (mcmc_tpu_torch.tuning.plots): every function
saves a PNG from tensors, with the JAX package's ValueErrors and label
rule (tests/test_aux.py:179-197, tests/test_chees.py:423-434), and the
same public functions as mcmc_tpu.tuning.plots."""

import inspect

import numpy as np
import pytest
import torch

from mcmc_tpu.tuning import plots as jplots
from mcmc_tpu_torch.tuning import plots as tplots

FUNCTIONS = ["plot_tuning_history", "plot_sampling_diagnostics", "plot_grid_comparison",
             "plot_grahmc_grid_comparison", "plot_coordinate_tuning_history",
             "plot_w2_convergence", "plot_chees_history"]


def test_the_same_public_functions():
    def public(module):
        return sorted(n for n, f in vars(module).items()
                      if n.startswith("plot_") and inspect.isfunction(f))
    assert public(tplots) == public(jplots) == sorted(FUNCTIONS)
    for name in FUNCTIONS:
        assert (list(inspect.signature(getattr(tplots, name)).parameters)
                == list(inspect.signature(getattr(jplots, name)).parameters))


def _history():
    t = torch.linspace(0.1, 0.3, 12, dtype=torch.float64)
    return {"scale_history": t, "step_size_history": t,
            "accept_history": torch.linspace(0.4, 0.65, 12),
            "tree_depth_history": torch.arange(12.0), "converged_iter": 10,
            "target_accept": torch.tensor(0.65)}


def _grid():
    return [{"num_steps": L, "ess_per_gradient": torch.tensor(0.01 / L),
             "ess_per_sample": 0.5, "rhat_max": torch.tensor(1.001), "step_size": 0.2,
             "ess_bulk_min": torch.tensor(400.0), "accept_rate": 0.7, "gamma": 0.1 * L,
             "steepness": 2.0} for L in (8, 16)]


CALLS = {
    "plot_tuning_history": lambda out: tplots.plot_tuning_history(_history(), "NUTS", out),
    "plot_sampling_diagnostics": lambda out: tplots.plot_sampling_diagnostics(
        torch.randn(50, 3, 5, generator=torch.Generator().manual_seed(0)),
        {"rhat_max": 1.01, "ess_bulk_min": 100.0}, "GRAHMC", out),
    "plot_grid_comparison": lambda out: tplots.plot_grid_comparison(_grid(), [8, 16], out),
    "plot_grahmc_grid_comparison": lambda out: tplots.plot_grahmc_grid_comparison(
        _grid(), [8, 16], out),
    "plot_coordinate_tuning_history": lambda out: tplots.plot_coordinate_tuning_history(
        {"step": torch.rand(9), "gamma": np.linspace(0, 1, 9), "converged_iter": 4}, out),
    "plot_w2_convergence": lambda out: tplots.plot_w2_convergence(
        {"GRAHMC": [{"n_gradients": 100 * k, "w2_distance": torch.tensor(1.0 / k)}
                    for k in range(1, 5)]}, out),
    "plot_chees_history": lambda out: tplots.plot_chees_history(
        {"log_t_history": torch.linspace(-1.8, 0.45, 25),
         "mean_leapfrogs_history": torch.linspace(1, 9, 25),
         "accept_history": 0.65 + 0.1 * torch.sin(torch.arange(25.0)),
         "trajectory_length": torch.tensor(1.57), "num_steps": 7,
         "target_accept": 0.651}, "HMC", out),
}


@pytest.mark.parametrize("name", FUNCTIONS)
def test_every_plot_saves_a_png_from_tensors(name, tmp_path):
    out = tmp_path / f"{name}.png"
    CALLS[name](str(out))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 5000


@pytest.mark.parametrize("sampler,label", [("HMC", "step size"), ("RWMH", "scale"),
                                           ("rwmh", "scale"), ("GRAHMC", "step size")])
def test_tuning_plot_param_label_follows_the_sampler(sampler, label, tmp_path, monkeypatch):
    """DA histories carry the trace under BOTH scale_history and
    step_size_history; the label must follow the sampler."""
    figs = []
    monkeypatch.setattr(tplots, "_finish", lambda fig, out: figs.append(fig))
    h = {"scale_history": [0.1, 0.2], "step_size_history": [0.1, 0.2],
         "accept_history": [0.5, 0.6], "converged_iter": 2, "target_accept": 0.65}
    tplots.plot_tuning_history(h, sampler, output_file=str(tmp_path / "a.png"))
    assert figs[0].axes[0].get_ylabel() == label


@pytest.mark.parametrize("keys,label", [(("scale_history",), "scale"),
                                        (("step_size_history",), "step size")])
def test_tuning_plot_param_label_follows_a_single_key(keys, label, monkeypatch):
    figs = []
    monkeypatch.setattr(tplots, "_finish", lambda fig, out: figs.append(fig))
    h = {k: torch.tensor([0.1, 0.2]) for k in keys}
    h["accept_history"] = torch.tensor([0.5, 0.6])
    tplots.plot_tuning_history(h, "HMC")
    assert figs[0].axes[0].get_ylabel() == label


def test_tuning_plot_errors(tmp_path):
    """Missing / scalar-only histories raise ValueError, not TypeError."""
    h = {"scale_history": [0.1, 0.2], "step_size_history": [0.1, 0.2],
         "accept_history": [0.5, 0.6], "converged_iter": 2, "target_accept": 0.65}
    tplots.plot_coordinate_tuning_history(h, output_file=str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").exists()
    with pytest.raises(ValueError):
        tplots.plot_tuning_history({"accept_history": [1]}, output_file=str(tmp_path / "d.png"))
    with pytest.raises(ValueError):
        tplots.plot_coordinate_tuning_history({"converged_iter": 3},
                                              output_file=str(tmp_path / "e.png"))
    with pytest.raises(ValueError):
        tplots.plot_coordinate_tuning_history({"converged_iter": torch.tensor(3)},
                                              output_file=str(tmp_path / "f.png"))


def test_plot_chees_history_error():
    with pytest.raises(ValueError):
        tplots.plot_chees_history({"accept_history": []})
