"""The port's tune-and-sample CLI (mcmc_tpu_torch.tuning.core) against the
JAX package's (mcmc_tpu.tuning.core): the adaptive batch loop on the same
injected draws, the grid's choice by ESS per gradient, the NUTS gradient
count, main()'s result keys, the flags, and --plot without matplotlib."""

import argparse
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import jax.random as random
import numpy as np
import pytest
import torch

from mcmc_tpu import diagnostics as jdiag
from mcmc_tpu.targets import get_target as j_get_target
from mcmc_tpu.tuning import core as jcore
from mcmc_tpu_torch import diagnostics as tdiag
from mcmc_tpu_torch.benchmark import runner
from mcmc_tpu_torch.ops import padded_targets
from mcmc_tpu_torch.targets import get_target
from mcmc_tpu_torch.tuning import core as tcore
from mcmc_tpu_torch.utils import generators

B, C, D, N_BATCHES = 40, 4, 3, 5


def _ar1_draws(seed=0, phi=0.9):
    rng = np.random.default_rng(seed)
    x = np.zeros((N_BATCHES * B, C, D))
    for i in range(1, len(x)):
        x[i] = phi * x[i - 1] + np.sqrt(1 - phi ** 2) * rng.normal(size=(C, D))
    return x


def _batches(draws, wrap, received):
    """run_batch serving the fixed draws batch by batch, recording the
    positions it is given."""
    count = [0]

    def run_batch(_key, position):
        received.append(np.asarray(position))
        piece = draws[count[0] * B:(count[0] + 1) * B]
        count[0] += 1
        return SimpleNamespace(samples=wrap(piece), log_probs=wrap(-0.5 * (piece ** 2).sum(-1)),
                               accept_rate=wrap(np.full(C, 0.25 * count[0])),
                               final_state=SimpleNamespace(position=wrap(piece[-1])))
    return run_batch


def test_adaptive_sample_stops_at_the_same_batch_as_the_jax_one(capsys):
    draws = _ar1_draws()
    ess = [tdiag.compute_diagnostics(torch.from_numpy(draws[:k * B]))["ess_bulk_min"]
           for k in range(1, N_BATCHES + 1)]
    target = ess[2] * (1 - 1e-6)
    assert max(ess[:2]) < target          # the loop must stop at the third batch
    capsys.readouterr()

    j_seen, t_seen = [], []
    jout = jcore._adaptive_sample(random.PRNGKey(0), _batches(draws, jnp.asarray, j_seen),
                                  jnp.zeros((C, D)), target, B, N_BATCHES * B)
    j_print = capsys.readouterr().out
    tout = tcore._adaptive_sample(torch.Generator().manual_seed(0),
                                  _batches(draws, torch.from_numpy, t_seen),
                                  torch.zeros(C, D, dtype=torch.float64), target, B,
                                  N_BATCHES * B)
    t_print = capsys.readouterr().out

    assert tout["total_samples"] == jout["total_samples"] == 3 * B
    assert len(tout["pieces"]) == len(jout["pieces"]) == 3
    assert t_print == j_print and "target ESS reached" in t_print
    for a, b in zip(j_seen, t_seen):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tout["samples"].numpy(), np.asarray(jout["samples"]))
    np.testing.assert_array_equal(tout["log_probs"].numpy(), np.asarray(jout["log_probs"]))
    np.testing.assert_array_equal(tout["final_accept_rate"].numpy(),
                                  np.asarray(jout["final_accept_rate"]))
    t_ess = tdiag.compute_diagnostics(tout["samples"])["ess_bulk_min"]
    j_ess = float(jdiag.compute_diagnostics(jout["samples"])["ess_bulk_min"])
    assert t_ess == pytest.approx(j_ess, rel=1e-8)


def test_adaptive_sample_runs_to_max_samples_without_reaching_the_target():
    draws = _ar1_draws(seed=1)
    out = tcore._adaptive_sample(torch.Generator().manual_seed(0),
                                 _batches(draws, torch.from_numpy, []),
                                 torch.zeros(C, D, dtype=torch.float64), 1e12, B, 2 * B)
    assert out["total_samples"] == 2 * B and out["samples"].shape == (2 * B, C, D)


ESS_BY_L = {4: 100.0, 8: 400.0, 16: 500.0}     # per gradient: 25, 50, 31.25 (x 1 / (N C))


def _stub_grid(monkeypatch, module, full):
    """Stub the warmup, the samplers and the diagnostics: each L's draws
    are filled with L, and the diagnostics read L back to give ESS_BY_L."""
    def warmup(sampler, log_prob, _grad, init, _key, num_steps=None, **kw):
        return 0.01 * num_steps, None, init, {"gamma": 0.5, "steepness": 2.0}

    def run(_key, _log_prob, pos, num_steps=None, num_samples=None, **kw):
        return SimpleNamespace(samples=full((num_samples, C, D), float(num_steps)),
                               log_probs=full((num_samples, C), 0.0),
                               accept_rate=full((C,), 0.7),
                               final_state=SimpleNamespace(position=pos))

    def diagnostics(samples):
        L = int(np.asarray(samples[0, 0, 0]))
        return {"ess_bulk_min": ESS_BY_L[L], "ess_bulk_mean": ESS_BY_L[L], "rhat_max": 1.0,
                "rhat_mean": 1.0, "ess_tail_min": 1.0, "ess_tail_mean": 1.0}
    for name, fn in (("run_adaptive_warmup", warmup), ("grahmc_run", run), ("hmc_run", run),
                     ("compute_diagnostics", diagnostics)):
        monkeypatch.setattr(module, name, fn)


@pytest.mark.parametrize("sampler", ["hmc", "grahmc"])
def test_the_grid_picks_the_most_ess_per_gradient_as_the_jax_one(sampler, monkeypatch):
    grid = sorted(ESS_BY_L)
    _stub_grid(monkeypatch, jcore, lambda shape, v: jnp.full(shape, v))
    _stub_grid(monkeypatch, tcore, lambda shape, v: torch.full(shape, v, dtype=torch.float64))
    kw = dict(n_chains=C, target_ess=10 ** 9, batch_size=B, max_samples=2 * B,
              warmup_steps=10, num_steps_grid=grid)
    jrun = getattr(jcore, f"tune_and_sample_{sampler}_grid")
    trun = getattr(tcore, f"tune_and_sample_{sampler}_grid")
    want = jrun(random.PRNGKey(0), j_get_target("standard_normal", dim=D), **kw)
    got = trun(torch.Generator().manual_seed(0), get_target("standard_normal", dim=D), **kw)
    assert got["best_config"]["num_steps"] == want["best_config"]["num_steps"] == 8
    assert got["best_config"] is max(got["grid_results"], key=lambda r: r["ess_per_gradient"])
    assert sorted(got) == sorted(want) and got["num_steps_grid"] == want["num_steps_grid"]
    for g, w in zip(got["grid_results"], want["grid_results"]):
        assert sorted(g) == sorted(w)
        for key in ("num_steps", "total_samples", "total_gradient_calls", "ess_bulk_min",
                    "ess_per_gradient", "mean_acceptance", "step_size"):
            assert g[key] == pytest.approx(w[key], rel=1e-12), key
        if sampler == "grahmc":
            assert (g["gamma"], g["steepness"], g["schedule"]) == (0.5, 2.0, "constant")


def test_nuts_gradient_count_equals_the_jax_expression():
    rng = np.random.default_rng(3)
    for shape in ((50, 8), (1, 1), (200, 33)):
        depths = rng.integers(0, 11, size=shape).astype(np.int32)
        want = int(jnp.sum(2 ** jnp.asarray(depths) - 1))      # mcmc_tpu/tuning/core.py:159
        assert tcore.nuts_gradient_calls(torch.from_numpy(depths)) == want
    assert tcore.nuts_gradient_calls(torch.full((4096, 1024), 10, dtype=torch.int32)) \
        == 4096 * 1024 * 1023                                    # past int32, summed in int64


@pytest.fixture(scope="module")
def cpu_grid_main():
    return tcore.main(["--device", "cpu", "--sampler", "grahmc", "--target", "standard_normal",
                       "--dim", "3", "--chains", "8", "--num-steps-grid", "4,8",
                       "--warmup-steps", "100", "--batch-size", "200", "--max-samples", "400"])


def test_main_returns_the_jax_clis_result_keys(cpu_grid_main, monkeypatch):
    _stub_grid(monkeypatch, jcore, lambda shape, v: jnp.full(shape, v))
    want = jcore.tune_and_sample_grahmc_grid(
        random.PRNGKey(0), j_get_target("standard_normal", dim=3), n_chains=8,
        target_ess=1000, batch_size=200, max_samples=400, warmup_steps=100,
        num_steps_grid=[4, 8])
    got = cpu_grid_main
    assert sorted(got) == sorted(want) and got["num_steps_grid"] == [4, 8]
    assert [sorted(g) for g in got["grid_results"]] == [sorted(w) for w in want["grid_results"]]
    diag_keys = sorted(jdiag.compute_diagnostics(jnp.zeros((8, 2, 2)) + jnp.arange(8.0)[:, None,
                                                                                     None]))
    for g in got["grid_results"]:
        assert sorted(g["diagnostics"]) == diag_keys
        assert g["num_steps"] in (4, 8) and g["gamma"] is not None
        assert g["total_samples"] in (200, 400) and 0.0 < g["mean_acceptance"] <= 1.0
        assert g["ess_per_gradient"] == pytest.approx(
            g["ess_bulk_min"] / (g["total_samples"] * g["num_steps"] * 8))


def _jax_parser(monkeypatch):
    import mcmc_tpu.utils

    class Captured(Exception):
        pass

    def capture(self, *a, **k):
        raise Captured(self)
    monkeypatch.setattr(mcmc_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured) as info:
        jcore.main()
    return info.value.args[0]


def _options(parser):
    return {opt: (a.dest, a.default, a.choices, a.required, a.type, a.nargs)
            for a in parser._actions for opt in a.option_strings}


def test_the_flags_equal_the_jax_clis_apart_from_device(monkeypatch):
    mine = _options(tcore.build_parser())
    theirs = _options(_jax_parser(monkeypatch))
    assert mine.pop("--device") == ("device", "cuda", ["cuda", "cpu"], False, str, None)
    assert mine == theirs
    assert tcore.build_parser().format_help().count("--") > len(theirs)


def test_plot_without_matplotlib_raises_before_sampling(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "mcmc_tpu_torch.tuning.plots", raising=False)
    import mcmc_tpu_torch.tuning as tuning_pkg
    monkeypatch.delattr(tuning_pkg, "plots", raising=False)

    def no_sampling(*a, **k):
        raise AssertionError("sampled before the plots were imported")
    for name in ("get_target", "tune_and_sample_rwmh", "tune_and_sample_nuts",
                 "tune_and_sample_hmc_grid", "tune_and_sample_grahmc_grid"):
        monkeypatch.setattr(tcore, name, no_sampling)
    with pytest.raises(ImportError, match="matplotlib"):
        tcore.main(["--device", "cpu", "--sampler", "rwmh", "--plot"])


def test_main_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcore, "get_target", lambda *a, **k: pytest.fail("ran without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.main(["--sampler", "rwmh"])


def test_the_cli_and_the_runner_share_the_generators_and_the_backend_rule():
    for module in (tcore, runner):
        assert module.split_generator is generators.split_generator
        assert module.make_generator is generators.make_generator
        assert module.position_dtype is generators.position_dtype
    assert tcore.sampler_backend is padded_targets.sampler_backend is runner._resolve_backend
    t = get_target("standard_normal", dim=4)
    for sampler in ("rwmh", "hmc", "grahmc", "rahmc"):
        assert padded_targets.sampler_backend(sampler, t, "cpu") == "eager"
        assert padded_targets.sampler_backend(sampler, t, "cuda") == "fused"
    assert padded_targets.sampler_backend("nuts", t, "cuda") == "eager"
    assert generators.position_dtype("cuda") == torch.float32
    assert generators.position_dtype("cpu") == torch.float64


def test_rwmh_cli_on_the_cpu_keeps_the_jax_result_keys(monkeypatch):
    r = tcore.main(["--device", "cpu", "--sampler", "rwmh", "--dim", "3", "--chains", "8",
                    "--warmup-steps", "50", "--batch-size", "100", "--max-samples", "200",
                    "--target-ess", "1000000"])
    assert sorted(r) == ["accept_rate", "diagnostics", "history", "log_probs",
                         "mean_acceptance", "samples", "scale", "total_samples"]
    assert r["samples"].shape == (200, 8, 3) and r["samples"].dtype == torch.float64
    assert r["total_samples"] == 200 and 0.0 < r["mean_acceptance"] < 1.0
