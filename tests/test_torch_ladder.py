"""Port parity for the tempering-ladder tuner: the port's own copy of the
numpy tuner against the JAX package's on the same deterministic bursts, its
guards, and tune_ladder closing over the port's tempered_run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu.samplers import geometric_ladder as j_ladder  # noqa: E402
from mcmc_tpu.tuning import ladder as jl  # noqa: E402
from mcmc_tpu_torch.samplers import tempered_run  # noqa: E402
from mcmc_tpu_torch.targets import standard_normal  # noqa: E402
from mcmc_tpu_torch.tuning import ladder as tl  # noqa: E402


def test_spacings_match_jax_and_roundtrip_geometric():
    for k, b in ((6, 0.05), (3, 0.2)):
        np.testing.assert_array_equal(tl.geometric_spacings(k, b), jl.geometric_spacings(k, b))
        np.testing.assert_allclose(tl.spacings_to_betas(tl.geometric_spacings(k, b)),
                                   np.asarray(j_ladder(k, b)), rtol=1e-6)
    rho = np.random.default_rng(0).normal(size=7) * 2.0
    np.testing.assert_array_equal(tl.spacings_to_betas(rho), jl.spacings_to_betas(rho))
    b = tl.spacings_to_betas(rho)
    assert b[0] == 1.0 and np.all(np.diff(b) < 0) and np.all(b > 0)
    with pytest.raises(ValueError, match="n_temps"):
        tl.geometric_spacings(1, 0.05)
    with pytest.raises(ValueError, match="beta_min"):
        tl.geometric_spacings(4, 2.0)


def _synthetic(n_temps):
    """A deterministic burst: swap rate exp(-spacing), a NaN pair every
    third round, transition accept exp(-eps sqrt(beta)), and a replica
    state that counts the rounds."""
    calls = []

    def run_round(betas, steps, rep):
        calls.append(1)
        b = np.asarray(betas, np.float64)
        swap = np.exp(-(np.log(b[:-1]) - np.log(b[1:])))
        if len(calls) % 3 == 0:
            swap[1] = np.nan
        accept = np.exp(-np.asarray(steps, np.float64) * np.sqrt(b))
        return swap, np.ones(n_temps - 1), accept, (0 if rep is None else rep) + 1
    return run_round


def test_tune_ladder_equals_jax_on_a_synthetic_burst():
    """The same deterministic run_round through both packages' tune_ladder:
    betas, step sizes, history and deviations equal to 1e-12."""
    kw = dict(beta_min_init=0.05, n_rounds=20, learning_rate=1.5, step_size=1.0,
              target_accept=0.65, step_learning_rate=1.2, beta_floor=1e-3)
    bt, it = tl.tune_ladder(_synthetic(5), 5, **kw)
    bj, ij = jl.tune_ladder(_synthetic(5), 5, **kw)
    np.testing.assert_allclose(bt, bj, rtol=1e-12)
    np.testing.assert_allclose(it["step_sizes"], ij["step_sizes"], rtol=1e-12)
    for key in ("initial_deviation", "final_deviation", "n_rounds", "target_swap",
                "replica_final_positions"):
        assert it[key] == pytest.approx(ij[key], rel=1e-12)
    for a, b in zip(it["history"], ij["history"], strict=True):
        for key in ("betas", "swap_rates", "replica_accept"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-12)


def test_tune_ladder_guards():
    """An unattempted pair on the first round raises; an all-NaN burst
    freezes the geometric ladder; the floor keeps the coldest rung above
    beta_floor (tests/test_ladder.py)."""
    with pytest.raises(ValueError, match=r"never attempted.*\[1\]"):
        tl.tune_ladder(lambda b, s, r: (np.array([0.3, 0.0, 0.3]), np.array([8.0, 0.0, 8.0]),
                                        None, None), 4, beta_min_init=0.05, n_rounds=4)
    betas, info = tl.tune_ladder(lambda b, s, r: (np.full(3, np.nan), np.ones(3), None, None),
                                 4, beta_min_init=0.05, n_rounds=5)
    np.testing.assert_allclose(betas, np.asarray(j_ladder(4, 0.05)), rtol=1e-6)
    assert len(info["history"]) == 5
    betas, _ = tl.tune_ladder(lambda b, s, r: (np.ones(3), np.ones(3), None, None), 4,
                              beta_min_init=0.05, n_rounds=30, beta_floor=0.01)
    np.testing.assert_allclose(betas[-1], 0.01, rtol=1e-3)


def test_tune_ladder_over_the_port_tempered_run():
    """run_round closing over the port's tempered_run (fused backend, its
    plain version here): deviation from 0.234 does not grow, the ladder
    stays valid and the (K C, D) replica state threads through the rounds
    (tests/test_ladder.py::test_tune_ladder_real_tempered_run)."""
    t = standard_normal(4)
    init = torch.randn((32, 4), generator=torch.Generator().manual_seed(1)) * 0.2
    calls = [0]

    def burst(betas, steps, rep):
        calls[0] += 1
        r = tempered_run(torch.Generator().manual_seed(7 + calls[0]), t.log_prob_fn, init,
                         step_size=torch.from_numpy(steps), num_steps=8, num_samples=24,
                         betas=torch.from_numpy(betas), init_replica_position=rep,
                         value_and_grad_fn=t.value_and_grad_fn, backend="fused")
        return (r.info["swap_accept_rate"].numpy(), r.info["swap_attempts"].numpy(),
                r.info["replica_accept_rate"].numpy(), r.info["replica_final_positions"])

    betas, info = tl.tune_ladder(burst, 4, beta_min_init=0.05, n_rounds=8, step_size=0.5,
                                 target_accept=0.65)
    assert calls[0] == 8
    assert betas.shape == (4,) and betas[0] == 1.0 and np.all(np.diff(betas) < 0)
    assert info["replica_final_positions"].shape == (4 * 32, 4)
    assert info["final_deviation"] <= info["initial_deviation"] + 0.05
