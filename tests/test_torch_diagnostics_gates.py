"""Port parity of the rest of the diagnostics: tail and mean ESS, the MCSE,
their chunked forms, compute_diagnostics[_chunked], hdi, summary, the
quality gates and Sliced-W2 of mcmc_tpu_torch against the JAX package, on
the same float64 inputs made from a seed with numpy.

Tolerances: the ESS family and compute_diagnostics rtol 1e-9 (the two FFTs
differ in the last bits); hdi, detect_divergences and every verdict exact;
z-scores 1e-12; Sliced-W2 with the JAX package's directions (and reference
draws) injected rtol 1e-10, with the port's own directions within the
bounds of the JAX package's own tests (tests/test_diagnostics.py:86-145).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

import mcmc_tpu.diagnostics as J  # noqa: E402
from mcmc_tpu.diagnostics import gates as j_gates  # noqa: E402
from mcmc_tpu.diagnostics import rhat_ess as j_re  # noqa: E402
from mcmc_tpu.diagnostics import streaming as j_st  # noqa: E402
from mcmc_tpu.targets import get_reference_sampler as j_reference  # noqa: E402
import mcmc_tpu_torch.diagnostics as T  # noqa: E402
from mcmc_tpu_torch.diagnostics import gates as t_gates  # noqa: E402
from mcmc_tpu_torch.diagnostics import wasserstein as W  # noqa: E402

RTOL_ESS = 1e-9
RTOL_W2 = 1e-10


def _history(seed=0, shape=(200, 16, 5), decimals=1):
    """AR(1) chains with per-chain offsets, a wide and an offset dim,
    rounded so that ties occur (at the tail quantiles too)."""
    rng = np.random.default_rng(seed)
    S, C, D = shape
    x = np.empty(shape)
    x[0] = rng.standard_normal((C, D))
    for s in range(1, S):
        x[s] = 0.7 * x[s - 1] + rng.standard_normal((C, D))
    x += rng.standard_normal((1, C, D)) * 0.3
    x[:, :, 1] *= 50.0
    x[:, :, 2] += 1e3
    return np.round(x, decimals)


def test_exports_cover_the_jax_package():
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        assert hasattr(T, name), name


@pytest.mark.parametrize("stat", ["ess_tail", "ess_mean", "mcse_mean"])
@pytest.mark.parametrize("draws", [200, 201])
@pytest.mark.parametrize("decimals", [1, 6])
def test_monolithic_matches_jax(stat, draws, decimals):
    x = _history(1, (draws, 16, 5), decimals)
    ours = getattr(T, stat)(torch.from_numpy(x))
    theirs = np.asarray(getattr(j_re, stat)(jnp.asarray(x)))
    assert ours.dtype == torch.float64 and ours.shape == (5,)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=RTOL_ESS)


@pytest.mark.parametrize("stat", ["ess_tail", "ess_mean", "mcse_mean"])
@pytest.mark.parametrize("chunks", [(16, 8), (5, 2)])
def test_chunked_matches_jax(stat, chunks):
    """The chunked forms against the JAX package's chunked forms, and
    against the port's monolithic ones (held to the JAX package's above)."""
    x = _history(2, (151, 16, 5))
    cc, dc = chunks
    ours = getattr(T, f"{stat}_chunked")(torch.from_numpy(x), chain_chunk=cc, dim_chunk=dc)
    theirs = np.asarray(getattr(j_st, f"{stat}_chunked")(
        jnp.asarray(x), chain_chunk=cc, dim_chunk=dc))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=RTOL_ESS)
    np.testing.assert_allclose(ours.numpy(), getattr(T, stat)(torch.from_numpy(x)).numpy(),
                               rtol=RTOL_ESS)


def _assert_diagnostics_equal(ours, theirs):
    assert set(ours) == set(theirs)
    assert set(ours["summary"]) == set(theirs["summary"])
    for k in ("rhat_max", "rhat_mean", "ess_bulk_min", "ess_bulk_mean", "ess_tail_min",
              "ess_tail_mean"):
        assert isinstance(ours[k], float)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL_ESS, err_msg=k)
    for k in ("mean_estimate", "std_estimate"):
        np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), rtol=RTOL_ESS, err_msg=k)
    for k, v in theirs["summary"].items():
        assert ours["summary"][k].shape == np.asarray(v).shape
        np.testing.assert_allclose(ours["summary"][k], np.asarray(v), rtol=RTOL_ESS, err_msg=k)


@pytest.mark.parametrize("draws", [200, 201])
def test_compute_diagnostics_matches_jax(draws):
    x = _history(3, (draws, 12, 11))
    ours = T.compute_diagnostics(torch.from_numpy(x))
    _assert_diagnostics_equal(ours, J.compute_diagnostics(jnp.asarray(x)))


def test_compute_diagnostics_chunked_matches_jax():
    x = _history(4, (201, 12, 11))
    ours = T.compute_diagnostics_chunked(torch.from_numpy(x), 5, 3)
    _assert_diagnostics_equal(ours, j_st.compute_diagnostics_chunked(jnp.asarray(x), 5, 3))
    _assert_diagnostics_equal(ours, T.compute_diagnostics(torch.from_numpy(x)))


def test_compute_diagnostics_past_the_threshold_goes_chunked(monkeypatch):
    """Past _CHUNKED_THRESHOLD_BYTES the port takes the chunked estimators
    with dims per pass from the FFT bytes; the statistics stay the JAX
    package's."""
    x = _history(5, (120, 10, 6))
    monkeypatch.setattr(T, "_CHUNKED_THRESHOLD_BYTES", 1)
    seen = {}
    real = T.compute_diagnostics_chunked

    def spy(samples, chain_chunk, dim_chunk):
        seen["dim_chunk"] = dim_chunk
        return real(samples, chain_chunk, dim_chunk)
    monkeypatch.setattr(T, "compute_diagnostics_chunked", spy)
    # 120 draws: a 128-point FFT over 20 split chains, 41,280 bytes a dim
    monkeypatch.setattr(T, "FFT_BUFFER_BYTES", 2 * 2 * 10 * 8 * (2 * 65 + 128))
    ours = T.compute_diagnostics(torch.from_numpy(x))
    assert seen["dim_chunk"] == 2
    _assert_diagnostics_equal(ours, J.compute_diagnostics(jnp.asarray(x)))


def test_fft_dim_chunk_counts_the_fft_buffers(monkeypatch):
    # 10,000 draws x 1,024 chains in float32: a 16,384-point FFT over
    # 2,048 split chains, 268 MB of buffers a dim
    per_dim = 2 * 1024 * 4 * (2 * 8193 + 16384)
    for budget, dims in [(3 * per_dim, 3), (per_dim - 1, 1), (1 << 40, 10)]:
        monkeypatch.setattr(T, "FFT_BUFFER_BYTES", budget)
        assert T._fft_dim_chunk(10000, 1024, 4, 10) == dims


@pytest.mark.parametrize("shape", [(300, 4, 3), (1000, 3)])
@pytest.mark.parametrize("prob", [0.94, 0.5, 0.999])
def test_hdi_matches_jax_exactly(shape, prob):
    x = np.random.default_rng(6).standard_normal(shape) ** 3
    lo, hi = T.hdi(torch.from_numpy(x), prob)
    jlo, jhi = J.hdi(jnp.asarray(x), prob)
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    np.testing.assert_array_equal(hi, np.asarray(jhi))


def test_hdi_rejects_bad_probability():
    with pytest.raises(ValueError):
        T.hdi(torch.zeros(10, 2), 1.0)


@pytest.mark.parametrize("flat", [False, True])
def test_summary_matches_jax(flat):
    """Same columns, index and HDI bounds exactly; the statistics columns
    as compute_diagnostics (rtol 1e-9)."""
    x = _history(7, (200, 4, 3), 6)
    if flat:
        x = x[:, 0, :]
    ours = T.summary(torch.from_numpy(x), var_names=["a", "b", "c"])
    theirs = J.summary(jnp.asarray(x), var_names=["a", "b", "c"])
    assert list(ours.columns) == list(theirs.columns)
    assert list(ours.index) == list(theirs.index)
    for col in theirs.columns:
        if col.startswith("hdi_"):
            np.testing.assert_array_equal(ours[col].to_numpy(), theirs[col].to_numpy())
        else:
            np.testing.assert_allclose(ours[col].to_numpy(), theirs[col].to_numpy(),
                                       rtol=RTOL_ESS, err_msg=col)


def test_detect_divergences_matches_jax_exactly():
    dh = np.array([0.0, 999.9, 1000.0, 1000.1, -1000.1, np.inf, -np.inf, np.nan, 5e3])
    ours = t_gates.detect_divergences(torch.from_numpy(dh)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(j_gates.detect_divergences(jnp.asarray(dh))))
    ours = t_gates.detect_divergences(torch.from_numpy(dh), threshold=10.0).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(j_gates.detect_divergences(jnp.asarray(dh), threshold=10.0)))


@pytest.mark.parametrize("dim", [1, 3, 10])
@pytest.mark.parametrize("shift", [0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0])
def test_check_summary_statistics_matches_jax(dim, shift):
    """Means placed at `shift` MCSE from the truth, on both sides of the
    Bonferroni threshold (2.24 at D = 1, 2.64 at 3, 3.02 at 10)."""
    rng = np.random.default_rng(int(shift * 10) + dim)
    truth = rng.standard_normal(dim) * [1e4 if i == 0 else 1.0 for i in range(dim)]
    mcse = rng.uniform(0.01, 0.1, dim)
    means = truth + shift * mcse * rng.choice([-1.0, 1.0], dim)
    target = SimpleNamespace(true_mean=truth, true_cov=np.eye(dim))
    diag = {"summary": {"mean": means, "mcse_mean": mcse}}
    ours = t_gates.check_summary_statistics(
        {"summary": {"mean": torch.from_numpy(means), "mcse_mean": torch.from_numpy(mcse)}},
        SimpleNamespace(true_mean=torch.from_numpy(truth), true_cov=torch.eye(dim)))
    theirs = j_gates.check_summary_statistics(diag, target)
    assert ours["pass"] == theirs["pass"] and ours["reason"] == theirs["reason"]
    assert ours["threshold"] == theirs["threshold"]
    np.testing.assert_allclose(ours["max_z"], theirs["max_z"], rtol=1e-12)
    np.testing.assert_allclose(ours["z_scores"], theirs["z_scores"], rtol=1e-12)


def test_check_summary_statistics_without_ground_truth():
    target = SimpleNamespace(true_mean=None, true_cov=None)
    assert (t_gates.check_summary_statistics({}, target)
            == j_gates.check_summary_statistics({}, target))


_RHATS = [1.0, 1.0099, 1.01, 1.0499, 1.05, 1.2]
_ESS = [0.0, 99.0, 100.0, 199.0, 200.0, 399.0, 400.0, 1e4, 5e5]
_DIVS = [0.0, 0.0099, 0.01, 0.0499, 0.05, 0.2]


@pytest.mark.parametrize("rhat", _RHATS)
@pytest.mark.parametrize("div", _DIVS)
def test_evaluate_gates_matches_jax(rhat, div):
    for bulk in _ESS:
        for tail in _ESS:
            for n, stats, truth in ((1000, True, False), (1000, False, True), (0, True, True),
                                    (100000, True, True)):
                args = (rhat, bulk, tail, div, n, stats, truth)
                assert t_gates.evaluate_gates(*args) == j_gates.evaluate_gates(*args), args


@pytest.mark.parametrize("log_z", [0.0, -3.5, float("nan"), float("inf")])
@pytest.mark.parametrize("div", _DIVS)
def test_evaluate_smc_gates_matches_jax(log_z, div):
    for ess in _ESS:
        for n, stats, truth in ((4096, True, False), (4096, False, True), (0, True, True),
                                (100, True, True)):
            args = (ess, div, log_z, n, stats, truth)
            assert t_gates.evaluate_smc_gates(*args) == j_gates.evaluate_smc_gates(*args), args


def test_gate_constants_match_jax():
    for name in ("MIN_ESS_HARD_GATE", "MIN_ESS_TAIL_HARD_GATE", "MIN_ESS_QUALITY",
                 "MIN_ESS_TAIL_QUALITY", "INEFFICIENT_THRESHOLD", "HIGH_EFFICIENCY_THRESHOLD",
                 "DIVERGENCE_DELTA_H", "RHAT_USABLE", "RHAT_QUALITY", "DIVERGENCE_USABLE",
                 "DIVERGENCE_QUALITY"):
        assert getattr(t_gates, name) == getattr(j_gates, name), name


# --------------------------------------------------------------------------
# Sliced-W2
# --------------------------------------------------------------------------

def _jax_directions(key, n, dim, batch):
    """The directions the JAX sliced_wasserstein_distance draws under `key`."""
    out = []
    for b in range((n + batch - 1) // batch):
        size = min(batch, n - b * batch)
        d = random.normal(random.fold_in(key, b), (size, dim))
        out.append(d / jnp.linalg.norm(d, axis=1, keepdims=True))
    return torch.from_numpy(np.asarray(jnp.concatenate(out)))


@pytest.mark.parametrize("sizes", [(400, 400), (300, 500), (1000, 257)])
@pytest.mark.parametrize("batch", [64, 100])
def test_sliced_w2_with_injected_directions_matches_jax(sizes, batch):
    rng = np.random.default_rng(sum(sizes) + batch)
    a = rng.standard_normal((sizes[0], 4))
    b = rng.standard_normal((sizes[1], 4)) * 1.3 + 0.2
    key = random.PRNGKey(5)
    theirs = J.sliced_wasserstein_distance(jnp.asarray(a), jnp.asarray(b), n_projections=100,
                                           key=key, projection_batch_size=batch)
    ours = T.sliced_wasserstein_distance(torch.from_numpy(a), torch.from_numpy(b),
                                         n_projections=100, projection_batch_size=batch,
                                         directions=_jax_directions(key, 100, 4, batch))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL_W2)


def test_compute_sliced_w2_with_injected_draws_matches_jax():
    """The JAX protocol's draws replayed: the reference under the first
    split, the directions under the second (no subsample below n_ref)."""
    s = np.random.default_rng(8).standard_normal((300, 4, 5))
    key = random.PRNGKey(12)
    theirs = J.compute_sliced_w2(jnp.asarray(s), "standard_normal", 5, n_reference=3000,
                                 n_projections=60, key=key)
    key, k_ref = random.split(key)
    ref = j_reference("standard_normal", 5)(k_ref, 3000)
    key, k_dir = random.split(key)
    ours = T.compute_sliced_w2(torch.from_numpy(s), "standard_normal", 5, n_reference=3000,
                               n_projections=60, reference=torch.from_numpy(np.asarray(ref)),
                               directions=_jax_directions(k_dir, 60, 5, 500))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL_W2)


def test_tracker_with_injected_draws_matches_jax():
    key = random.PRNGKey(3)
    tr_j = J.ConvergenceW2Tracker("standard_normal", 5, n_reference=2000, n_projections=50,
                                  key=key)
    k_ref, k_dir, _ = random.split(key, 3)
    ref = torch.from_numpy(np.asarray(j_reference("standard_normal", 5)(k_ref, 2000)))
    tr_t = T.ConvergenceW2Tracker("standard_normal", 5, n_reference=2000, n_projections=50,
                                  reference=ref,
                                  directions=torch.from_numpy(np.asarray(tr_j._dirs)))
    for n in (100, 500, 2000):
        s = np.random.default_rng(n).standard_normal((n, 1, 5)) * 1.1
        np.testing.assert_allclose(tr_t.w2(torch.from_numpy(s)), tr_j.w2(jnp.asarray(s)),
                                   rtol=RTOL_W2)


def test_sliced_w2_own_directions_statistics():
    """The JAX package's own bounds (tests/test_diagnostics.py:86-145) with
    the port's generator-drawn directions and reference draws."""
    g = torch.Generator().manual_seed(6)
    s = torch.randn((5000, 4), generator=g, dtype=torch.float64)
    assert T.sliced_wasserstein_distance(s, s, n_projections=50) < 1e-6
    a = torch.randn((20000, 1), generator=g, dtype=torch.float64)
    b = torch.randn((20000, 1), generator=g, dtype=torch.float64) + 3.0
    assert abs(T.sliced_wasserstein_distance(a, b, n_projections=20) - 3.0) < 0.15
    a = torch.randn((3000, 3), generator=g, dtype=torch.float64)
    b = torch.randn((5000, 3), generator=g, dtype=torch.float64)
    assert T.sliced_wasserstein_distance(a, b, n_projections=100) < 0.1
    s = torch.randn((2000, 4, 5), generator=g, dtype=torch.float64)
    w2_full = T.compute_sliced_w2(s, "standard_normal", 5, n_reference=20000,
                                  n_projections=100)
    assert w2_full is not None and w2_full < 0.1
    assert T.compute_sliced_w2(s[:100, :2, :3], "concentric_l1_3d", 3) is None
    tr = T.ConvergenceW2Tracker("standard_normal", 5, n_reference=20000, n_projections=100,
                                generator=torch.Generator().manual_seed(3))
    assert tr.ok
    w2_tr = tr.w2(s)
    assert w2_tr is not None and w2_tr < 0.1 and abs(w2_tr - w2_full) < 0.05
    assert tr.w2(s) == w2_tr
    s_big = torch.randn((16000, 4, 5), generator=g, dtype=torch.float64)
    assert tr.w2(s_big) < w2_tr
    bad = T.ConvergenceW2Tracker("concentric_l1_3d", 3)
    assert not bad.ok and bad.w2(s) is None


def test_tracker_without_a_generator_draws_where_the_samples_lie():
    """Without a generator the tracker draws its reference and directions
    at the first checkpoint, on that checkpoint's device, from a generator
    seeded DEFAULT_REFERENCE_SEED there: the same as one given that
    generator, draw for draw."""
    s = torch.randn((300, 2, 4), generator=torch.Generator().manual_seed(8),
                    dtype=torch.float64)
    lazy = T.ConvergenceW2Tracker("standard_normal", 4, n_reference=1000, n_projections=30)
    assert lazy.ok and lazy.generator is None
    given = T.ConvergenceW2Tracker(
        "standard_normal", 4, n_reference=1000, n_projections=30,
        generator=torch.Generator().manual_seed(W.DEFAULT_REFERENCE_SEED))
    assert lazy.w2(s) == given.w2(s)
    assert lazy.generator.device.type == "cpu" and lazy._ref_sorted.device.type == "cpu"


def test_tracker_subsample_follows_its_generator():
    """Past n_reference a checkpoint is subsampled from the tracker's
    generator: restoring its state repeats the subsample (what a resumed
    run relies on)."""
    tr = T.ConvergenceW2Tracker("standard_normal", 3, n_reference=500, n_projections=20,
                                generator=torch.Generator().manual_seed(1))
    s = torch.randn((400, 4, 3), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    state = tr.generator.get_state()
    first = tr.w2(s)
    assert tr.w2(s) != first
    tr.generator.set_state(state)
    assert tr.w2(s) == first


def test_history_on_a_mesh_raises():
    """A history sharded over a device mesh no longer raises: it is
    gathered (full_tensor) and gives the plain history's diagnostics."""
    plain = torch.randn((40, 4, 3), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64)

    class Sharded:
        device_mesh = "mesh"

        def full_tensor(self):
            return plain
    assert torch.equal(T.ess_tail_chunked(Sharded()), T.ess_tail_chunked(plain))

