"""Port parity: bulk ESS, split R-hat (monolithic and chain-chunked) and dual
averaging of mcmc_tpu_torch against the JAX package, in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from scipy.special import ndtri  # noqa: E402
from scipy.stats import rankdata  # noqa: E402

from mcmc_tpu.diagnostics import rhat_ess as j_re  # noqa: E402
from mcmc_tpu.diagnostics import streaming as j_st  # noqa: E402
from mcmc_tpu.tuning import dual_averaging as j_da  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.diagnostics import (ess_bulk, ess_bulk_chunked,  # noqa: E402
                                        split_rhat, split_rhat_chunked)
from mcmc_tpu_torch.diagnostics.rhat_ess import _rank_normalize  # noqa: E402
from mcmc_tpu_torch.tuning import dual_averaging as t_da  # noqa: E402


def _history(seed=0, shape=(200, 16, 5)):
    """AR(1) chains with per-chain offsets, rounded so that ties occur."""
    rng = np.random.default_rng(seed)
    S, C, D = shape
    x = np.empty(shape)
    x[0] = rng.standard_normal((C, D))
    for s in range(1, S):
        x[s] = 0.7 * x[s - 1] + rng.standard_normal((C, D))
    x += rng.standard_normal((1, C, D)) * 0.3
    x[:, :, 1] *= 50.0                      # a wide dim and an offset one
    x[:, :, 2] += 1e3
    return np.round(x, 1)


def test_history_has_ties():
    x = _history()
    assert np.unique(x[:, :, 0]).size < x[:, :, 0].size // 2


def test_rank_normalize_matches_scipy_average_ranks():
    x = _history()[:, :, :3]
    n, m, d = x.shape
    z = _rank_normalize(torch.from_numpy(x)).numpy()
    for k in range(d):
        r = rankdata(x[:, :, k].reshape(-1), method="average")
        expected = ndtri((r - 0.375) / (n * m + 0.25)).reshape(n, m)
        np.testing.assert_allclose(z[:, :, k], expected, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stat", ["ess_bulk", "split_rhat"])
@pytest.mark.parametrize("draws", [200, 201])
def test_monolithic_matches_jax(stat, draws):
    x = _history(1, (draws, 16, 5))
    ours = {"ess_bulk": ess_bulk, "split_rhat": split_rhat}[stat]
    theirs = {"ess_bulk": j_re.ess_bulk, "split_rhat": j_re.split_rhat}[stat]
    a = ours(torch.from_numpy(x))
    assert a.dtype == torch.float64 and a.shape == (5,)
    np.testing.assert_allclose(a.numpy(), np.asarray(theirs(jnp.asarray(x))),
                               rtol=1e-8)


@pytest.mark.parametrize("chain_chunk,dim_chunk", [(5, 2), (16, 8), (8, 4)])
def test_chunked_matches_jax_and_monolithic(chain_chunk, dim_chunk):
    x = _history(2)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ess = ess_bulk_chunked(xt, chain_chunk=chain_chunk, dim_chunk=dim_chunk)
    rhat = split_rhat_chunked(xt, chain_chunk=chain_chunk, dim_chunk=dim_chunk)
    np.testing.assert_allclose(
        ess.numpy(), np.asarray(j_st.ess_bulk_chunked(
            xj, chain_chunk=chain_chunk, dim_chunk=dim_chunk)), rtol=1e-8)
    np.testing.assert_allclose(
        rhat.numpy(), np.asarray(j_st.split_rhat_chunked(
            xj, chain_chunk=chain_chunk, dim_chunk=dim_chunk)), rtol=1e-8)
    np.testing.assert_allclose(ess.numpy(), ess_bulk(xt).numpy(), rtol=1e-8)
    np.testing.assert_allclose(rhat.numpy(), split_rhat(xt).numpy(), rtol=1e-8)


def test_diagnostics_see_a_stuck_chain_and_constant_dim():
    x = _history(3)
    x[:, 0, :] = 5.0                       # one chain stuck far away
    x[:, :, 4] = 1.0                       # a constant dim
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    r = split_rhat(xt).numpy()
    assert r[0] > 1.1
    np.testing.assert_allclose(r[:4], np.asarray(j_re.split_rhat(xj))[:4], rtol=1e-8)
    e = ess_bulk(xt).numpy()
    np.testing.assert_allclose(e[:4], np.asarray(j_re.ess_bulk(xj))[:4], rtol=1e-8)
    # the constant dim has zero variance: the guard reports S * C. (The JAX
    # estimator returns roundoff there: its chain means of identical scores
    # are not exactly equal.)
    assert e[4] == x.shape[0] * x.shape[1]


def test_dual_averaging_sequence_matches_jax():
    rng = np.random.default_rng(4)
    accepts = rng.uniform(0.2, 1.0, 50)
    js = j_da.da_init(0.1)
    ts = t_da.da_init(0.1, dtype=torch.float64, device="cpu")
    for k, a in enumerate(accepts):
        js = j_da.da_update(js, a, 0.65)
        # alternate a number and a 0-d tensor accept statistic
        stat = float(a) if k % 2 else torch.tensor(a, dtype=torch.float64)
        ts = t_da.da_update(ts, stat, 0.65)
        for ours, theirs in zip(ts, js):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12)
    np.testing.assert_allclose(t_da.da_step_size(ts).numpy(),
                               np.asarray(j_da.da_step_size(js)), rtol=1e-12)
    np.testing.assert_allclose(t_da.da_final_step_size(ts).numpy(),
                               np.asarray(j_da.da_final_step_size(js)), rtol=1e-12)


def test_dual_averaging_state_carries_across():
    """A JAX DA state moved through interop continues identically."""
    rng = np.random.default_rng(5)
    js = j_da.da_init(0.3)
    for a in rng.uniform(0.3, 0.9, 7):
        js = j_da.da_update(js, a, 0.8)
    ts = interop.da_state_from_numpy(*(np.asarray(v) for v in js), device="cpu")
    for a in rng.uniform(0.3, 0.9, 5):
        js = j_da.da_update(js, a, 0.8)
        ts = t_da.da_update(ts, float(a), 0.8)
    for ours, theirs in zip(ts, js):
        assert ours.shape == ()
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12)
