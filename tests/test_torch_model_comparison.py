"""Port parity of model comparison (PSIS-LOO, WAIC, compare, the GPD fit):
mcmc_tpu_torch against the JAX package on the same float64 matrices made
from a seed with numpy. k-hat, elpd (pointwise and summed), its standard
error and p_eff to rtol 1e-9 (WAIC's per-point penalty, a variance, also
within 1e-25 of zero where it is zero exactly); ranks and counts exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mcmc_tpu.diagnostics import model_comparison as J  # noqa: E402
from mcmc_tpu_torch.diagnostics import model_comparison as T  # noqa: E402

RTOL = 1e-9


def _conjugate_ll(seed=0, n=40, tau=2.0, s=1.0, mu_true=0.7, S=4000):
    """The conjugate normal-normal matrix of tests/test_model_comparison.py:
    y_i ~ N(mu, s^2), mu ~ N(0, tau^2), S exact posterior draws."""
    rng = np.random.default_rng(seed)
    y = rng.normal(mu_true, s, size=n)
    prec = 1.0 / tau**2 + n / s**2
    draws = rng.normal((y.sum() / s**2) / prec, np.sqrt(1.0 / prec), size=S)
    return (-0.5 * ((y[None, :] - draws[:, None]) / s) ** 2
            - 0.5 * np.log(2 * np.pi * s**2))


def _outlier_ll():
    rng = np.random.default_rng(1)
    y = rng.normal(0.0, 1.0, size=30)
    y[7] = 8.0
    draws = rng.normal(y.mean(), 1.0 / np.sqrt(len(y)), size=3000)
    return -0.5 * (y[None, :] - draws[:, None]) ** 2 - 0.5 * np.log(2 * np.pi)


def _constant_column_ll():
    rng = np.random.default_rng(5)
    draws = rng.normal(size=500)
    y = rng.normal(size=6)
    ll = -0.5 * (y[None, :] - draws[:, None]) ** 2
    ll[:, 3] = -1.234
    return ll


MATRICES = {
    "conjugate": _conjugate_ll,
    "conjugate_small": lambda: _conjugate_ll(seed=3, n=12, S=300),
    "outlier": _outlier_ll,
    "constant_column": _constant_column_ll,
    "history": lambda: _conjugate_ll(seed=4, n=9, S=400).reshape(100, 4, 9),
}


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=RTOL, **kw)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_psis_loo_matches_jax(name):
    ll = MATRICES[name]()
    ours = T.psis_loo(torch.from_numpy(ll))
    theirs = J.psis_loo(jnp.asarray(ll))
    _close(ours.khat.numpy(), theirs.khat)
    _close(ours.elpd_i.numpy(), theirs.elpd_i)
    for field in ("elpd", "se", "p_eff"):
        _close(getattr(ours, field), getattr(theirs, field), err_msg=field)
    assert ours.n_bad_khat == theirs.n_bad_khat


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_waic_matches_jax(name):
    ll = MATRICES[name]()
    ours = T.waic(torch.from_numpy(ll))
    theirs = J.waic(jnp.asarray(ll))
    _close(ours.elpd_i.numpy(), theirs.elpd_i)
    # a constant column's variance is 0 in exact arithmetic; XLA's reads
    # 1.8e-30 there, PyTorch's 0
    _close(ours.p_waic_i.numpy(), theirs.p_waic_i, atol=1e-25)
    for field in ("elpd", "se", "p_eff"):
        _close(getattr(ours, field), getattr(theirs, field), err_msg=field)
    assert ours.n_high_penalty == theirs.n_high_penalty


def test_compare_matches_jax():
    rng = np.random.default_rng(2)
    n, S = 50, 3000
    y = rng.normal(0.0, 1.0, size=n)
    draws = rng.normal(y.mean(), 1.0 / np.sqrt(n), size=S)
    mats = {s: -0.5 * ((y[None, :] - draws[:, None]) / s) ** 2 - 0.5 * np.log(2 * np.pi * s**2)
            for s in (1.0, 1.5, 3.0)}
    for fit_t, fit_j in ((T.psis_loo, J.psis_loo), (T.waic, J.waic)):
        ours = T.compare({f"s{s}": fit_t(torch.from_numpy(m)) for s, m in mats.items()})
        theirs = J.compare({f"s{s}": fit_j(jnp.asarray(m)) for s, m in mats.items()})
        assert ours["ranking"] == theirs["ranking"] == ["s1.0", "s1.5", "s3.0"]
        for model, row in theirs["table"].items():
            assert ours["table"][model].keys() == row.keys()
            for k, v in row.items():
                _close(ours["table"][model][k], v, atol=1e-12, err_msg=f"{model} {k}")
    with pytest.raises(ValueError, match="different data sizes"):
        T.compare({"a": T.psis_loo(torch.from_numpy(_conjugate_ll(n=40))),
                   "b": T.psis_loo(torch.from_numpy(_conjugate_ll(n=30)))})
    with pytest.raises(ValueError, match="at least one"):
        T.compare({})


@pytest.mark.parametrize("k_true", [-0.2, 0.3, 0.7, 0.8])
@pytest.mark.parametrize("M", [20, 2000])
def test_gpd_fit_matches_jax(k_true, M):
    u = np.random.default_rng(M + int(10 * k_true) + 20).uniform(1e-6, 1 - 1e-6, M)
    x = np.asarray(J._gpd_quantile(jnp.asarray(u), jnp.float64(k_true), jnp.float64(1.0)))
    _close(T._gpd_quantile(torch.from_numpy(u), torch.tensor(k_true, dtype=torch.float64),
                           torch.tensor(1.0, dtype=torch.float64)).numpy(), x)
    k_o, s_o = T._gpd_fit(torch.from_numpy(x))
    k_j, s_j = J._gpd_fit(jnp.asarray(x))
    _close(float(k_o), float(k_j))
    _close(float(s_o), float(s_j))


def test_gpd_fit_columns_match_one_at_a_time():
    """The port fits every column of a matrix at once; each column equals
    the JAX package's one-column fit."""
    rng = np.random.default_rng(11)
    x = np.abs(rng.standard_cauchy((50, 6))) + 1e-3
    k_o, s_o = T._gpd_fit(torch.from_numpy(x))
    for j in range(6):
        k_j, s_j = J._gpd_fit(jnp.asarray(x[:, j]))
        _close(float(k_o[j]), float(k_j))
        _close(float(s_o[j]), float(s_j))


def test_pointwise_log_likelihood_matches_jax():
    rng = np.random.default_rng(4)
    y = rng.normal(size=12)
    hist = rng.normal(size=(50, 4, 1))
    y_t = torch.from_numpy(y)
    ours = T.pointwise_log_likelihood(
        lambda th: -0.5 * (y_t - th[0]) ** 2 - 0.5 * np.log(2 * np.pi), torch.from_numpy(hist))
    theirs = J.pointwise_log_likelihood(
        lambda th: -0.5 * (jnp.asarray(y) - th[0]) ** 2 - 0.5 * jnp.log(2 * jnp.pi),
        jnp.asarray(hist))
    assert tuple(ours.shape) == (200, 12)
    _close(ours.numpy(), theirs)


def test_psis_loo_rejects_tiny_sample():
    with pytest.raises(ValueError, match=">= 25 draws"):
        T.psis_loo(torch.zeros((10, 5)))
