"""Port parity: mcmc_tpu_torch targets and their kernel device functions
against the JAX package, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mcmc_tpu import targets as jt  # noqa: E402
from mcmc_tpu.ops.padded_targets import make_padded_vag  # noqa: E402
from mcmc_tpu_torch import targets as tt  # noqa: E402
from mcmc_tpu_torch.ops.padded_targets import (  # noqa: E402
    FAMILY_IDS, kernel_info, make_device_vag)

FAMILIES = ["standard_normal", "neals_funnel"]
VAG_FAMILIES = FAMILIES + ["gaussian_mixture"]


def _draws(dim, n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim))
    x[:, 0] *= 2.0      # funnel neck over a wide range: exp(-x0) in [~e^-6, ~e^6]
    return x


@pytest.mark.parametrize("dim", [10, 50])
@pytest.mark.parametrize("family", VAG_FAMILIES)
def test_value_and_grad_matches_jax_f64(family, dim):
    x = _draws(dim)
    lp_j, g_j = jt.get_target(family, dim=dim).value_and_grad_fn(jnp.asarray(x))
    t = tt.get_target(family, dim=dim)
    lp_t, g_t = t.value_and_grad_fn(torch.from_numpy(x))
    assert lp_t.dtype == torch.float64
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(t.log_prob_fn(torch.from_numpy(x)).numpy(),
                               np.asarray(lp_j), rtol=1e-12)


@pytest.mark.parametrize("dim", [10, 50])
@pytest.mark.parametrize("family", VAG_FAMILIES)
def test_device_function_matches_jax_padded_vag(family, dim):
    """The plain version of the kernels' device function against the JAX
    package's padded device function (transposed layout) on the real
    coordinates, in float32."""
    x32 = _draws(dim, seed=1).astype(np.float32)
    jtarget = jt.get_target(family, dim=dim)
    d_pad = -(-dim // 8) * 8
    block = jnp.pad(jnp.asarray(x32), ((0, 0), (0, d_pad - dim))).T
    lp_j, g_j = make_padded_vag(jtarget.value_and_grad_fn, d_pad, dim_axis=0)(block)
    lp_t, g_t = make_device_vag(tt.get_target(family, dim=dim).value_and_grad_fn)(
        torch.from_numpy(x32))
    assert lp_t.dtype == torch.float32 and g_t.shape == (32, dim)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j)[0], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j).T[:, :dim],
                               rtol=2e-5, atol=2e-5)


def test_kernel_tag_and_registry():
    for family in FAMILIES:
        t = tt.get_target(family, dim=7)
        info = kernel_info(t.value_and_grad_fn)
        assert info == {"family": family, "dim": 7, "params": {}}
        assert info == jt.get_target(family, dim=7).value_and_grad_fn.pallas_info
        assert family in FAMILY_IDS
    with pytest.raises(ValueError):
        tt.get_target("no_such_target", dim=5)
    with pytest.raises(TypeError):
        kernel_info(lambda x: (x.sum(-1), x))

    def untagged_family(x):
        return x.sum(-1), x
    untagged_family.kernel_info = {"family": "no_such_family", "dim": 3, "params": {}}
    with pytest.raises(KeyError):
        make_device_vag(untagged_family)


@pytest.mark.parametrize("family", FAMILIES)
def test_init_sampler_shapes_and_scale(family):
    t = tt.get_target(family, dim=6)
    g = torch.Generator().manual_seed(0)
    x = t.init_sampler(g, 20000)
    assert x.shape == (20000, 6) and x.dtype == torch.float32
    sd = x.std(dim=0).numpy()
    expected = np.ones(6)
    if family == "neals_funnel":
        expected[0] = 3.0     # neck drawn from its N(0, 9) prior
    np.testing.assert_allclose(sd, expected, rtol=0.05)
    assert t.init_sampler(g, 4, dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("dim_axis", [0, 1])
@pytest.mark.parametrize("separation", [5.0, 10.0])
def test_mixture_device_function_matches_jax_f64(separation, dim_axis):
    """The mixture's plain device function against the JAX package's
    _gaussian_mixture (padded, both TPU layouts) in float64, to 1e-12, with
    x0 across both modes and the barrier."""
    dim = 7
    x = _draws(dim, seed=2) * 3.0
    jtarget = jt.gaussian_mixture(dim, separation=separation)
    d_pad = 128 if dim_axis == 1 else 8
    block = jnp.pad(jnp.asarray(x), ((0, 0), (0, d_pad - dim)))
    lp_j, g_j = make_padded_vag(jtarget.value_and_grad_fn, d_pad, dim_axis=dim_axis)(
        block if dim_axis == 1 else block.T)
    lp_j, g_j = (np.asarray(lp_j).reshape(-1), np.asarray(g_j if dim_axis == 1 else g_j.T))
    lp_t, g_t = make_device_vag(tt.gaussian_mixture(dim, separation=separation)
                                .value_and_grad_fn)(torch.from_numpy(x))
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), g_j[:, :dim], rtol=1e-12, atol=1e-300)
    assert np.all(g_j[:, dim:] == 0.0)


def test_mixture_tag_params_and_init_sampler():
    """The mixture's tag is the JAX package's (separation), its kernel
    parameters are (sep / 2, 0, 0, 0), the device function runs in every
    kernel (1 and 2, kernel 3's lane groups, kernel 4), and init_sampler
    puts half the chains near each mode with
    the two halves' x0 noise one draw's prefix, as the JAX package's reused
    key gives."""
    from mcmc_tpu_torch.ops.padded_targets import KERNEL_FAMILIES, device_params
    t = tt.get_target("gaussian_mixture", dim=5, separation=6.0)
    info = kernel_info(t.value_and_grad_fn, "grahmc")
    assert info == {"family": "gaussian_mixture", "dim": 5, "params": {"separation": 6.0}}
    assert info == jt.gaussian_mixture(5, separation=6.0).value_and_grad_fn.pallas_info
    assert FAMILY_IDS["gaussian_mixture"] == 3 and device_params(info) == (3.0, 0.0, 0.0, 0.0)
    for kernel in ("rwmh", "nuts"):
        assert "gaussian_mixture" in KERNEL_FAMILIES[kernel]
        assert kernel_info(t.value_and_grad_fn, kernel) is info
    np.testing.assert_allclose(torch.diagonal(t.true_cov).numpy(), [10.0, 1, 1, 1, 1])
    x = t.init_sampler(torch.Generator().manual_seed(0), 20001)
    assert x.shape == (20001, 5) and x.dtype == torch.float32
    left, right = x[:10000, 0], x[10000:, 0]
    torch.testing.assert_close(left + 3.0, right[:10000] - 3.0)
    np.testing.assert_allclose([float(left.mean()), float(right.mean())], [-3.0, 3.0],
                               atol=0.05)
    np.testing.assert_allclose(x[:, 1:].std(dim=0).numpy(), 1.0, rtol=0.05)
    with pytest.raises(NotImplementedError):
        tt.gaussian_mixture(4, n_modes=3)


@pytest.mark.parametrize("family", ["standard_normal", "correlated_gaussian", "neals_funnel",
                                    "gaussian_mixture"])
def test_reference_samplers_are_exact(family):
    """get_reference_sampler of each ported target with an exact sampler:
    200,000 draws whose moments pass z-gates (|z| < 5) against the target's
    true mean and variance, with the funnel's rest rescaled by exp(x0 / 2)
    to N(0, 1) and the mixture's mode share 1/2; has_reference_sampler
    agrees with the JAX package's for every ported name."""
    dim, n = 4, 200_000
    sampler = tt.get_reference_sampler(family, dim)
    x = sampler(torch.Generator().manual_seed(3), n)
    assert x.shape == (n, dim) and x.dtype == torch.float64
    target = tt.get_target(family, dim=dim)
    if family == "neals_funnel":
        x = torch.cat([x[:, :1] / 3.0, x[:, 1:] / torch.exp(x[:, :1] / 2.0)], dim=1)
        mean, var = torch.zeros(dim), torch.ones(dim)
    else:
        mean, var = target.true_mean, torch.diagonal(target.true_cov)
    z_mean = (x.mean(0) - mean) / torch.sqrt(var / n)
    # Var of the sample variance: (m4 - var^2) / n, m4 from the draws
    m4 = ((x - x.mean(0)) ** 4).mean(0)
    z_var = (x.var(0) - var) / torch.sqrt((m4 - var ** 2) / n)
    assert float(z_mean.abs().max()) < 5.0 and float(z_var.abs().max()) < 5.0
    if family == "gaussian_mixture":
        share = float((x[:, 0] > 0).double().mean())
        assert abs(share - 0.5) < 5 * (0.25 / n) ** 0.5
    if family == "correlated_gaussian":
        corr = torch.corrcoef(x.T)[0, 1]
        assert abs(float(corr) - 0.9) < 0.005
    assert tt.has_reference_sampler(family) == jt.has_reference_sampler(family) is True
    for name in ("hierarchical_logistic", "concentric_l1_2d", "nested_l1_3d"):
        assert not tt.has_reference_sampler(name)
        assert not jt.has_reference_sampler(name)
    assert tt.get_reference_sampler("gaussian_mixture", dim, n_modes=3) is None
