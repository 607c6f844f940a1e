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


def _draws(dim, n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim))
    x[:, 0] *= 2.0      # funnel neck over a wide range: exp(-x0) in [~e^-6, ~e^6]
    return x


@pytest.mark.parametrize("dim", [10, 50])
@pytest.mark.parametrize("family", FAMILIES)
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
@pytest.mark.parametrize("family", FAMILIES)
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
        tt.get_target("rosenbrock", dim=5)
    with pytest.raises(TypeError):
        kernel_info(lambda x: (x.sum(-1), x))

    def untagged_family(x):
        return x.sum(-1), x
    untagged_family.kernel_info = {"family": "rosenbrock", "dim": 3, "params": {}}
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
