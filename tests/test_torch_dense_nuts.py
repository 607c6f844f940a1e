"""Port parity for persistent NUTS's dense metric (kernel 4b) and its target,
the compound-symmetry `correlated_gaussian`: the target and its kernel
device function against the JAX package, the eager dense machine against
the JAX XLA machine in float64, kernel 4's plain version against the JAX
Pallas window in interpret mode (dense, and dense with the multinomial
scheme) at W = 1 and 4 and at the oracle metric of the dense NUTS row,
the kernels' product order (trajectory.ordered_matmul) against a loop
written out, and on the run: the oracle metric samples the target and
beats the diagonal metric on bulk ESS."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mcmc_tpu import targets as jt  # noqa: E402
from mcmc_tpu.ops.padded_targets import make_padded_vag  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch import targets as tt  # noqa: E402
from mcmc_tpu_torch.diagnostics import ess_bulk  # noqa: E402
from mcmc_tpu_torch.ops.fused_trajectory import kernel_metric  # noqa: E402
from mcmc_tpu_torch.ops.padded_targets import (  # noqa: E402
    KERNEL_FAMILIES, device_params, kernel_info, make_device_vag)
from mcmc_tpu_torch.samplers import nuts_persistent as tn  # noqa: E402
from mcmc_tpu_torch.samplers.trajectory import dense_unwhitening, ordered_matmul  # noqa: E402
from test_torch_nuts_multinomial import (  # noqa: E402
    assert_state_close, random_metric, run_eager_against_jax, run_pallas_and_plain)


@pytest.mark.parametrize("dim", [6, 50])
def test_correlated_gaussian_matches_jax_f64(dim):
    x = np.random.default_rng(dim).standard_normal((32, dim)) * 2.0
    lp_j, g_j = jt.get_target("correlated_gaussian", dim=dim).value_and_grad_fn(
        jnp.asarray(x))
    t = tt.get_target("correlated_gaussian", dim=dim)
    lp_t, g_t = t.value_and_grad_fn(torch.from_numpy(x))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t.log_prob_fn(torch.from_numpy(x)).numpy(),
                               np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(
        t.true_cov.numpy(), np.asarray(jt.correlated_gaussian(dim).true_cov), rtol=1e-15)


@pytest.mark.parametrize("dim", [6, 50])
def test_correlated_device_function_matches_jax_padded_vag(dim):
    """The plain version of the kernels' device function against the JAX
    package's padded `_correlated` (transposed layout), float32."""
    x32 = np.random.default_rng(dim + 1).standard_normal((32, dim)).astype(np.float32)
    jtarget = jt.get_target("correlated_gaussian", dim=dim)
    d_pad = -(-dim // 8) * 8
    block = jnp.pad(jnp.asarray(x32), ((0, 0), (0, d_pad - dim))).T
    lp_j, g_j = make_padded_vag(jtarget.value_and_grad_fn, d_pad, dim_axis=0)(block)
    lp_t, g_t = make_device_vag(tt.get_target("correlated_gaussian", dim=dim)
                                .value_and_grad_fn)(torch.from_numpy(x32))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j)[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j).T[:, :dim], rtol=2e-5,
                               atol=2e-5)


def test_correlated_tag_kernel_families_and_reference_sampler():
    """The tag holds a, b and log|Sigma| as the JAX package computes them;
    target_from_tag carries a JAX tag across; kernels 1, 2 and 4 dispatch
    on the family, and kernel 3 too (its lane-group order); the exact
    sampler has covariance Sigma."""
    t = tt.get_target("correlated_gaussian", dim=7)
    info = kernel_info(t.value_and_grad_fn, "nuts")
    theirs = jt.get_target("correlated_gaussian", dim=7).value_and_grad_fn.pallas_info
    assert info["family"] == theirs["family"] and info["dim"] == 7
    assert info["params"] == pytest.approx(theirs["params"], rel=1e-14)
    assert interop.target_from_tag(theirs).params == {"correlation": pytest.approx(0.9)}
    assert device_params(info)[:2] == (info["params"]["a"], info["params"]["b"])
    assert kernel_info(t.value_and_grad_fn, "grahmc") is info
    assert "correlated_gaussian" in KERNEL_FAMILIES["rwmh"]
    assert kernel_info(t.value_and_grad_fn, "rwmh") is info
    with pytest.raises(ValueError):
        interop.target_from_tag(dict(theirs, params=dict(theirs["params"], a=3.0)))
    draws = tt.get_reference_sampler("correlated_gaussian", 7)(
        torch.Generator().manual_seed(0), 200000)
    np.testing.assert_allclose(torch.cov(draws.T).numpy(), t.true_cov.numpy(), atol=0.02)
    assert tt.get_reference_sampler("rosenbrock", 7) is None


def test_dense_unwhitening_and_window_metric():
    """z @ L^{-1} has covariance M = (M^{-1})^{-1}; the kernels' metric
    (fused_trajectory.kernel_metric, which kernel 4's window takes too)
    factors a dense metric in float64 and hands the kernel float32, a
    diagonal one passes through without l_inv."""
    inv_mass = torch.from_numpy(random_metric(4).astype(np.float64))
    l_inv = dense_unwhitening(inv_mass)
    z = torch.randn((200000, 4), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    np.testing.assert_allclose(torch.cov((z @ l_inv).T).numpy(),
                               torch.linalg.inv(inv_mass).numpy(), atol=0.03)
    im, li = kernel_metric(inv_mass)
    assert im.dtype == li.dtype == torch.float32
    torch.testing.assert_close(li, l_inv.float())
    im, li = kernel_metric(torch.ones(4, dtype=torch.float64))
    assert li is None and im.dtype == torch.float32


def test_eager_dense_machine_matches_jax_window_step():
    """The eager endpoint machine with a dense metric against JAX
    _make_window_step on injected xs, float64, to 1e-10."""
    s, theirs = run_eager_against_jax("correlated_gaussian", 6, 0.3,
                                      random_metric(6).astype(np.float64), "endpoint")
    assert_state_close(s, theirs, 1e-10)
    assert int(s.transitions.sum()) > 16


@pytest.mark.parametrize("multinomial", [False, True])
@pytest.mark.parametrize("slots", [1, 4])
def test_plain_window_dense_matches_pallas_kernel(slots, multinomial):
    """Kernel 4b's plain version (and 4a with 4b) against make_fused_nuts_
    window(interpret=True, dense=True) at tests/test_fused_nuts.py's dense
    shape (16 chains, D = 6, step 0.3, a random SPD metric), on the 6-D
    correlated Gaussian: discrete state equal, continuous within 2e-4."""
    out, theirs = run_pallas_and_plain("correlated_gaussian", 6, 0.3, slots,
                                       random_metric(6), multinomial)
    assert_state_close(out, theirs, 2e-4)
    assert int(out.transitions.sum()) > 16


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_multinomial_dense_samples_correlated_gaussian(backend):
    """tests/test_nuts_persistent.py::test_multinomial_scheme_with_dense_
    metric on the port: the oracle metric with the multinomial scheme on
    the 6-D rho = 0.9 Gaussian recovers its covariance within 0.12."""
    t = tt.get_target("correlated_gaussian", dim=6)
    init = torch.randn((256, 6), generator=torch.Generator().manual_seed(3))
    r = tn.nuts_run_persistent(
        torch.Generator().manual_seed(9), t.log_prob_fn, init, step_size=0.5,
        num_samples=100, steps_per_sample=16, burn_in_steps=64,
        inv_mass_matrix=t.true_cov, value_and_grad_fn=t.value_and_grad_fn,
        proposal_scheme="multinomial", backend=backend)
    s = r.samples.reshape(-1, 6).double()
    assert float((torch.cov(s.T) - t.true_cov).abs().max()) < 0.12
    assert abs(float(s.mean())) < 0.05
    assert float(r.info["mean_accept_probs"].mean()) > 0.6


def test_dense_oracle_metric_beats_diagonal():
    """tests/test_dense_metric.py::test_hmc_dense_oracle_metric_beats_diagonal
    for persistent NUTS: on the 6-D rho = 0.9 Gaussian at the same step and
    slots, the oracle dense metric's min bulk-ESS is more than 3x the
    diagonal metric's."""
    t = tt.get_target("correlated_gaussian", dim=6)
    init = torch.randn((256, 6), generator=torch.Generator().manual_seed(3))
    ess = {}
    for name, inv_mass in (("dense", t.true_cov), ("diag", torch.diag(t.true_cov))):
        r = tn.nuts_run_persistent(
            torch.Generator().manual_seed(9), t.log_prob_fn, init, step_size=0.5,
            num_samples=200, steps_per_sample=8, burn_in_steps=64,
            inv_mass_matrix=inv_mass, value_and_grad_fn=t.value_and_grad_fn,
            backend="eager")
        ess[name] = float(ess_bulk(r.samples).min())
    assert ess["dense"] > 3 * ess["diag"], ess


def _in_order_written_out(x, a):
    """x @ a one output at a time: x_i a_id added for i in order from -0,
    each product rounded (float32 numpy scalars: every operation rounds
    once)."""
    x, a = x.numpy(), a.numpy()
    out = np.empty((x.shape[0], a.shape[1]), dtype=x.dtype)
    for c in range(x.shape[0]):
        for d in range(a.shape[1]):
            acc = x.dtype.type(-0.0)
            for i in range(a.shape[0]):
                acc = acc + x[c, i] * a[i, d]
            out[c, d] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("dim", [1, 3, 6, 10, 50])
def test_ordered_matmul_bit_for_bit(dim, lower):
    """ordered_matmul, the order of csrc/metric.cuh's products (its loop over
    i outside the registers changes no output's order), equals the sum
    written out bit for bit, from -0 as the kernel starts it; on the
    lower-triangular L^{-1} of the unwhitening too, whose zero terms the
    kernel skips: they leave the sums unchanged."""
    rng = np.random.default_rng(dim * 10 + lower)
    x = torch.from_numpy(rng.standard_normal((5, dim)).astype(np.float32))
    m = torch.from_numpy(random_metric(dim))
    if lower:
        m = dense_unwhitening(m.double()).float()
        assert torch.equal(m, m.tril())
    got = ordered_matmul(x, m)
    assert torch.equal(got.view(torch.int32), _in_order_written_out(x, m).view(torch.int32))


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("multinomial", [False, True])
def test_plain_window_at_the_oracle_metric(multinomial, slots):
    """test_plain_window_dense_matches_pallas_kernel at the dense NUTS row's
    metric: the rho = 0.9 Gaussian's oracle metric at D = 50, condition
    number 451, whose products cancel (csrc/metric.cuh), step 0.3: discrete
    state equal, continuous within 2e-4; a chain split here would be a
    finding, not a tolerance."""
    cov = tt.get_target("correlated_gaussian", dim=50).true_cov.numpy().astype(np.float32)
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    assert ev.max() / ev.min() == pytest.approx(451.0, rel=1e-3)
    out, theirs = run_pallas_and_plain("correlated_gaussian", 50, 0.3, slots, cov, multinomial)
    assert_state_close(out, theirs, 2e-4)
    assert int(out.transitions.sum()) > 16
