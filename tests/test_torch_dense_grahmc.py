"""Port parity for the dense variants of the fused GRAHMC kernels (1a, 2a):
their plain versions against the JAX package's Pallas kernels in interpret
mode on the same injected draws, the Philox momentum through L^{-1}, the
prepared metric, the wrapper contracts, and grahmc_run(backend="fused")
with a dense metric through both dispatches.

The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrappers take their plain versions because the
tensors lie on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.ops import _cuda  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers.base import init_chain_state  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402

FAMILIES = ["standard_normal", "neals_funnel", "correlated_gaussian"]


def _t(a):
    return torch.from_numpy(np.array(a))


def random_metric(dim, seed=0):
    """A well-conditioned random dense M^{-1} (float32), as
    tests/test_dense_metric.py builds it."""
    a = np.random.default_rng(seed).standard_normal((dim, dim))
    return (a @ a.T / dim + 0.5 * np.eye(dim)).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layout", ["lanes", "transposed"])
def test_step_plain_dense_matches_pallas_debug_kernel(family, layout):
    """Kernel 1a's plain version == the JAX fused kernel with a dense
    metric (interpret mode) on injected momentum and uniforms, in both TPU
    block layouts, as tests/test_dense_metric.py::
    test_fused_debug_dense_matches_xla holds the JAX kernel: accepts equal,
    q within 2e-4, delta H within 2e-3."""
    dim, n_chains, L = 6, 8, 5
    eps, gamma, steep = (0.05 if family == "neals_funnel" else 0.1), 1.0, 0.5
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((n_chains, dim)) * 0.7).astype(np.float32)
    p0 = rng.standard_normal((n_chains, dim)).astype(np.float32)
    u = rng.uniform(size=n_chains).astype(np.float32)
    invm = random_metric(dim)
    jt = j_get_target(family, dim=dim)
    lp, grad = (np.asarray(a, np.float32) for a in jt.value_and_grad_fn(jnp.asarray(q)))
    run_j = jft.make_debug_trajectory(jt.value_and_grad_fn, L, jg.tanh_schedule, n_chains,
                                      dim, layout=layout)
    qj, lpj, gj, accj, dhj = run_j(*(jnp.asarray(a) for a in (q, lp, grad, p0, u)), eps,
                                   gamma, steep, jnp.asarray(invm))
    tt = t_get_target(family, dim=dim)
    run_t = ft.make_debug_trajectory(tt.value_and_grad_fn, L, tg.tanh_schedule, n_chains, dim)
    qt, lpt, gt, acct, dht = run_t(*(_t(a) for a in (q, lp, grad, p0, u)), eps, gamma,
                                   steep, _t(invm))
    np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
    for ours, theirs in ((qt, qj), (lpt, lpj), (gt, gj)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dht.numpy(), np.asarray(dhj), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_multistep_plain_dense_matches_pallas_multistep_kernel(family):
    """Kernel 2a's plain version == the JAX multi-transition kernel with a
    dense metric (interpret mode), its draws reproduced from the key split:
    p0_t = L^{-T} z_t on the padded block. Accepts equal; 1e-6, with 1e-5 on
    delta H and the gradients (differences of float32 sums taken in another
    order)."""
    dim, C, T, L = 10, 16, 4, 6
    eps, gamma, steep = 0.1, 1.0, 0.5
    jt = j_get_target(family, dim=dim)
    init = (np.random.default_rng(8).standard_normal((C, dim)) * 0.4).astype(np.float32)
    state = jbase.init_chain_state(jnp.asarray(init), jt.log_prob_fn, jt.value_and_grad_fn)
    state = state._replace(position=state.position.astype(jnp.float32),
                           log_prob=state.log_prob.astype(jnp.float32),
                           grad_log_prob=state.grad_log_prob.astype(jnp.float32))
    invm = random_metric(dim, 2)
    key = random.PRNGKey(7)
    multi = jft.make_fused_grahmc_multistep(jt.log_prob_fn, jt.value_and_grad_fn, L,
                                            jg.tanh_schedule, T, interpret=True)
    _, ms, (acc_j, hist_q_j, hist_lp_j, dh_j) = multi(key, state, eps, gamma, steep,
                                                      jnp.asarray(invm))

    d_pad = 16
    _, seed_key = random.split(key)
    k_mom, k_u = random.split(seed_key)
    _, unwhiten = jft._resolve_dense_metric(jnp.asarray(invm), dim, d_pad, dim_axis=0)
    z = random.normal(k_mom, (T, d_pad, C), jnp.float32)
    p0 = jax.vmap(jft.unwhiten_op(unwhiten, 0))(z)
    u = random.uniform(k_u, (T, C), jnp.float32)
    p0 = np.ascontiguousarray(np.transpose(np.asarray(p0)[:, :dim, :], (0, 2, 1)))

    tt = t_get_target(family, dim=dim)
    prepared = ft.prepare_dense_metric(_t(invm))
    q1, lp1, g1, acc_t, dh_t, hist_q_t, hist_lp_t = ft.grahmc_multistep_kernel(
        tt.value_and_grad_fn.kernel_info, L, ft.SCHEDULE_IDS["tanh"], T,
        _t(state.position), _t(state.log_prob), _t(state.grad_log_prob),
        ft.kernel_scalars(eps, gamma, steep, "cpu"), prepared.invm, p0=_t(p0), u=_t(u),
        l_inv=prepared.l_inv)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    for a, b in ((hist_q_t, hist_q_j), (hist_lp_t, hist_lp_j), (q1, ms.position),
                 (lp1, ms.log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(ms.grad_log_prob), rtol=1e-6, atol=1e-5)


def test_multistep_dense_plain_equals_chained_step_plain():
    """T transitions of kernel 2a == T chained kernel-1a transitions on the
    same Philox stream, the momentum unwhitened through L^{-1}."""
    dim, C, T = 12, 32, 4
    t = t_get_target("correlated_gaussian", dim=dim)
    info = t.value_and_grad_fn.kernel_info
    q = t.init_sampler(torch.Generator().manual_seed(0), C) * 0.5
    lp, g = t.value_and_grad_fn(q)
    scalars = ft.kernel_scalars(0.1, 0.5, 1.0, "cpu")
    invm, l_inv = ft.prepare_dense_metric(_t(random_metric(dim, 3)))
    key = torch.tensor([12345, -678], dtype=torch.int32)
    out = ft.grahmc_multistep_kernel(info, 5, 1, T, q, lp, g, scalars, invm, key=key,
                                     call=3, l_inv=l_inv)
    qs, lps, gs = q, lp, g
    for k in range(T):
        p0 = ft.unwhiten(ft.philox_normal(key, 3, k, C, dim, "cpu"), invm, l_inv)
        u = ft.philox_uniform(key, 3, k, C, "cpu")
        qs, lps, gs, acc, dh, _, _ = ft.grahmc_step_kernel(
            info, 5, 1, qs, lps, gs, scalars, invm, p0=p0, u=u, l_inv=l_inv)
        assert torch.equal(acc, out[3][k])
        assert torch.equal(qs, out[5][k]) and torch.equal(lps, out[6][k])
    assert torch.equal(gs, out[2])


@pytest.mark.parametrize("dim,rho", [(2, 0.8), (5, 0.5)])
def test_philox_momentum_through_l_inv_has_covariance_m(dim, rho):
    """The kernels' momentum draw, Philox normals times L^{-1}: covariance
    M = (M^{-1})^{-1} to 0.02 (as tests/test_dense_metric.py::
    test_dense_momentum_covariance)."""
    inv_mass = (1.0 - rho) * torch.eye(dim, dtype=torch.float64) + rho
    invm, l_inv = ft.prepare_dense_metric(inv_mass)
    z = ft.philox_normal(torch.tensor([5, 6], dtype=torch.int32), 0, 0, 200000, dim, "cpu")
    p = ft.unwhiten(z, invm, l_inv)
    np.testing.assert_allclose(torch.cov(p.T.double()).numpy(),
                               torch.linalg.inv(inv_mass).numpy(), atol=0.02)


def test_prepared_dense_metric_matches_raw_and_jax():
    """A PreparedDenseMetric gives the same transition as the raw (D, D)
    matrix; the JAX package's prepared metric, padded to its TPU block,
    carries across with the padding cut; malformed metrics raise."""
    dim = 4
    t = t_get_target("correlated_gaussian", dim=dim)
    raw = t.true_cov.to(torch.float32)
    prepared = ft.prepare_dense_metric(raw)
    assert ft.is_dense_metric(raw) and ft.is_dense_metric(prepared)
    assert not ft.is_dense_metric(torch.ones(dim))
    q = t.init_sampler(torch.Generator().manual_seed(11), 16)
    cs = init_chain_state(q, t.log_prob_fn, t.value_and_grad_fn)
    fused = ft.make_fused_grahmc_step(t.value_and_grad_fn, 6, None)
    key = torch.tensor([4, 5], dtype=torch.int32)
    s_raw, (acc_raw, *_) = fused(ft.PhiloxStream(key), cs, 0.4, 0.0, 1.0, raw)
    s_prep, (acc_prep, *_) = fused(ft.PhiloxStream(key), cs, 0.4, 0.0, 1.0, prepared)
    assert torch.equal(s_raw.position, s_prep.position) and torch.equal(acc_raw, acc_prep)

    j_prep = jft.prepare_dense_metric(jnp.asarray(raw.numpy()), dim, layout="lanes")
    assert j_prep.invm.shape == (128, 128)
    carried = interop.metric_from_numpy(np.asarray(j_prep.invm), np.asarray(j_prep.l_inv),
                                        dim, device="cpu")
    assert isinstance(carried, ft.PreparedDenseMetric)
    assert torch.equal(carried.invm, prepared.invm)
    np.testing.assert_allclose(carried.l_inv.numpy(), prepared.l_inv.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the kernels' unwhitening skips L^{-1}'s upper triangle, so it is zero
    for m in (prepared, carried):
        assert torch.equal(m.l_inv, m.l_inv.tril())
    with pytest.raises(ValueError, match="dim"):
        interop.metric_from_numpy(np.asarray(j_prep.invm), np.asarray(j_prep.l_inv),
                                  device="cpu")
    assert torch.equal(interop.metric_from_numpy(np.ones(dim), device="cpu"),
                       torch.ones(dim, dtype=torch.float64))
    for bad in (torch.ones(dim, dim + 1), torch.ones(2, dim, dim)):
        with pytest.raises(ValueError):
            ft.prepare_dense_metric(bad)
    with pytest.raises(ValueError):
        ft.kernel_metric(torch.ones(2, dim, dim))


def test_dense_wrapper_contracts():
    """A dense inv_mass needs its l_inv (and a diagonal one none), both
    (D, D); on tensors not on the CPU the wrappers launch or raise, dense
    as diagonal; the CPU path counts no launch of either variant."""
    dim, C = 5, 4
    t = t_get_target("standard_normal", dim=dim)
    info = t.value_and_grad_fn.kernel_info
    q = torch.zeros((C, dim))
    args = (info, 4, 0, q, torch.zeros(C), torch.zeros_like(q), torch.ones(3))
    invm, l_inv = ft.prepare_dense_metric(torch.eye(dim))
    key = torch.zeros(2, dtype=torch.int32)
    for inv_mass, linv in ((invm, None), (torch.ones(dim), l_inv),
                           (invm, torch.eye(dim + 1))):
        with pytest.raises(ValueError):
            ft.grahmc_step_kernel(*args, inv_mass, key=key, l_inv=linv)
    ft.reset_launches()
    ft.grahmc_step_kernel(*args, invm, key=key, l_inv=l_inv)
    ft.grahmc_multistep_kernel(*args[:3], 2, *args[3:], invm, key=key, l_inv=l_inv)
    for kernel in (ft.grahmc_step_kernel, ft.grahmc_multistep_kernel):
        assert kernel.launches == 0
        assert kernel.variant_launches == {"diagonal": 0, "dense": 0, "diagonal+data": 0,
                                           "dense+data": 0}
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        ft.grahmc_step_kernel(*meta, invm.to("meta"), key=key.to("meta"),
                              l_inv=l_inv.to("meta"))
    assert ft.grahmc_step_kernel.variant_launches["dense"] == 0


@pytest.mark.parametrize("track_proposals", [False, True])
def test_fused_grahmc_run_dense_oracle_moments(monkeypatch, track_proposals):
    """grahmc_run(backend="fused") with the oracle dense metric on the
    rho = 0.9 Gaussian recovers Sigma to 0.15 (tests/test_dense_metric.py::
    test_fused_grahmc_run_dense_{multistep,single_step}_moments): 64 chains
    take kernel 2a (T = 4), tracked proposals kernel 1a; the metric is
    factored once per run."""
    dim = 4
    t = t_get_target("correlated_gaussian", dim=dim)
    init = torch.randn((64, dim), generator=torch.Generator().manual_seed(5)) * 0.3
    factored = []
    real = ft.prepare_dense_metric
    monkeypatch.setattr(ft, "prepare_dense_metric",
                        lambda *a, **k: factored.append(1) or real(*a, **k))
    res = tg.grahmc_run(torch.Generator().manual_seed(6), t.log_prob_fn, init, 0.5, 8, 0.0,
                        1.0, num_samples=500, burn_in=100,
                        inv_mass_matrix=t.true_cov.to(torch.float32),
                        friction_schedule=tg.NO_FRICTION, track_proposals=track_proposals,
                        value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    assert len(factored) == 1
    assert float(res.accept_rate.mean()) > 0.8
    s = res.samples.reshape(-1, dim).double()
    np.testing.assert_allclose(torch.cov(s.T).numpy(), t.true_cov.numpy(), atol=0.15)
    assert ("proposal_positions" in res.info) == track_proposals


def test_dense_request_on_the_card_never_falls_back(monkeypatch, tmp_path):
    """A dense metric on tensors that are not on the CPU reaches the build
    (which raises here, with no nvcc) rather than any plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(ft, "_kernel_device", lambda q: None)
    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    t = t_get_target("correlated_gaussian", dim=3)
    invm, l_inv = (x.to("meta") for x in ft.prepare_dense_metric(t.true_cov))
    q = torch.zeros((4, 3), device="meta")
    args = (t.value_and_grad_fn.kernel_info, 4, 1, q, torch.zeros(4, device="meta"),
            torch.zeros_like(q), torch.ones(3, device="meta"))
    key = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        ft.grahmc_step_kernel(*args, invm, key=key, l_inv=l_inv)
    with pytest.raises(RuntimeError, match="nvcc"):
        ft.grahmc_multistep_kernel(*args[:3], 2, *args[3:], invm, key=key, l_inv=l_inv)
