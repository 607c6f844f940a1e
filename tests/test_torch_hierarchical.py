"""Port parity for BASELINE config 5, the hierarchical logistic posterior:
its data set and value-and-grad against the JAX target, the kernels' plain
device function (both layouts) against the JAX padded one, interop of the
tag with its arrays, the plain versions of kernels 1d, 1c's data form and
2b against the Pallas kernels in interpret mode on injected draws, the
config-5 pipeline (windowed warmup, gamma tune, GRAHMC) against the JAX XLA
path statistically, and persistent NUTS's shift of the posterior mean
against the JAX machine's. Kernels 3a and 4c are held against the Pallas kernels in
tests/test_torch_rwmh.py and tests/test_torch_nuts.py (their
hierarchical_logistic cases); the CUDA kernels in tests/test_torch_cuda.py
and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.ops.padded_targets import make_padded_vag  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.ops import padded_targets as pt  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402

HIER = "hierarchical_logistic"
DIM, N_DATA, C = 20, 64, 16       # the interpret-mode parity size


def _t(a):
    return torch.from_numpy(np.array(a))


def _targets(dim, n_data, data_seed=0):
    kw = dict(dim=dim, n_data=n_data, data_seed=data_seed)
    return j_get_target(HIER, **kw), t_get_target(HIER, **kw)


def _positions(dim, n, seed, scale=2.0):
    """Draws around the prior's scale (tau wider), float64."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)) * 0.3 * scale
    x[:, 0] = rng.standard_normal(n) * 0.5 * scale
    return x


@pytest.mark.parametrize("dim,n_data,data_seed", [(9, 64, 0), (20, 64, 3), (100, 256, 0)])
def test_data_set_is_the_jax_one(dim, n_data, data_seed):
    """X and y of the tag are bit-identical to the JAX tag's; the kernel
    layout (device_data) pads column 0 with zeros and keeps X^T beside X."""
    jt, tt = _targets(dim, n_data, data_seed)
    ours, theirs = tt.value_and_grad_fn.kernel_info, jt.value_and_grad_fn.pallas_info
    assert ours["family"] == theirs["family"] == HIER and ours["dim"] == theirs["dim"] == dim
    for key in ("X", "y"):
        assert ours["params"][key].dtype == np.float32
        assert np.array_equal(ours["params"][key], theirs["params"][key])
    assert ours["params"]["n_data"] == n_data and ours["params"]["data_seed"] == data_seed
    X, xt, y = pt.device_data(ours, "cpu")
    assert X.shape == (n_data, dim) and bool((X[:, 0] == 0).all())
    assert np.array_equal(X[:, 1:].numpy(), theirs["params"]["X"])
    assert torch.equal(xt, X.T) and xt.is_contiguous()
    assert np.array_equal(y.numpy(), theirs["params"]["y"])
    assert pt.device_data(ours, "cpu")[0] is X


@pytest.mark.parametrize("dim", [9, 20, 100])
def test_value_and_grad_matches_jax_f64(dim):
    """The target's value-and-grad in float64 against the JAX target, to
    1e-12 (the JAX one casts X to the positions' dtype, as the port's)."""
    jt, tt = _targets(dim, 256)
    x = _positions(dim, 32, dim)
    lp_j, g_j = jt.value_and_grad_fn(jnp.asarray(x))
    lp_t, g_t = tt.value_and_grad_fn(_t(x))
    assert lp_t.dtype == torch.float64 and g_t.shape == (32, dim)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tt.log_prob_fn(_t(x)).numpy(), np.asarray(lp_j), rtol=1e-12)
    lp32, g32 = tt.value_and_grad_fn(_t(x.astype(np.float32)))
    assert lp32.dtype == torch.float32 and g32.dtype == torch.float32


@pytest.mark.parametrize("dim,n_data", [(9, 20), (20, 64), (100, 256)])
def test_device_function_matches_jax_padded_vag(dim, n_data):
    """The kernels' plain device function (warp-per-chain layout, lp and
    gradient) and kernel 3's log-density form (lane groups) against the JAX
    package's padded device function in the lane layout, float32: the JAX
    test's tolerances (tests/test_pallas_ops.py:392-397)."""
    jt, tt = _targets(dim, n_data)
    x32 = _positions(dim, 32, 1).astype(np.float32)
    d_pad = 128
    vag = make_padded_vag(jt.value_and_grad_fn, d_pad, 1)
    block = jnp.pad(jnp.asarray(x32), ((0, 0), (0, d_pad - dim)))
    lp_j, g_j = vag(block, *[jnp.asarray(a) for a in vag.data_arrays])
    lp_j, g_j = np.asarray(lp_j)[:, 0], np.asarray(g_j)[:, :dim]
    info = tt.value_and_grad_fn.kernel_info
    lp_t, g_t = pt.device_vag(info)(_t(x32))
    assert lp_t.dtype == torch.float32 and g_t.shape == (32, dim)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=3e-4, atol=3e-4)
    lp_r = pt.device_lp(info)(_t(x32))
    np.testing.assert_allclose(lp_r.numpy(), lp_j, rtol=3e-5, atol=3e-5)


def test_order_sums_follow_the_lanes():
    """warp_order_sum's strided and blocked lane orders: each equals the row
    sum in float64, and the blocked order of kernel 3 groups lane j's
    entries 4j..4j+3."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 37)))
    for lanes, blocked in ((32, 0), (8, 0), (16, 4), (32, 4)):
        torch.testing.assert_close(pt.warp_order_sum(x, lanes, blocked), x.sum(1))
    assert [pt.rwmh_lanes(d) for d in (1, 4, 5, 9, 20, 100, 128)] == [1, 1, 2, 4, 8, 32, 32]


def test_tag_registry_and_init_sampler():
    """Family id 4, dispatched by all three kernel keys, a data family;
    init_sampler draws tau at scale 0.5 and beta at 0.3; no exact sampler."""
    from mcmc_tpu_torch.targets import get_reference_sampler, has_reference_sampler
    _, tt = _targets(12, 32)
    info = pt.kernel_info(tt.value_and_grad_fn)
    assert pt.FAMILY_IDS[HIER] == 4 and HIER in pt.DATA_FAMILIES
    for kernel in ("grahmc", "rwmh", "nuts"):
        assert pt.kernel_info(tt.value_and_grad_fn, kernel) is info
    assert pt.device_params(info) == (0.0, 0.0, 0.0, 0.0)
    assert tt.true_mean is None and tt.true_cov is None
    x = tt.init_sampler(torch.Generator().manual_seed(0), 20000)
    assert x.shape == (20000, 12) and x.dtype == torch.float32
    np.testing.assert_allclose(x.std(0).numpy(), [0.5] + [0.3] * 11, rtol=0.05)
    assert get_reference_sampler(HIER, 12) is None and not has_reference_sampler(HIER)


def test_target_from_tag_carries_the_data_set():
    """interop.target_from_tag rebuilds the port's target from the JAX tag
    (arrays compared exactly) and raises on a tampered X, y or seed."""
    jt, _ = _targets(DIM, N_DATA, 2)
    tag = jt.value_and_grad_fn.pallas_info
    t = interop.target_from_tag(tag)
    assert t.value_and_grad_fn.kernel_info["params"]["data_seed"] == 2
    x = _positions(DIM, 8, 5)
    np.testing.assert_allclose(t.value_and_grad_fn(_t(x))[0].numpy(),
                               np.asarray(jt.value_and_grad_fn(jnp.asarray(x))[0]), rtol=1e-12)
    for name, change in (("X", lambda a: a + np.float32(1e-6) * (a == a.flat[7])),
                         ("y", lambda a: 1.0 - a), ("X", lambda a: a[:-1])):
        params = dict(tag["params"], **{name: change(tag["params"][name])})
        with pytest.raises(ValueError, match=name):
            interop.target_from_tag(dict(tag, params=params))
    with pytest.raises(ValueError):
        interop.target_from_tag(dict(tag, params=dict(tag["params"], data_seed=1)))


def _jax_state(jt, x32):
    s = jbase.init_chain_state(jnp.asarray(x32), jt.log_prob_fn, jt.value_and_grad_fn)
    return s._replace(position=s.position.astype(jnp.float32),
                      log_prob=s.log_prob.astype(jnp.float32),
                      grad_log_prob=s.grad_log_prob.astype(jnp.float32))


@pytest.mark.parametrize("bridged", [False, True])
@pytest.mark.parametrize("schedule", ["tanh", "constant"])
def test_step_plain_matches_pallas_debug_kernel(schedule, bridged):
    """Kernel 1d's plain version (and 1c's on the data target) against the
    JAX fused kernel in interpret mode (make_debug_trajectory) on injected
    draws, D = 20, n_data = 64, 16 chains: accepts equal, states within
    2e-4, delta H within 2e-3 (tests/test_torch_fused.py's tolerances)."""
    jt, tt = _targets(DIM, N_DATA)
    rng = np.random.default_rng(4)
    x32 = (_positions(DIM, C, 6)).astype(np.float32)
    p0 = (rng.standard_normal((C, DIM)) * 3.0).astype(np.float32)
    u = rng.uniform(size=C).astype(np.float32)
    inv_mass = (rng.uniform(size=DIM) * 0.05 + 0.02).astype(np.float32)
    eps = {("tanh", True): 1.0, ("constant", True): 0.7}.get((schedule, bridged), 0.6)
    gamma, steep, L = 0.5, 0.5, 8
    js = _jax_state(jt, x32)
    run_j = jft.make_debug_trajectory(jt.value_and_grad_fn, L, jg.get_friction_schedule(schedule),
                                      C, DIM)
    bridge = (0.3, 0.1, 1.5) if bridged else None
    lp, grad = np.asarray(js.log_prob), np.asarray(js.grad_log_prob)
    if bridged:        # the bridge's lp and grad at q, as a move's state carries them
        base_lp = -0.5 * np.sum(((x32 - 0.1) / 1.5) ** 2, 1) - DIM * np.log(1.5) \
            - 0.5 * DIM * np.log(2 * np.pi)
        lp = (0.3 * lp + 0.7 * base_lp).astype(np.float32)
        grad = (0.3 * grad - 0.7 * (x32 - 0.1) / 1.5 ** 2).astype(np.float32)
    outs_j = run_j(jnp.asarray(x32), jnp.asarray(lp), jnp.asarray(grad), jnp.asarray(p0),
                   jnp.asarray(u), eps, gamma, steep, jnp.asarray(inv_mass), bridge=bridge)
    run_t = ft.make_debug_trajectory(tt.value_and_grad_fn, L, tg.get_friction_schedule(schedule),
                                     C, DIM)
    outs_t = run_t(_t(x32), _t(lp), _t(grad), _t(p0), _t(u), eps, gamma, steep, _t(inv_mass),
                   bridge=bridge)
    acc = outs_t[3].numpy()
    np.testing.assert_array_equal(acc, np.asarray(outs_j[3]))
    assert 0 < int(acc.sum()) < C
    for a, b in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs_t[4].numpy(), np.asarray(outs_j[4]), rtol=2e-3, atol=2e-3)


def test_multistep_plain_matches_pallas_multistep_kernel():
    """Kernel 2b's plain version against make_fused_grahmc_multistep
    (interpret mode) on its own draws, reproduced from the key split
    (tests/test_torch_fused.py's recipe), T = 4: accepts equal, histories
    and final state within 2e-4."""
    T, L = 4, 6
    eps, gamma, steep = 0.5, 1.0, 0.5
    jt, tt = _targets(DIM, N_DATA)
    ms0 = _jax_state(jt, _positions(DIM, C, 8).astype(np.float32))
    inv_mass = np.full(DIM, 0.04, np.float32)
    key = random.PRNGKey(7)
    multi = jft.make_fused_grahmc_multistep(jt.log_prob_fn, jt.value_and_grad_fn, L,
                                            jg.tanh_schedule, T, interpret=True)
    _, ms, (acc_j, hist_q_j, hist_lp_j, _dh_j) = multi(key, ms0, eps, gamma, steep,
                                                       jnp.asarray(inv_mass))
    d_pad = jft._round_up(DIM, jft.SUBLANE)
    _, seed_key = random.split(key)
    k_mom, k_u = random.split(seed_key)
    invm_col = jnp.pad(jnp.asarray(inv_mass), (0, d_pad - DIM), constant_values=1.0)[:, None]
    p0 = random.normal(k_mom, (T, d_pad, C), jnp.float32) / jnp.sqrt(invm_col)
    u = random.uniform(k_u, (T, C), jnp.float32)
    p0 = np.ascontiguousarray(np.transpose(np.asarray(p0)[:, :DIM, :], (0, 2, 1)))
    out = ft.grahmc_multistep_kernel(
        tt.value_and_grad_fn.kernel_info, L, ft.SCHEDULE_IDS["tanh"], T, _t(ms0.position),
        _t(ms0.log_prob), _t(ms0.grad_log_prob), ft.kernel_scalars(eps, gamma, steep, "cpu"),
        _t(inv_mass), p0=_t(p0), u=_t(u))
    q1, lp1, g1, acc_t, _dh_t, hist_q_t, hist_lp_t = out
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert 0 < int(acc_t.sum()) < T * C
    for a, b in ((hist_q_t, hist_q_j), (hist_lp_t, hist_lp_j), (q1, ms.position),
                 (lp1, ms.log_prob), (g1, ms.grad_log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def test_config5_pipeline_matches_jax_statistically():
    """The config-5 pipeline at a small size, D = 12, n_data = 32, 64
    chains: run_adaptive_warmup("grahmc", diagonal metric, tanh, L = 8) with
    the gamma tune, then grahmc_run, on the port (eager) and on the JAX XLA
    path from the same starts; then the port's fused backend (the plain
    versions of kernels 1d and 2b here) from the port's warmed state. The
    posterior means agree within 0.35 posterior sd per coordinate (2,400
    correlated draws a run; test_grahmc_pallas_backend_hierarchical's
    statistical comparison), accepts within 0.15 of each other."""
    from mcmc_tpu.samplers import grahmc_run as j_grahmc_run
    from mcmc_tpu.tuning import run_adaptive_warmup as j_warmup
    from mcmc_tpu_torch.tuning import run_adaptive_warmup as t_warmup
    dim, n_data, chains = 12, 32, 64
    jt, tt = _targets(dim, n_data)
    init = (_positions(dim, chains, 9, scale=1.0)).astype(np.float32)
    kw = dict(num_warmup=300, schedule_type="tanh", num_steps=8, exploration_steps=100,
              adaptation_windows=[50, 100], cooldown_steps=50, max_iter_step=60,
              gamma_samples_per_eval=20)
    js, jm, jpos, jinfo = j_warmup("grahmc", jt.log_prob_fn, None, jnp.asarray(init),
                                   random.PRNGKey(1), value_and_grad_fn=jt.value_and_grad_fn,
                                   backend="xla", **kw)
    jres = j_grahmc_run(random.PRNGKey(2), jt.log_prob_fn, jpos, step_size=js, num_steps=8,
                        gamma=jinfo["gamma"], steepness=jinfo["steepness"], num_samples=40,
                        burn_in=0, inv_mass_matrix=jm,
                        friction_schedule=jg.get_friction_schedule("tanh"),
                        value_and_grad_fn=jt.value_and_grad_fn, backend="xla")
    ts, tm, tpos, tinfo = t_warmup("grahmc", tt.log_prob_fn, None, _t(init),
                                   torch.Generator().manual_seed(1),
                                   value_and_grad_fn=tt.value_and_grad_fn, backend="eager", **kw)
    runs = {"jax": (np.asarray(jres.samples).reshape(-1, dim), float(jres.accept_rate.mean()))}
    for backend in ("eager", "fused"):
        res = tg.grahmc_run(torch.Generator().manual_seed(2), tt.log_prob_fn, tpos, ts, 8,
                            tinfo["gamma"], tinfo["steepness"], 40, inv_mass_matrix=tm,
                            friction_schedule=tg.tanh_schedule,
                            value_and_grad_fn=tt.value_and_grad_fn, backend=backend)
        assert bool(torch.isfinite(res.samples).all())
        runs[backend] = (res.samples.reshape(-1, dim).double().numpy(),
                         float(res.accept_rate.mean()))
    sd = runs["jax"][0].std(0)
    np.testing.assert_allclose(tm.double().numpy(), np.asarray(jm), rtol=0.6)
    for backend in ("eager", "fused"):
        flat, acc = runs[backend]
        assert np.all(np.abs(flat.mean(0) - runs["jax"][0].mean(0)) < 0.35 * sd), backend
        assert abs(acc - runs["jax"][1]) < 0.15, (backend, acc, runs["jax"][1])
    assert 0.45 < runs["eager"][1] < 0.85


@pytest.fixture(scope="module")
def nuts_reference():
    """D = 12, n_data = 32, 128 chains: the JAX package's windowed GRAHMC
    warmup (step, metric, warmed states), then a long XLA HMC run at its
    step as the posterior's reference: (step, metric, states, (mean, MCSE))
    per coordinate, MCSE = sd / sqrt(bulk ESS)."""
    from mcmc_tpu.samplers import hmc_run as j_hmc_run
    from mcmc_tpu.tuning import run_adaptive_warmup as j_warmup
    jt, _ = _targets(12, 32)
    init = _positions(12, 128, 9, scale=1.0).astype(np.float32)
    step, m, pos, _ = j_warmup(
        "grahmc", jt.log_prob_fn, None, jnp.asarray(init), random.PRNGKey(1),
        value_and_grad_fn=jt.value_and_grad_fn, backend="xla", num_warmup=300,
        schedule_type="tanh", num_steps=8, exploration_steps=100, adaptation_windows=[50, 100],
        cooldown_steps=50, max_iter_step=60, gamma_samples_per_eval=20)
    ref = j_hmc_run(random.PRNGKey(2), jt.log_prob_fn, pos, step, 8, 1500, inv_mass_matrix=m,
                    value_and_grad_fn=jt.value_and_grad_fn)
    return float(step), np.asarray(m), np.asarray(pos), _mean_mcse(ref.samples)


def _mean_mcse(samples):
    from mcmc_tpu_torch.diagnostics import ess_bulk
    s = torch.from_numpy(np.array(samples, np.float64))
    return s.mean((0, 1)), s.std(dim=(0, 1)) / ess_bulk(s).sqrt()


@pytest.mark.parametrize("scheme,sign", [("endpoint", -1.0), ("multinomial", 1.0)])
def test_persistent_nuts_shift_is_the_jax_packages(nuts_reference, scheme, sign):
    """Persistent NUTS (64 slots a draw, one emitted draw per window) misses
    this posterior's mean of tau: the endpoint scheme low, the multinomial
    scheme high (BASELINE.md's endpoint and window-emission biases, on a
    posterior whose trajectory length varies with tau). The JAX XLA machine
    and the port's eager one, from the same warmed states at the same step
    and metric, against one long HMC run: each shifts tau the same way by
    more than 5 combined MCSE, and the two agree with each other within 4
    combined MCSE on every coordinate."""
    from mcmc_tpu.samplers.nuts_persistent import nuts_run_persistent as j_nuts
    from mcmc_tpu_torch.samplers import nuts_run_persistent as t_nuts
    jt, tt = _targets(12, 32)
    step, m, pos, ref = nuts_reference
    kw = dict(num_samples=100, steps_per_sample=64, proposal_scheme=scheme)
    jres = j_nuts(random.PRNGKey(4), jt.log_prob_fn, jnp.asarray(pos), step,
                  inv_mass_matrix=jnp.asarray(m), value_and_grad_fn=jt.value_and_grad_fn,
                  backend="xla", **kw)
    tres = t_nuts(torch.Generator().manual_seed(4), tt.log_prob_fn, _t(pos), step,
                  inv_mass_matrix=_t(m), value_and_grad_fn=tt.value_and_grad_fn,
                  backend="eager", **kw)
    runs = [_mean_mcse(jres.samples), _mean_mcse(tres.samples)]
    for mean, mcse in runs:
        z_tau = (mean[0] - ref[0][0]) / (mcse[0] ** 2 + ref[1][0] ** 2).sqrt()
        assert float(sign * z_tau) > 5.0, (scheme, float(z_tau))
    z = (runs[0][0] - runs[1][0]).abs() / (runs[0][1] ** 2 + runs[1][1] ** 2).sqrt()
    assert float(z.max()) < 4.0, (scheme, z)
