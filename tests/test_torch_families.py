"""Port parity for the target families ported with the ChEES slice
(`neals_funnel_noncentered`, `ill_conditioned_gaussian`, `student_t`,
`log_gamma`, `log_gamma_unconstrained`) and the two gap pairs it closes
(`correlated_gaussian` in kernel 3, `gaussian_mixture` in kernels 3 and 4):
the targets' value-and-grad against the JAX package in float64, the
kernels' plain device functions against the JAX padded ones, the plain
versions of kernels 1, 2, 3 and 4 against the Pallas kernels in interpret
mode on injected draws, the exact samplers' moments, `unconstrain_target`,
and the reference sampler's `finfo.tiny` clamp (an expected difference from
the JAX package). The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu import targets as jt  # noqa: E402
from mcmc_tpu.ops import fused_nuts as jfn  # noqa: E402
from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.ops.fused_rwmh import make_fused_rwmh_multistep as j_rwmh  # noqa: E402
from mcmc_tpu.ops.padded_targets import make_padded_vag  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.samplers.nuts_persistent import _init_pstate as j_init_pstate  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch import targets as tt  # noqa: E402
from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.ops import padded_targets as pt  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402

NEW = ["neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t", "log_gamma",
       "log_gamma_unconstrained"]
# (family, kernel): the five families in every kernel, and the gap pairs
GAPS = [("correlated_gaussian", "rwmh"), ("gaussian_mixture", "rwmh"),
        ("gaussian_mixture", "nuts")]
F32 = jnp.float32
C = 16                    # the interpret-mode parity size
DIM = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _positions(family, dim, n, seed):
    """Float64 draws in each family's bulk: positive for log_gamma (and
    one chain with a non-positive coordinate when `bad`), the
    ill-conditioned Gaussian at its scales."""
    rng = np.random.default_rng(seed)
    if family == "log_gamma":
        return rng.gamma(2.0, size=(n, dim))
    if family == "log_gamma_unconstrained":
        return np.log(rng.gamma(2.0, size=(n, dim)))
    x = rng.standard_normal((n, dim))
    if family == "neals_funnel_noncentered":
        x[:, 0] *= 3.0
    elif family == "ill_conditioned_gaussian":
        x *= np.sqrt(np.linspace(1.0, 100.0, dim))
    elif family == "student_t":
        x *= 1.5
    elif family == "gaussian_mixture":
        x[:, 0] += np.where(np.arange(n) % 2 == 0, -2.5, 2.5)
    return x


@pytest.mark.parametrize("dim", [1, 10, 50])
@pytest.mark.parametrize("family", NEW)
def test_value_and_grad_matches_jax_f64(family, dim):
    x = _positions(family, dim, 32, dim)
    if family == "log_gamma":
        x[3, dim - 1] = -0.5           # outside the support: -inf, zero gradient
        x[5, 0] = 0.0
    lp_j, g_j = jt.get_target(family, dim=dim).value_and_grad_fn(jnp.asarray(x))
    t = tt.get_target(family, dim=dim)
    lp_t, g_t = t.value_and_grad_fn(_t(x))
    assert lp_t.dtype == torch.float64 and g_t.shape == (32, dim)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t.log_prob_fn(_t(x)).numpy(), np.asarray(lp_j), rtol=1e-12)
    if family == "log_gamma":
        assert np.isneginf(lp_t.numpy()[[3, 5]]).all() and not g_t[[3, 5]].any()


@pytest.mark.parametrize("dim", [1, 10, 50])
@pytest.mark.parametrize("family", NEW)
def test_device_function_matches_jax_padded_vag(family, dim):
    """The kernels' plain device function (warp-per-chain order) and kernel
    3's log-density (lane-group order) against the JAX package's padded
    device function in the lane layout, float32: lp to 2e-5, gradients to
    2e-6 (the same formulas, elementwise)."""
    x32 = _positions(family, dim, 32, dim + 1).astype(np.float32)
    if family == "log_gamma":
        x32[7, 0] = -1.0
    d_pad = 128
    vag = make_padded_vag(jt.get_target(family, dim=dim).value_and_grad_fn, d_pad, 1)
    lp_j, g_j = vag(jnp.pad(jnp.asarray(x32), ((0, 0), (0, d_pad - dim))))
    lp_j, g_j = np.asarray(lp_j)[:, 0], np.asarray(g_j)
    assert not g_j[:, dim:].any()       # the padding's gradient is masked
    info = tt.get_target(family, dim=dim).value_and_grad_fn.kernel_info
    lp_t, g_t = pt.device_vag(info)(_t(x32))
    assert lp_t.dtype == torch.float32
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j[:, :dim], rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(pt.device_lp(info)(_t(x32)).numpy(), lp_j, rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("family", NEW)
def test_tags_params_and_registry(family):
    """The tag is the JAX package's (interop.target_from_tag carries it
    across), every kernel dispatches on it, its device parameters are the
    constants of the JAX padded device function, computed in double and
    rounded once, and the family ids match `enum Family` of
    csrc/targets.cuh."""
    dim = 7
    t = tt.get_target(family, dim=dim)
    theirs = jt.get_target(family, dim=dim)
    info = pt.kernel_info(t.value_and_grad_fn)
    assert info["family"] == theirs.value_and_grad_fn.pallas_info["family"] == family
    assert info["params"] == pytest.approx(theirs.value_and_grad_fn.pallas_info["params"])
    for kernel in ("grahmc", "rwmh", "nuts"):
        assert pt.kernel_info(t.value_and_grad_fn, kernel) is info
    back = interop.target_from_tag(theirs.value_and_grad_fn.pallas_info)
    assert back.value_and_grad_fn.kernel_info == info
    assert t.support == theirs.support and t.transform_target == theirs.transform_target
    assert t.name == theirs.name and t.family == theirs.family
    params = pt.device_params(info)
    if family == "ill_conditioned_gaussian":
        const = float(np.sum(np.log(np.linspace(1.0, 100.0, dim)))) + dim * pt.LOG_2PI
        assert params[:2] == pytest.approx((99.0 / (dim - 1), const), rel=1e-14)
    elif family == "student_t":
        assert params[0] == 3.0 and params[1] == 2.0 and params[3] == -4.0
    elif family in ("log_gamma", "log_gamma_unconstrained"):
        assert params[2] == pytest.approx(
            (1 if family == "log_gamma" else dim) * math.lgamma(2.0), rel=1e-14)
    enum = dict(re.findall(r"\n\s+([A-Z_]+) = (\d+)",
                           (Path(ft.__file__).parents[1] / "csrc" / "targets.cuh").read_text()))
    assert int(enum[family.upper()]) == pt.FAMILY_IDS[family]


@pytest.mark.parametrize("family", NEW)
def test_exact_sampler_and_init_moments(family):
    """The exact sampler (generator-driven, float64) has the target's
    moments: means within 5 standard errors, variances within 3%; the JAX
    package has an exact sampler for the same names; the init sampler
    draws float32 where the JAX target has one."""
    dim, n = 6, 400_000
    draws = tt.get_reference_sampler(family, dim)(torch.Generator().manual_seed(1), n)
    assert draws.shape == (n, dim) and draws.dtype == torch.float64
    assert tt.has_reference_sampler(family) and jt.has_reference_sampler(family)
    t = tt.get_target(family, dim=dim)
    mean, var = draws.mean(0), draws.var(0)
    true_var = torch.diagonal(t.true_cov)
    se = torch.sqrt(true_var / n)
    assert bool(((mean - t.true_mean).abs() < 5 * se).all()), (mean, t.true_mean)
    tol = 0.1 if family == "student_t" else 0.03       # df = 3: heavy-tailed variance
    np.testing.assert_allclose(var.numpy(), true_var.numpy(), rtol=tol)
    has_init = jt.get_target(family, dim=dim).init_sampler is not None
    assert (t.init_sampler is not None) == has_init
    if has_init:
        x = t.init_sampler(torch.Generator().manual_seed(2), 1000)
        assert x.shape == (1000, dim) and x.dtype == torch.float32
        assert bool(torch.isfinite(t.value_and_grad_fn(x)[0]).all())


def test_unconstrain_target_matches_jax():
    """unconstrain_target(log_gamma) is the JAX package's expGamma (value
    and grad to 1e-12, digamma / trigamma moments, the original target's
    moments as transform_true_*); the generic chain-rule wrapper (any other
    positive-support family) carries no kernel tag and equals the analytic
    form on log-gamma; a real-support target comes back unchanged; the
    '<name>_unconstrained' names route through it."""
    dim = 5
    y = _positions("log_gamma_unconstrained", dim, 16, 3)
    ours = tt.unconstrain_target(tt.log_gamma(dim), registry_name="log_gamma")
    theirs = jt.unconstrain_target(jt.log_gamma(dim), registry_name="log_gamma")
    for a, b in zip(ours.value_and_grad_fn(_t(y)), theirs.value_and_grad_fn(jnp.asarray(y))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    for name in ("true_mean", "true_cov", "transform_true_mean", "transform_true_cov"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)), rtol=1e-12)
    assert ours.transform_target == "log_gamma" and ours.support == "real"
    torch.testing.assert_close(ours.transform(_t(y)), torch.exp(_t(y)))
    generic = tt.unconstrain_target(tt.log_gamma(dim)._replace(family="gamma_generic"))
    assert not hasattr(generic.value_and_grad_fn, "kernel_info")
    assert generic.family == "gamma_generic_unconstrained" and generic.true_mean is None
    for a, b in zip(generic.value_and_grad_fn(_t(y)), ours.value_and_grad_fn(_t(y))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    normal = tt.standard_normal(dim)
    assert tt.unconstrain_target(normal) is normal
    routed = tt.get_target("log_gamma_unconstrained", dim=dim, shape=3.0)
    assert routed.params == {"shape": 3.0, "rate": 1.0}
    assert tt.get_target("standard_normal_unconstrained", dim=dim).family == "standard_normal"
    x = routed.init_sampler(torch.Generator().manual_seed(0), 500)
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())


def test_reference_sampler_tiny_clamp_is_an_expected_difference(monkeypatch):
    """A gamma draw that underflows to 0: the JAX package's log(max(x,
    1e-300)) gives -inf in float32 (1e-300 rounds to 0 there), the port
    clamps at finfo(dtype).tiny and stays finite. Recorded, not copied
    (ROADMAP Queue 3, part 2)."""
    zeros32 = np.zeros((4, 3), np.float32)
    assert np.isneginf(np.asarray(jnp.log(jnp.maximum(jnp.asarray(zeros32), 1e-300)))).all()
    monkeypatch.setattr(tt, "standard_gamma",
                        lambda g, shape, size, dtype=torch.float64: torch.zeros(
                            size, dtype=torch.float32))
    y = tt.get_reference_sampler("log_gamma_unconstrained", 3)(torch.Generator(), 4)
    assert bool(torch.isfinite(y).all())
    assert float(y.max()) == pytest.approx(math.log(torch.finfo(torch.float32).tiny))


# ---------------------------------------------------------------------------
# Plain kernels against the Pallas kernels (interpret mode, injected draws)
# ---------------------------------------------------------------------------

KERNEL_CASES = [(f, k) for f in NEW for k in ("grahmc", "rwmh", "nuts")] + GAPS
STEP = {"neals_funnel_noncentered": 0.5, "ill_conditioned_gaussian": 0.35, "student_t": 0.5,
        "log_gamma": 0.3, "log_gamma_unconstrained": 0.35, "correlated_gaussian": 0.1,
        "gaussian_mixture": 0.4}


def _jax_state(family, x32):
    t = jt.get_target(family, dim=DIM)
    s = jbase.init_chain_state(jnp.asarray(x32), t.log_prob_fn, t.value_and_grad_fn)
    return t, s._replace(position=s.position.astype(F32), log_prob=s.log_prob.astype(F32),
                         grad_log_prob=s.grad_log_prob.astype(F32))


def _grahmc_cases(family, js, jtarget, info):
    """Kernel 1 (make_debug_trajectory, tanh friction, L = 8) and kernel 2
    (make_fused_grahmc_multistep, T = 4, its draws rebuilt from the key
    split) on the JAX package's draws: accepts equal, states within 2e-4."""
    rng = np.random.default_rng(11)
    eps, gamma, steep, L = STEP[family], 0.5, 0.5, 8
    x32 = np.asarray(js.position)
    p0 = rng.standard_normal((C, DIM)).astype(np.float32)
    u = rng.uniform(size=C).astype(np.float32)
    inv_mass = np.ones(DIM, np.float32)
    run_j = jft.make_debug_trajectory(jtarget.value_and_grad_fn, L, jg.tanh_schedule, C, DIM)
    outs_j = run_j(js.position, js.log_prob, js.grad_log_prob, jnp.asarray(p0), jnp.asarray(u),
                   eps, gamma, steep, jnp.asarray(inv_mass))
    run_t = ft.make_debug_trajectory(tt.get_target(family, dim=DIM).value_and_grad_fn, L,
                                     tg.tanh_schedule, C, DIM)
    outs_t = run_t(_t(x32), _t(js.log_prob), _t(js.grad_log_prob), _t(p0), _t(u), eps, gamma,
                   steep, _t(inv_mass))
    np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3]))
    assert 0 < int(outs_t[3].sum()) < C
    for a, b in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs_t[4].numpy(), np.asarray(outs_j[4]), rtol=2e-3, atol=2e-3)

    T = 4
    key = random.PRNGKey(7)
    multi = jft.make_fused_grahmc_multistep(jtarget.log_prob_fn, jtarget.value_and_grad_fn, L,
                                            jg.tanh_schedule, T, interpret=True)
    _, ms, (acc_j, hist_q_j, hist_lp_j, _dh) = multi(key, js, eps, gamma, steep,
                                                     jnp.asarray(inv_mass))
    d_pad = jft._round_up(DIM, jft.SUBLANE)
    _, seed_key = random.split(key)
    k_mom, k_u = random.split(seed_key)
    p0 = random.normal(k_mom, (T, d_pad, C), F32)
    u = random.uniform(k_u, (T, C), F32)
    p0 = np.ascontiguousarray(np.transpose(np.asarray(p0)[:, :DIM, :], (0, 2, 1)))
    out = ft.grahmc_multistep_kernel(info, L, ft.SCHEDULE_IDS["tanh"], T, _t(x32),
                                     _t(js.log_prob), _t(js.grad_log_prob),
                                     ft.kernel_scalars(eps, gamma, steep, "cpu"),
                                     _t(inv_mass), p0=_t(p0), u=_t(u))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(acc_j))
    for a, b in ((out[5], hist_q_j), (out[6], hist_lp_j), (out[0], ms.position),
                 (out[1], ms.log_prob), (out[2], ms.grad_log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def _rwmh_case(family, js, jtarget, info):
    """Kernel 3 (T = 8) on the JAX kernel's own draws: accepts equal, q and
    lp within 1e-5 (kernel 3 sums in its lane groups, the JAX kernel over
    the padded block)."""
    T, scale = 8, 0.5 * STEP[family]
    key = random.PRNGKey(DIM)
    multi = j_rwmh(jtarget.log_prob_fn, jtarget.value_and_grad_fn, T, interpret=True)
    state = js._replace(grad_log_prob=jnp.zeros_like(js.position))
    _, ms, (acc_j, hist_q_j, hist_lp_j) = multi(key, state, scale)
    d_pad = jft._round_up(DIM, jft.SUBLANE)
    _, seed_key = random.split(key)
    k_noise, k_u = random.split(seed_key)
    noise = random.normal(k_noise, (T, d_pad, C), F32)
    u = random.uniform(k_u, (T, C), F32)
    noise = np.ascontiguousarray(np.transpose(np.asarray(noise), (0, 2, 1))[:, :, :DIM])
    q1, lp1, acc_t, hist_q_t, hist_lp_t = fr.rwmh_multistep_kernel(
        info, T, _t(js.position), _t(js.log_prob), fr.rwmh_scale(scale, "cpu"), C,
        noise=_t(noise), u=_t(u))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert 0 < int(acc_t.sum()) < T * C
    for a, b in ((hist_q_t, hist_q_j), (hist_lp_t, hist_lp_j), (q1, ms.position),
                 (lp1, ms.log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _nuts_case(family, js, jtarget, info):
    """Kernel 4 (W = 4, 12 iterations, depth 6) on the JAX window's injected
    draws from one carried state: discrete state equal and the emitted
    state within 2e-4 on every chain (tests/test_torch_nuts.py's rule); the
    trajectory in flight within 2e-4 on every chain but, on log_gamma, one:
    near the support boundary the gradient (shape - 1) / x kicks the
    momentum by thousands, so a rounding difference in x grows there (as
    on the funnel's neck, ops/fused_nuts.window_agreement)."""
    from test_torch_nuts import _DISCRETE, _jax_draws, _port_draws, _unpack
    n_iters, depth, w = 12, 6, 4
    step = 1.2 if family == "ill_conditioned_gaussian" else 0.5 * STEP[family]
    d_pad = jfn._round_up(DIM, jfn.SUBLANE)
    key = random.PRNGKey(3)
    window = jfn.make_fused_nuts_window(jtarget.value_and_grad_fn, n_iters, depth, C, DIM,
                                        interpret=True, steps_per_iter=w)
    q0, lp0, g0 = js.position, js.log_prob, js.grad_log_prob
    ts = window(key, jfn.pack_state(q0, lp0, g0, d_pad), step, jnp.ones(DIM, F32))
    ps0 = j_init_pstate(q0, lp0, g0, F32)
    s = interop.nuts_state_from_numpy(device="cpu", **{
        k: np.asarray(v) for k, v in ps0._asdict().items() if v is not None})
    out = fn.nuts_window_kernel(info, n_iters, w, depth, s, fn.nuts_scalars(step, 1000.0, "cpu"),
                                torch.ones(DIM), draws=_port_draws(_jax_draws(key, DIM, n_iters)))
    jax_fields = _unpack(ts, DIM)
    for name in _DISCRETE + ("n_exec",):
        np.testing.assert_array_equal(getattr(out, name).numpy().astype(np.float64),
                                      np.asarray(jax_fields[name]).astype(np.float64),
                                      err_msg=name)
    drifted = np.zeros(C, bool)
    for name in ("q", "q_res", "lp", "lp_res", "alpha_acc", "q_c", "q_l", "q_r"):
        close = np.isclose(getattr(out, name).numpy(), np.asarray(jax_fields[name]),
                           rtol=2e-4, atol=2e-4)
        close = close.reshape(C, -1).all(axis=1)
        if name in ("q_c", "q_l", "q_r"):
            drifted |= ~close
        else:
            assert close.all(), name
    assert int(drifted.sum()) <= (1 if family == "log_gamma" else 0), drifted
    assert int(out.transitions.sum()) > 0


@pytest.mark.parametrize("family,kernel", KERNEL_CASES)
def test_plain_kernels_match_pallas_kernels(family, kernel):
    x32 = _positions(family, DIM, C, 5).astype(np.float32)
    jtarget, js = _jax_state(family, x32)
    info = tt.get_target(family, dim=DIM).value_and_grad_fn.kernel_info
    {"grahmc": _grahmc_cases, "rwmh": _rwmh_case, "nuts": _nuts_case}[kernel](
        family, js, jtarget, info)
