"""Port parity for Rosenbrock and the RAHMC paper's three families
(`multimodal_funnel_2d`, `concentric_l1_balls`, `nested_l1_balls`): the
targets' value-and-grad against the JAX package in float64, the kernels'
plain device functions in both layouts (the warp-per-chain one of kernels
1, 2 and 4, kernel 3's lane groups) against the JAX padded device functions
and targets in float64 and float32, q exactly 0 on an L1 coordinate, the
shell cap, the tags and registry, the exact sampler, and the plain
versions of kernels 1, 3 and 4 against the Pallas kernels in interpret
mode on injected draws. The CUDA kernels are held against these plain
versions in tests/test_torch_cuda.py and chip_smoke.py."""

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
from mcmc_tpu.ops.padded_targets import _BUILDERS as J_BUILDERS  # noqa: E402
from mcmc_tpu.ops.padded_targets import make_padded_vag  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.samplers.nuts_persistent import _init_pstate as j_init_pstate  # noqa: E402
from mcmc_tpu.targets import rahmc_paper as jr  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch import targets as tt  # noqa: E402
from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.ops import padded_targets as pt  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.targets import rahmc_paper as tr  # noqa: E402

F32 = jnp.float32
FAMILIES = ("rosenbrock", "multimodal_funnel_2d", "concentric_l1_balls", "nested_l1_balls")
# Rosenbrock's neighbour exchange within one lane, across lanes and across
# registers (D 33, 65: lane 31's neighbour is lane 0's next register)
CASES = ([("rosenbrock", d) for d in (1, 2, 5, 33, 65)] + [("multimodal_funnel_2d", 2)]
         + [(f, d) for f in ("concentric_l1_balls", "nested_l1_balls") for d in (2, 3, 10)])


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(family, dim):
    """(JAX target, port target) of `family` at `dim`."""
    if family == "rosenbrock":
        return jt.rosenbrock(dim), tt.rosenbrock(dim)
    if family == "multimodal_funnel_2d":
        return jr.multimodal_funnel_2d(), tr.multimodal_funnel_2d()
    if family == "concentric_l1_balls":
        return jr.concentric_l1_balls(dim), tr.concentric_l1_balls(dim)
    return jr.nested_l1_balls(dim), tr.nested_l1_balls(dim)


def _positions(family, dim, n, seed):
    """Float64 points in each family's bulk: Rosenbrock about its mode, the
    funnel's two modes, the L1 shells at their radii (and their centres)."""
    rng = np.random.default_rng(seed)
    if family == "rosenbrock":
        return 1.0 + 0.3 * rng.standard_normal((n, dim))
    if family == "multimodal_funnel_2d":
        v = rng.standard_normal(n) + np.where(np.arange(n) % 2 == 0, -3.0, 3.0)
        return np.stack([v, rng.standard_normal(n) * np.exp(v / 2)], axis=1)
    d = rng.standard_normal((n, dim))
    d /= np.abs(d).sum(axis=1, keepdims=True)
    r = rng.choice([2.0, 4.0, 8.0, 16.0, 20.0], size=n)
    return d * r[:, None] + 0.5 * rng.standard_normal((n, dim))


def _jax_padded(jtarget, x, d_pad=128):
    vag = make_padded_vag(jtarget.value_and_grad_fn, d_pad, 1)
    dim = x.shape[1]
    lp, g = vag(jnp.pad(jnp.asarray(x), ((0, 0), (0, d_pad - dim))))
    g = np.asarray(g)
    assert not g[:, dim:].any()          # the padding's gradient is masked
    return np.asarray(lp)[:, 0], g[:, :dim]


def _layouts(info):
    """The plain device function in the warp-per-chain layout and in kernel
    3's lane groups (with its gradient: the builder at group G)."""
    group = pt.rwmh_lanes(info["dim"])
    return (pt.device_vag(info),
            pt._BUILDERS[info["family"]](info["dim"], info["params"], group))


@pytest.mark.parametrize("family,dim", CASES)
def test_value_and_grad_matches_jax_f64(family, dim):
    """The port targets and both layouts' plain device functions against
    the JAX target and its padded device function, float64, to 1e-12."""
    x = _positions(family, dim, 32, dim)
    jtarget, target = _pair(family, dim)
    lp_j, g_j = (np.asarray(a) for a in jtarget.value_and_grad_fn(jnp.asarray(x)))
    lp_t, g_t = target.value_and_grad_fn(_t(x))
    assert lp_t.dtype == torch.float64 and g_t.shape == (32, dim)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-12, atol=1e-12)
    lp_p, g_p = _jax_padded(jtarget, x)
    for vag in _layouts(target.value_and_grad_fn.kernel_info):
        lp, g = vag(_t(x))
        for ours, pallas, ref in ((lp, lp_p, lp_j), (g, g_p, g_j)):
            np.testing.assert_allclose(ours.numpy(), pallas, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("family,dim", CASES)
def test_device_function_matches_jax_padded_vag_f32(family, dim):
    """Float32: both layouts' plain device functions against the JAX padded
    device function, the same formulas in another summation order: lp to
    4 ulp of the largest |term| summed (Rosenbrock's terms reach 1e3 at
    a = 100), gradients to 4 ulp of their own magnitude plus 1e-6 (the L1
    shells: plus 8 ulp of u = |q|_1 over sigma^2, the shells' slope
    -(u - r) / sigma^2 amplifying u's rounding)."""
    x32 = _positions(family, dim, 32, dim + 1).astype(np.float32)
    jtarget, target = _pair(family, dim)
    lp_j, g_j = _jax_padded(jtarget, x32)
    ulp = float(np.finfo(np.float32).eps)
    scale = np.abs(lp_j).max() + 1.0
    g_atol = 1e-6
    if family in ("concentric_l1_balls", "nested_l1_balls"):
        g_atol += 8 * ulp * float(np.abs(x32).sum(1).max()) / 0.25
    for vag in _layouts(target.value_and_grad_fn.kernel_info):
        lp, g = vag(_t(x32))
        assert lp.dtype == g.dtype == torch.float32
        np.testing.assert_allclose(lp.numpy(), lp_j, rtol=0, atol=4 * ulp * scale * dim)
        np.testing.assert_allclose(g.numpy(), g_j, rtol=4 * ulp * dim, atol=g_atol)
    info = target.value_and_grad_fn.kernel_info
    np.testing.assert_array_equal(pt.device_lp(info)(_t(x32)).numpy(),
                                  _layouts(info)[1](_t(x32))[0].numpy())


@pytest.mark.parametrize("family", ["concentric_l1_balls", "nested_l1_balls"])
def test_l1_sign_is_zero_at_zero(family):
    """jnp.sign(0) = 0: a coordinate exactly 0 (or exactly on a centre's
    axis offset) has a zero gradient entry in the JAX target, its padded
    device function and both layouts of the plain version."""
    dim = 3
    x = _positions(family, dim, 8, 4).astype(np.float32)
    x[:, 1] = 0.0
    x[2, 0] = 2.0 if family == "nested_l1_balls" else 0.0    # on c_1's offset
    jtarget, target = _pair(family, dim)
    lp_j, g_j = _jax_padded(jtarget, x)
    assert (g_j[:, 1] == 0).all()
    for vag in _layouts(target.value_and_grad_fn.kernel_info):
        lp, g = vag(_t(x))
        assert not g[:, 1].any()
        np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-6)
    g_ref = np.asarray(jtarget.value_and_grad_fn(jnp.asarray(x.astype(np.float64)))[1])
    assert (g_ref[:, 1] == 0).all()


def test_shells_past_the_cap_raise():
    """The kernels carry at most MAX_SHELLS shells: an L1 target with more
    raises ValueError naming the cap in kernel_info, the plain device
    function and the launchers' arguments; its own value-and-grad runs."""
    many = tr.concentric_l1_balls(dim=3, radii=tuple(float(r) for r in range(1, 10)))
    nested = tr.nested_l1_balls(dim=2, n_inner=pt.MAX_SHELLS)
    assert pt.MAX_SHELLS == 8 and "MAX_SHELLS = 8" in (
        Path(pt.__file__).parents[1] / "csrc" / "targets.cuh").read_text().replace(
            "constexpr int MAX_SHELLS = 8", "MAX_SHELLS = 8")
    for t in (many, nested):
        info = t.value_and_grad_fn.kernel_info
        for call in (lambda: pt.kernel_info(t.value_and_grad_fn, "grahmc"),
                     lambda: pt.device_vag(info), lambda: ft.target_args(info, "cpu"),
                     lambda: ft.make_fused_grahmc_step(t.value_and_grad_fn, 4, None)):
            with pytest.raises(ValueError, match="MAX_SHELLS"):
                call()
        assert bool(torch.isfinite(t.value_and_grad_fn(torch.ones(4, info["dim"]))[0]).all())
    ok = tr.nested_l1_balls(dim=2, n_inner=pt.MAX_SHELLS - 1)
    assert len(pt.device_shells(ok.value_and_grad_fn.kernel_info)) == pt.MAX_SHELLS


@pytest.mark.parametrize("name", ["rosenbrock", "multimodal_funnel_2d", "concentric_l1_2d",
                                  "concentric_l1_3d", "nested_l1_2d", "nested_l1_3d"])
def test_tags_params_and_registry(name):
    """get_target's names with the JAX package's parameters: the tag is the
    JAX package's (target_from_tag carries it across; a tampered radius or
    n_inner raises), every kernel dispatches on it, the device parameters
    are the JAX builder's constants rounded once, the family ids match
    `enum Family` of csrc/targets.cuh, and has_reference_sampler agrees."""
    t, theirs = tt.get_target(name), jt.get_target(name)
    info, jinfo = pt.kernel_info(t.value_and_grad_fn), theirs.value_and_grad_fn.pallas_info
    assert info == jinfo and t.name == theirs.name and t.dim == theirs.dim
    for kernel in ("grahmc", "rwmh", "nuts"):
        assert pt.kernel_info(t.value_and_grad_fn, kernel) is info
    back = interop.target_from_tag(jinfo)
    assert back.value_and_grad_fn.kernel_info == info
    family, p = info["family"], info["params"]
    tampered = {"rosenbrock": dict(jinfo, params=dict(p, a=100.0)),
                "multimodal_funnel_2d": dict(jinfo, dim=3),
                "concentric_l1_balls": dict(jinfo, params=dict(p, n_inner=4)),
                "nested_l1_balls": dict(jinfo, params=dict(p, n_inner=4.5))}[family]
    with pytest.raises(ValueError):
        interop.target_from_tag(tampered)
    params, shells = pt.device_params(info), pt.device_shells(info)
    if family == "rosenbrock":
        a = 1.0 / 0.1 ** 2               # the JAX builder's a, in double
        assert params[:3] == (a, 2.0 * a, 4.0 * a) and shells == ()
    elif family == "multimodal_funnel_2d":
        assert params[:3] == (3.0, 1.0, 1.0) and params[3] == pytest.approx(
            np.log(0.5) - 0.5 * np.log(2 * np.pi), rel=1e-15)
    elif family == "concentric_l1_balls":
        assert params[0] == 0.25 and shells == (4.0, 8.0, 16.0)
    else:
        assert params[:2] == (0.25, 2.0) and shells == (20.0,) + (2.0,) * 4
    enum = dict(re.findall(r"\n\s+([A-Z_0-9]+) = (\d+)",
                           (Path(ft.__file__).parents[1] / "csrc" / "targets.cuh").read_text()))
    cuda_name = {"concentric_l1_balls": "CONCENTRIC_L1", "nested_l1_balls": "NESTED_L1"}.get(
        family, family.upper())
    assert int(enum[cuda_name]) == pt.FAMILY_IDS[family]
    assert tt.has_reference_sampler(name) == jt.has_reference_sampler(name)


def test_every_pallas_family_is_ported():
    """KERNEL_FAMILIES holds all 14 families of the JAX package's
    _BUILDERS, in every kernel; the L1 and Rosenbrock families sum in the
    kernels' lane order."""
    assert set(J_BUILDERS) == set(pt.FAMILY_IDS) == set(pt._BUILDERS)
    for kernel in ("grahmc", "rwmh", "nuts"):
        assert set(pt.KERNEL_FAMILIES[kernel]) == set(J_BUILDERS)
    assert {"rosenbrock", "concentric_l1_balls", "nested_l1_balls"} <= set(
        pt.LANE_ORDER_FAMILIES)


def test_exact_sampler_init_samplers_and_moments():
    """The bimodal funnel's exact sampler (float64, from the generator) has
    the target's moments (means within 5 standard errors, Var v within 2%,
    Var x's heavy tail within 10%); each init sampler draws float32 with a
    finite log-density, the L1 shells on their radii."""
    n = 400_000
    draws = tt.get_reference_sampler("multimodal_funnel_2d")(torch.Generator().manual_seed(1), n)
    t = tt.get_target("multimodal_funnel_2d")
    assert draws.shape == (n, 2) and draws.dtype == torch.float64
    var = torch.diagonal(t.true_cov)
    assert bool(((draws.mean(0) - t.true_mean).abs() < 5 * torch.sqrt(var / n)).all())
    assert abs(float(draws[:, 0].var() / var[0]) - 1) < 0.02
    assert abs(float(draws[:, 1].var() / var[1]) - 1) < 0.1
    assert abs(float((draws[:, 0] > 0).double().mean()) - 0.5) < 0.005
    for name in ("rosenbrock", "multimodal_funnel_2d", "concentric_l1_2d", "nested_l1_3d"):
        t = tt.get_target(name)
        x = t.init_sampler(torch.Generator().manual_seed(2), 2000)
        assert x.shape == (2000, t.dim) and x.dtype == torch.float32
        assert bool(torch.isfinite(t.value_and_grad_fn(x)[0]).all())
    x = tt.get_target("concentric_l1_2d").init_sampler(torch.Generator().manual_seed(3), 4000)
    u = x.abs().sum(1)
    assert float(torch.min((u[:, None] - torch.tensor([4.0, 8.0, 16.0])).abs().min(1)[0]
                           .median())) < 0.5


# ---------------------------------------------------------------------------
# Plain kernels against the Pallas kernels (interpret mode, injected draws)
# ---------------------------------------------------------------------------

C = 16
STEP = {"rosenbrock": 0.04, "multimodal_funnel_2d": 0.3, "concentric_l1_balls": 0.4,
        "nested_l1_balls": 0.5}
KERNEL_CASES = [("rosenbrock", 10), ("multimodal_funnel_2d", 2), ("concentric_l1_balls", 3),
                ("nested_l1_balls", 2)]


def _jax_state(family, dim):
    x32 = _positions(family, dim, C, 5).astype(np.float32)
    if family == "rosenbrock":
        x32 = (1.0 + 0.05 * np.random.default_rng(6).standard_normal((C, dim))).astype(
            np.float32)
    jtarget, target = _pair(family, dim)
    s = jbase.init_chain_state(jnp.asarray(x32), jtarget.log_prob_fn, jtarget.value_and_grad_fn)
    s = s._replace(position=s.position.astype(F32), log_prob=s.log_prob.astype(F32),
                   grad_log_prob=s.grad_log_prob.astype(F32))
    return jtarget, target, s


@pytest.mark.parametrize("family,dim", KERNEL_CASES)
def test_plain_kernel_1_matches_pallas(family, dim):
    """Kernel 1 (make_debug_trajectory, tanh friction, L = 8) on the same
    injected draws: accepts equal, states within 2e-4, delta H within 2e-3
    (relative to Rosenbrock's energies)."""
    jtarget, target, js = _jax_state(family, dim)
    rng = np.random.default_rng(11)
    eps, gamma, steep, L = STEP[family], 0.5, 0.5, 8
    p0 = rng.standard_normal((C, dim)).astype(np.float32)
    u = rng.uniform(size=C).astype(np.float32)
    inv_mass = np.ones(dim, np.float32)
    run_j = jft.make_debug_trajectory(jtarget.value_and_grad_fn, L, jg.tanh_schedule, C, dim)
    outs_j = run_j(js.position, js.log_prob, js.grad_log_prob, jnp.asarray(p0),
                   jnp.asarray(u), eps, gamma, steep, jnp.asarray(inv_mass))
    run_t = ft.make_debug_trajectory(target.value_and_grad_fn, L, tg.tanh_schedule, C, dim)
    outs_t = run_t(_t(js.position), _t(js.log_prob), _t(js.grad_log_prob), _t(p0), _t(u), eps,
                   gamma, steep, _t(inv_mass))
    np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3]))
    assert 0 < int(outs_t[3].sum()) < C
    for a, b in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs_t[4].numpy(), np.asarray(outs_j[4]), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("family,dim", KERNEL_CASES)
def test_plain_kernel_3_matches_pallas(family, dim):
    """Kernel 3 (T = 8) on the JAX kernel's own draws: accepts equal, q and
    lp within 1e-5 relative (kernel 3 sums in its lane groups, the JAX
    kernel over the padded block)."""
    jtarget, target, js = _jax_state(family, dim)
    T, scale = 8, 0.5 * STEP[family]
    key = random.PRNGKey(dim)
    multi = j_rwmh(jtarget.log_prob_fn, jtarget.value_and_grad_fn, T, interpret=True)
    _, ms, (acc_j, hist_q_j, hist_lp_j) = multi(
        key, js._replace(grad_log_prob=jnp.zeros_like(js.position)), scale)
    d_pad = jft._round_up(dim, jft.SUBLANE)
    k_noise, k_u = random.split(random.split(key)[1])
    noise = random.normal(k_noise, (T, d_pad, C), F32)
    u = random.uniform(k_u, (T, C), F32)
    noise = np.ascontiguousarray(np.transpose(np.asarray(noise), (0, 2, 1))[:, :, :dim])
    info = target.value_and_grad_fn.kernel_info
    q1, lp1, acc_t, hist_q_t, hist_lp_t = fr.rwmh_multistep_kernel(
        info, T, _t(js.position), _t(js.log_prob), fr.rwmh_scale(scale, "cpu"), C,
        noise=_t(noise), u=_t(u))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert 0 < int(acc_t.sum()) < T * C
    for a, b in ((hist_q_t, hist_q_j), (hist_lp_t, hist_lp_j), (q1, ms.position),
                 (lp1, ms.log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family,dim", KERNEL_CASES)
def test_plain_kernel_4_matches_pallas(family, dim):
    """Kernel 4 (W = 4, 12 iterations, depth 6) on the JAX window's
    injected draws from one carried state: the discrete state equal and the
    emitted state and trajectory in flight within 2e-4 on every chain."""
    from test_torch_nuts import _DISCRETE, _jax_draws, _port_draws, _unpack
    jtarget, target, js = _jax_state(family, dim)
    n_iters, depth, w = 12, 6, 4
    step = STEP[family]
    key = random.PRNGKey(3)
    window = jfn.make_fused_nuts_window(jtarget.value_and_grad_fn, n_iters, depth, C, dim,
                                        interpret=True, steps_per_iter=w)
    q0, lp0, g0 = js.position, js.log_prob, js.grad_log_prob
    ts = window(key, jfn.pack_state(q0, lp0, g0, jfn._round_up(dim, jfn.SUBLANE)), step,
                jnp.ones(dim, F32))
    ps0 = j_init_pstate(q0, lp0, g0, F32)
    s = interop.nuts_state_from_numpy(device="cpu", **{
        k: np.asarray(v) for k, v in ps0._asdict().items() if v is not None})
    out = fn.nuts_window_kernel(target.value_and_grad_fn.kernel_info, n_iters, w, depth, s,
                                fn.nuts_scalars(step, 1000.0, "cpu"), torch.ones(dim),
                                draws=_port_draws(_jax_draws(key, dim, n_iters)))
    jax_fields = _unpack(ts, dim)
    for name in _DISCRETE + ("n_exec",):
        np.testing.assert_array_equal(getattr(out, name).numpy().astype(np.float64),
                                      np.asarray(jax_fields[name]).astype(np.float64),
                                      err_msg=name)
    for name in ("q", "q_res", "lp", "lp_res", "alpha_acc", "q_c", "q_l", "q_r"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(jax_fields[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    assert int(out.transitions.sum()) > 0
