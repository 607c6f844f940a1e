"""Port parity for the windowed warmup: the Welford and dense-moment pieces,
the schedule, da_reset, the warmup's plumbing and the sequential gamma tune
against the JAX package (float64, the stepping functions stubbed the same way
in both packages), and the slice end to end on the CPU: the port's dense
GRAHMC warmup through kernel 1a's plain version against the JAX package's
through its Pallas kernel in interpret mode, then sampling with the learned
metric through both fused dispatches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

import mcmc_tpu.tuning.adaptation as j_adapt  # noqa: E402
import mcmc_tpu.tuning.sequential as j_seq  # noqa: E402
from mcmc_tpu import targets as jt  # noqa: E402
from mcmc_tpu.tuning import dual_averaging as j_da  # noqa: E402
from mcmc_tpu.tuning import welford as jw  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch import targets as tt  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.tuning import adaptation as t_adapt  # noqa: E402
from mcmc_tpu_torch.tuning import dual_averaging as t_da  # noqa: E402
from mcmc_tpu_torch.tuning import sequential as t_seq  # noqa: E402
from mcmc_tpu_torch.tuning import welford as tw  # noqa: E402

def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=tol, atol=tol)


def test_welford_pieces_match_jax_f64():
    """welford_* and the chain-averaged variance, shrinkage, the pooled dense
    moments and their shrinkage, in float64, to 1e-12."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((30, 8, 5)) * np.linspace(0.5, 3.0, 5) + 1.5
    js, ts = jw.welford_init((8, 5)), tw.welford_init((8, 5), torch.float64, "cpu")
    for x in xs[:20]:
        js, ts = jw.welford_update(js, jnp.asarray(x)), tw.welford_update(ts, _t(x))
    js = jw.welford_update_batch(js, jnp.asarray(xs[20:]))
    ts = tw.welford_update_batch(ts, _t(xs[20:]))
    for ours, theirs in zip(ts, js):
        _close(ours, theirs, 1e-12)
    for ours, theirs in zip(tw.welford_covariance(ts), jw.welford_covariance(js)):
        _close(ours, theirs, 1e-12)
    var_j, var_t = jw.chain_averaged_variance(js), tw.chain_averaged_variance(ts)
    _close(var_t, var_j, 1e-12)
    _close(tw.shrink_variance(var_t, ts.count), jw.shrink_variance(var_j, js.count), 1e-12)
    _close(tw.shrink_variance(_t([-1.0, 1e-12]), 3.0),
           jw.shrink_variance(jnp.asarray([-1.0, 1e-12]), 3.0), 1e-12)   # the floor

    center = xs[0].mean(axis=0)
    jd, td = jw.dense_moment_init(jnp.asarray(center)), tw.dense_moment_init(_t(center))
    for x in xs:
        jd, td = jw.dense_moment_update(jd, jnp.asarray(x)), tw.dense_moment_update(td, _t(x))
    for ours, theirs in zip(td, jd):
        _close(ours, theirs, 1e-12)
    cov_j, cov_t = jw.dense_covariance(jd), tw.dense_covariance(td)
    _close(cov_t, cov_j, 1e-12)
    np.testing.assert_allclose(cov_t.numpy(), np.cov(xs.reshape(-1, 5).T, bias=True),
                               rtol=1e-10, atol=1e-10)
    _close(tw.shrink_covariance(cov_t, td.count / 8), jw.shrink_covariance(cov_j, jd.count / 8),
           1e-12)
    # carried across from the JAX states
    for ours, theirs in zip(interop.welford_state_from_numpy(*map(np.asarray, js), device="cpu"),
                            js):
        _close(ours, theirs, 0.0)
    for ours, theirs in zip(interop.dense_moment_state_from_numpy(*map(np.asarray, jd),
                                                                  device="cpu"), jd):
        _close(ours, theirs, 0.0)


@pytest.mark.parametrize("kw", [{}, dict(num_steps=425, exploration_steps=100,
                                         adaptation_windows=[25, 50, 125],
                                         cooldown_steps=125)])
def test_schedule_and_fixed_width_batches_match_jax(kw):
    assert t_adapt.build_schedule(**kw) == j_adapt.build_schedule(**kw)
    for window, width in ((25, 100), (250, 100), (100, 100), (7, 3), (1, 1)):
        ours = list(t_adapt.fixed_width_batches(window, width))
        theirs = list(j_adapt.fixed_width_batches(window, width))
        assert [n for n, _ in ours] == [n for n, _ in theirs]
        for (_, m_t), (_, m_j) in zip(ours, theirs):
            np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_da_reset_matches_jax():
    """da_reset after updates restarts at the smoothed step; before any
    update at the current one."""
    js, ts = j_da.da_init(0.3), t_da.da_init(0.3, torch.float64, "cpu")
    for ours, theirs in zip(t_da.da_reset(ts), j_da.da_reset(js)):
        _close(ours, theirs, 1e-12)
    for a in (0.9, 0.2, 0.7, 0.4):
        js, ts = j_da.da_update(js, a, 0.65), t_da.da_update(ts, a, 0.65)
    for ours, theirs in zip(t_da.da_reset(ts), j_da.da_reset(js)):
        _close(ours, theirs, 1e-12)
    assert float(t_da.da_reset(ts).count) == 0.0
    assert float(t_da.da_reset(ts).mu) == pytest.approx(float(ts.log_step_bar), rel=1e-15)


# A fixed orthogonal map: the stubbed chains rotate without contracting, so
# the moments the warmup learns stay non-degenerate.
_R = np.linalg.qr(np.random.default_rng(3).standard_normal((4, 4)))[0]


def _drift(inv_mass, sum_axis):
    return inv_mass if inv_mass.ndim == 1 else inv_mass.sum(sum_axis)


def _jax_step_stub(*args, **kwargs):
    """The JAX package's _make_step_fn, stubbed: position <- x R + 0.05 eps
    m(M^{-1}), accept statistic exp(-2 eps)."""
    R = jnp.asarray(_R)

    def step(key, x, step_size, inv_mass):
        x = x @ R + 0.05 * step_size * _drift(inv_mass, 0)
        return key, x, jnp.exp(-2.0 * step_size)
    return step, (lambda pos: jnp.asarray(pos)), (lambda x: x), "leading"


_TORCH_STEPS = []


def _torch_step_stub(*args, **kwargs):
    """The port's _make_step_fn, stubbed as _jax_step_stub; counts its
    steps in _TORCH_STEPS."""
    R = _t(_R)

    def step(x, step_size, inv_mass):
        _TORCH_STEPS.append(1)
        return x @ R + 0.05 * step_size * _drift(inv_mass, 0), torch.exp(-2.0 * step_size)
    return step, (lambda pos: pos), (lambda x: x)


@pytest.mark.parametrize("learn", [False, True, "dense"])
def test_stubbed_warmup_matches_jax(monkeypatch, learn):
    """The warmup's plumbing with the same deterministic stepping function
    in both packages: the same step size, metric, position and accept trace
    in float64 to 1e-10. Windows of 30, 20, 40, 150 and 10 steps in batches
    of 25 pin the masked steps (which advance the chains), the window
    re-initialisation, the shrinkage and da_reset."""
    monkeypatch.setattr(j_adapt, "_make_step_fn", _jax_step_stub)
    monkeypatch.setattr(t_adapt, "_make_step_fn", _torch_step_stub)
    _TORCH_STEPS.clear()
    init = np.random.default_rng(4).standard_normal((16, 4))
    kw = dict(num_warmup=250, update_freq=25, learn_mass_matrix=learn,
              exploration_steps=30, adaptation_windows=[20, 40, 150], cooldown_steps=10)
    step_j, im_j, pos_j, info_j = j_adapt.run_adaptive_warmup(
        "hmc", None, None, jnp.asarray(init), random.PRNGKey(0), **kw)
    step_t, im_t, pos_t, info_t = t_adapt.run_adaptive_warmup(
        "hmc", None, None, _t(init), torch.Generator().manual_seed(0), **kw)
    assert step_t == pytest.approx(step_j, rel=1e-10)
    _close(im_t, im_j, 1e-10)
    _close(pos_t, pos_j, 1e-10)
    assert len(info_t["accept_trace"]) == len(info_j["accept_trace"]) == 12
    _close(info_t["accept_trace"], info_j["accept_trace"], 1e-10)
    assert set(info_t) == set(info_j)
    assert info_t["mass_matrix_learned"] == learn
    # 250 live steps in 12 batches of 25: the 50 masked steps ran too
    assert len(_TORCH_STEPS) == 300
    if learn:
        assert not np.allclose(np.asarray(im_t), np.eye(4) if learn == "dense" else 1.0)


def _seq_stub(u, prop, xp):
    """grahmc_step stubbed for sequential_tune_grahmc: proposal x R +
    0.1 eps (1 + gamma), accepted where the chain's fixed u < e^{-eps (1 +
    gamma / 5)}, delta H = 0.1 eps gamma |x|^2."""
    def finish(s, step_size, gamma):
        x = s.position
        q = prop(x, step_size, gamma)
        accept = u < xp.exp(-step_size * (1.0 + 0.2 * gamma))
        dh = 0.1 * step_size * gamma * (x * x).sum(-1)
        new = xp.where(accept[:, None], q, x)
        return s._replace(position=new), (accept, q, 0.0 * dh, dh)
    return finish


def test_stubbed_sequential_tune_matches_jax(monkeypatch):
    """sequential_tune_grahmc with the transition stubbed the same way in
    both packages: the same gamma, step and history to 1e-10. Both packages
    take the accept rate in float32 (a mean of booleans), and XLA may
    evaluate the jitted `target_accept - rate` with excess precision, so
    the rates here are exact in float32: 32 chains x batches of 32, target
    0.625."""
    C, D = 32, 4
    u = (np.arange(C) + 0.5) / C
    j_finish = _seq_stub(jnp.asarray(u), lambda x, e, g: x @ jnp.asarray(_R) + 0.1 * e * (1 + g),
                         jnp)
    t_finish = _seq_stub(_t(u), lambda x, e, g: x @ _t(_R) + 0.1 * e * (1 + g), torch)

    def j_step(key, s, vag, step_size, num_steps, gamma, steepness, inv_mass, sched):
        return (key,) + j_finish(s, step_size, gamma)

    def t_step(generator, s, vag, step_size, num_steps, gamma, steepness, inv_mass, sched):
        return t_finish(s, step_size, gamma)

    monkeypatch.setattr(j_seq, "grahmc_step", j_step)
    monkeypatch.setattr(t_seq, "grahmc_step", t_step)
    init = np.random.default_rng(5).standard_normal((C, D))
    kw = dict(num_steps=4, max_iter_step=128, da_batch=32, gamma_samples_per_eval=32,
              init_step_size=0.3, target_accept=0.625)
    jtar, ttar = jt.standard_normal(D), tt.standard_normal(D)
    out_j = j_seq.sequential_tune_grahmc(random.PRNGKey(0), jtar.log_prob_fn, None,
                                         jnp.asarray(init),
                                         value_and_grad_fn=jtar.value_and_grad_fn, **kw)
    out_t = t_seq.sequential_tune_grahmc(torch.Generator().manual_seed(0), ttar.log_prob_fn,
                                         None, _t(init),
                                         value_and_grad_fn=ttar.value_and_grad_fn, **kw)
    for ours, theirs in zip(out_t[:3], out_j[:3]):
        assert ours == pytest.approx(theirs, rel=1e-10)
    h_t, h_j = out_t[3], out_j[3]
    assert set(h_t) == set(h_j)
    for key in h_j:
        _close(h_t[key], h_j[key], 1e-10)
    assert len(set(h_t["per_gamma_step"])) > 1 and len(set(h_t["esjd"])) > 1


def test_warmup_refuses_what_is_not_ported():
    t = tt.standard_normal(3)
    q = torch.zeros(4, 3)
    g = torch.Generator()
    # the NUTS warmups are ported (tests/test_torch_nuts_warmup.py): classic
    # under "auto"/"eager", the persistent machine under "persistent"; the
    # mesh warmup too (tests/test_torch_parallel.py), and a mesh that is not
    # a parallel.ChainMesh is refused
    for kw in (dict(sampler="nuts", mesh=object()),
               dict(sampler="nuts", backend="persistent", mesh=object()),
               dict(sampler="grahmc", mesh=object())):
        with pytest.raises(TypeError, match="ChainMesh"):
            t_adapt.run_adaptive_warmup(kw.pop("sampler"), t.log_prob_fn, None, q, g,
                                        value_and_grad_fn=t.value_and_grad_fn, **kw)
    assert t_adapt._resolve_backend("nuts", "auto", t.value_and_grad_fn, "cuda") == "eager"
    assert t_adapt._resolve_backend("nuts", "persistent", None, "cpu") == "persistent"
    with pytest.raises(ValueError):
        t_adapt.run_adaptive_warmup("nuts", t.log_prob_fn, None, q, g, backend="fused",
                                    value_and_grad_fn=t.value_and_grad_fn)
    with pytest.raises(ValueError):
        t_adapt.run_adaptive_warmup("hmc", t.log_prob_fn, None, q, g, backend="fused",
                                    value_and_grad_fn=t.value_and_grad_fn)
    with pytest.raises(TypeError, match="ChainMesh"):
        t_seq.sequential_tune_grahmc(g, t.log_prob_fn, None, q, 4, mesh=object())
    # "auto" on CPU positions resolves to eager, never to the kernels
    assert t_adapt._resolve_backend("grahmc", "auto", t.value_and_grad_fn, "cpu") == "eager"
    assert t_adapt._resolve_backend("grahmc", "auto", t.value_and_grad_fn, "cuda") == "fused"
    assert t_adapt._resolve_backend("hmc", "auto", t.value_and_grad_fn, "cuda") == "eager"
    assert t_adapt._resolve_backend("grahmc", "auto", None, "cuda") == "eager"


# The slice end to end: a 4-D rho = 0.9 Gaussian, 64 chains, a short schedule.
E2E = dict(num_warmup=250, learn_mass_matrix="dense", num_steps=8,
           schedule_type="constant", exploration_steps=50,
           adaptation_windows=[25, 50, 100], cooldown_steps=25, update_freq=25,
           max_iter_step=100, gamma_samples_per_eval=25)


def _offdiag_corr(m):
    m = np.asarray(m)
    corr = m / np.sqrt(np.outer(np.diag(m), np.diag(m)))
    return corr[~np.eye(len(m), dtype=bool)]


def test_dense_warmup_end_to_end(monkeypatch):
    """The port's dense GRAHMC warmup through kernel 1a's plain version
    (backend="fused") and the JAX package's through its Pallas kernel in
    interpret mode (backend="pallas") both learn the rho = 0.9 correlations
    (> 0.5) and agree within 0.15; then grahmc_run(backend="fused") with the
    port's learned metric recovers Sigma to 0.15 through the multistep
    dispatch (kernel 2a's plain version) and the single-step one (1a)."""
    dim, C = 4, 64
    init = (np.random.default_rng(6).standard_normal((C, dim)) * 0.3).astype(np.float32)
    jtar = jt.correlated_gaussian(dim, correlation=0.9)
    _, im_j, _, _ = j_adapt.run_adaptive_warmup(
        "grahmc", jtar.log_prob_fn, None, jnp.asarray(init), random.PRNGKey(1),
        backend="pallas", value_and_grad_fn=jtar.value_and_grad_fn, **E2E)
    ttar = tt.correlated_gaussian(dim, correlation=0.9)
    step, im_t, pos, info = t_adapt.run_adaptive_warmup(
        "grahmc", ttar.log_prob_fn, None, _t(init), torch.Generator().manual_seed(1),
        backend="fused", value_and_grad_fn=ttar.value_and_grad_fn, **E2E)
    assert im_t.shape == (dim, dim) and im_t.dtype == torch.float32
    assert _offdiag_corr(im_t).min() > 0.5 and _offdiag_corr(im_j).min() > 0.5
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=0.15)
    assert 0.0 < step and info["gamma"] in t_seq.DEFAULT_GAMMA_GRID
    assert set(info) == {"elapsed_time", "final_step_size", "inv_mass_matrix",
                         "mass_matrix_learned", "accept_trace", "gamma", "steepness"}

    calls = {"step": 0, "multi": 0}
    for name, key in (("grahmc_step_plain", "step"), ("grahmc_multistep_plain", "multi")):
        def counted(*a, _f=getattr(ft, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(ft, name, counted)
    for track, expect in ((False, "multi"), (True, "step")):
        before = dict(calls)
        res = tg.grahmc_run(torch.Generator().manual_seed(2), ttar.log_prob_fn, pos,
                            step, 8, info["gamma"], info["steepness"], num_samples=400,
                            burn_in=40, inv_mass_matrix=im_t, track_proposals=track,
                            value_and_grad_fn=ttar.value_and_grad_fn, backend="fused")
        assert calls[expect] > before[expect] and sum(calls.values()) - sum(
            before.values()) == calls[expect] - before[expect]
        s = res.samples.reshape(-1, dim).double()
        np.testing.assert_allclose(torch.cov(s.T).numpy(), ttar.true_cov.numpy(), atol=0.15)
