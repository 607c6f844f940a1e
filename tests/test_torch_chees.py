"""Port parity for ChEES (mcmc_tpu/tuning/chees.py): the jitter stream, the
schedule and the leapfrog quantization exactly; the Adam, criterion and
friction-SPSA updates to 1e-12 in float64; the dynamic-length MH
transition on the JAX function's own draws for every friction schedule;
the fused backend's jitter levels and branch indices against the JAX
package's Pallas backend; the fused transition (kernel 1's plain version)
against the eager one at a fixed length; and the warmup against the JAX
warmup statistically. The CUDA path runs in tests/test_torch_cuda.py and
chip_smoke.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.samplers import trajectory as jtraj  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu.tuning import chees as jc  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.ops.padded_targets import make_device_vag  # noqa: E402
from mcmc_tpu_torch.samplers import base as tbase  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers import trajectory as ttraj  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402
from mcmc_tpu_torch.tuning import chees as tc  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def test_halton_schedule_and_leapfrog_counts_match_jax():
    for n, offset in ((1, 0), (37, 0), (100, 5), (64, 16384), (8192, 24576)):
        np.testing.assert_array_equal(tc.halton_sequence(n, offset),
                                      jc.halton_sequence(n, offset))
    for num_warmup in (7, 50, 100, 300, 999, 1000, 2500, 4000):
        assert tc.scale_default_schedule(num_warmup) == jc.scale_default_schedule(num_warmup)
    eps = 0.37
    t = np.concatenate([np.linspace(0.0, 10.0, 101), [eps, 2 * eps, 1e-9, 1e3]])
    for dtype in (np.float32, np.float64):
        ours = tc.num_leapfrog_steps(_t(t.astype(dtype)), np.float64(eps).astype(dtype), 24)
        theirs = jc.num_leapfrog_steps(jnp.asarray(t.astype(dtype)),
                                       jnp.asarray(eps, dtype), 24)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _largest_term(q0, q1, p1, alpha, inv_mass, t):
    """The largest |t alpha_i dc_i/dt| / sum(alpha) of chees_log_t_grad's
    weighted sum over the finite chains (numpy, float64)."""
    if inv_mass.ndim == 2:
        chol = np.linalg.cholesky(inv_mass)
        z0, z1 = np.linalg.solve(chol, q0.T).T, np.linalg.solve(chol, q1.T).T
        v1 = p1 @ chol
    else:
        s = np.sqrt(inv_mass)
        z0, z1, v1 = q0 / s, q1 / s, p1 * s
    ok = np.isfinite(z1).all(1) & np.isfinite(v1).all(1)
    d1 = z1[ok] - z1[ok].mean(0)
    c = (d1 * d1).sum(1) - ((z0[ok] - z0.mean(0)) ** 2).sum(1)
    terms = alpha[ok] * c * (d1 * v1[ok]).sum(1)
    return t * np.abs(terms).max() / alpha[ok].sum()


def test_chees_update_log_t_grad_and_spsa_match_jax_f64():
    """Adam on log T over a sequence of gradients (non-finite ones count as
    0), the criterion's gradient (diagonal and dense metrics, diverged
    rows, with and without the winsorizing clip) and the SPSA batch update
    (live, one-sided and degenerate sums), each against the JAX function
    in float64, to 1e-12 (the criterion relative to its largest term)."""
    rng = np.random.default_rng(0)
    ours = tc.chees_init(0.3, torch.float64, "cpu")
    theirs = jc.chees_init(0.3, jnp.float64)
    for g in (0.5, -1.3, float("nan"), 2.0, float("inf"), 1e-3, -0.2):
        ours = tc.chees_update(ours, torch.tensor(g, dtype=torch.float64), lr=0.05)
        theirs = jc.chees_update(theirs, jnp.asarray(g), lr=0.05)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
    carried = interop.chees_state_from_numpy(*[np.asarray(x) for x in theirs], device="cpu")
    for a, b in zip(tc.chees_update(carried, 0.7), jc.chees_update(theirs, 0.7)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)

    c, d = 65, 6
    q0, q1, p1 = (rng.standard_normal((c, d)) for _ in range(3))
    q1[3, 2], p1[7, 0] = np.inf, np.nan
    q1[11] *= 40.0                          # a runaway chain the clip bounds
    alpha = rng.uniform(size=c)
    diag = rng.uniform(0.5, 2.0, size=d)
    a = rng.standard_normal((d, d))
    dense = a @ a.T / d + np.eye(d)
    for inv_mass in (diag, dense):
        for winsorize in (tc.CHEES_WINSOR_MULT, 0.0):
            ours = tc.chees_log_t_grad(_t(q0), _t(q1), _t(p1), 0.4, 2.5, _t(alpha),
                                       _t(inv_mass), winsorize=winsorize)
            theirs = jc.chees_log_t_grad(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(p1),
                                         0.4, 2.5, jnp.asarray(alpha), jnp.asarray(inv_mass),
                                         winsorize=winsorize)
            # a sum's rounding scales with its largest term: 1e-12 of it
            np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-12,
                                       atol=1e-12 * _largest_term(q0, q1, p1, alpha, inv_mass,
                                                                  0.4 * 2.5))

    for sums in ((2.0, 3.0, 4.0, 5.0), (2.0, 0.0, 4.0, 0.0), (0.0, 1.0, 0.0, 3.0),
                 (50.0, 1e-3, 10.0, 10.0)):
        gs_j = jc.GammaSPSAState(jnp.asarray(math.log(0.7)), *map(jnp.asarray, sums))
        gs_t = interop.gamma_spsa_state_from_numpy(*[np.asarray(x) for x in gs_j],
                                                   device="cpu")
        for a, b in zip(tc.gamma_spsa_batch_update(gs_t), jc.gamma_spsa_batch_update(gs_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    for gamma in (0.0, 1e-4, 0.7, 100.0):
        np.testing.assert_allclose(
            float(tc.gamma_spsa_init(gamma, torch.float64, "cpu").log_gamma),
            float(jc.gamma_spsa_init(gamma, jnp.float64).log_gamma), rtol=1e-15)


@pytest.mark.parametrize("schedule", [None, "constant", "tanh", "sigmoid", "linear", "sine"])
def test_mh_transition_dynamic_matches_jax_on_its_draws(schedule):
    """One jittered transition (n = 7 leapfrogs on the 5-D funnel) of the
    port and of the JAX function, the port fed the momentum and uniforms
    the JAX function draws from its key: every output within 1e-12 in
    float64."""
    dim, c, n, eps = 5, 32, 7, 0.45
    jt = j_get_target("neals_funnel", dim=dim)
    tt = t_get_target("neals_funnel", dim=dim)
    x = np.random.default_rng(1).standard_normal((c, dim))
    inv_mass = np.random.default_rng(2).uniform(0.5, 1.5, size=dim)
    js = jbase.init_chain_state(jnp.asarray(x), jt.log_prob_fn, jt.value_and_grad_fn)
    fj = None if schedule is None else jg.get_friction_schedule(schedule)
    ft_ = None if schedule is None else tg.get_friction_schedule(schedule)
    key = random.PRNGKey(3)
    out_j = jtraj.mh_transition_dynamic(key, js, jt.value_and_grad_fn, eps, jnp.asarray(n),
                                        jnp.asarray(inv_mass), friction_schedule=fj,
                                        gamma_max=0.6, steepness=2.0)
    _, k_mom, k_acc = random.split(key, 3)
    p0 = jtraj.sample_momentum(k_mom, (c, dim), jnp.asarray(inv_mass), jnp.float64)
    u = random.uniform(k_acc, (c,), dtype=jnp.float64)
    ts = interop.chain_state_from_numpy(*[np.asarray(v) for v in js], device="cpu")
    out_t = ttraj.mh_transition_dynamic(None, ts, tt.value_and_grad_fn, eps, n, _t(inv_mass),
                                        friction_schedule=ft_, gamma_max=0.6, steepness=2.0,
                                        p0=_t(p0), u=_t(u))
    new_j, new_t = out_j[1], out_t[0]
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    for a, b in zip(out_t[1:], out_j[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    acc = out_t[1].numpy()
    assert 0 < acc.sum() < c


@pytest.mark.parametrize("t_len,eps,levels,max_steps", [(2.0, 0.5, 4, 256), (3.3, 0.4, 3, 5),
                                                         (1.0, 0.3, 6, 256)])
def test_fused_levels_and_branches_match_jax(t_len, eps, levels, max_steps):
    """chees_run's fused backend quantizes the jitter exactly as the JAX
    package's Pallas backend: the same level lengths (Python's round, half
    to even: T / eps = 4 at 4 levels gives 0.5, 1.5, 2.5, 3.5 -> 1, 2, 2,
    4 after the clip to >= 1) and the same per-draw lengths, burn-in
    included; the run's draws are finite and its leapfrog total their
    sum."""
    jt = j_get_target("standard_normal", dim=4)
    tt = t_get_target("standard_normal", dim=4)
    init = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    kw = dict(burn_in=4, jitter_levels=levels, max_steps=max_steps, halton_offset=3)
    res_j = jc.chees_run(random.PRNGKey(1), jt.log_prob_fn, jnp.asarray(init), eps, t_len, 20,
                         value_and_grad_fn=jt.value_and_grad_fn, backend="pallas", **kw)
    res_t = tc.chees_run(torch.Generator().manual_seed(1), tt.log_prob_fn, _t(init), eps,
                         t_len, 20, value_and_grad_fn=tt.value_and_grad_fn, backend="fused",
                         **kw)
    assert res_t.info["jitter_level_steps"] == list(res_j.info["jitter_level_steps"])
    np.testing.assert_array_equal(res_t.info["num_steps_per_draw"],
                                  np.asarray(res_j.info["num_steps_per_draw"]))
    ls, idx = tc.jitter_levels_of(t_len, eps, max_steps, levels,
                                  tc.halton_sequence(24, 3))
    np.testing.assert_array_equal(np.asarray(ls)[idx][4:], res_t.info["num_steps_per_draw"])
    if (t_len, eps, levels) == (2.0, 0.5, 4):
        assert ls == [1, 2, 4]
    assert res_t.info["total_leapfrogs"] == res_j.info["total_leapfrogs"]
    assert res_t.info["jitter_backend"] == "fused"
    assert bool(torch.isfinite(res_t.samples).all()) and res_t.samples.shape == (20, 8, 4)


def test_fused_transition_equals_eager_at_fixed_length():
    """At a fixed length L the fused transition (kernel 1's plain version,
    injected draws) and the eager dynamic one (mh_transition_dynamic) give
    the same state, accepts and proposal bit for bit in float32: kernel 1
    flips the momentum, whose kinetic energy is unchanged."""
    dim, c, n = 20, 64, 6
    tt = t_get_target("neals_funnel_noncentered", dim=dim)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((c, dim), generator=g) * 0.8
    inv_mass = torch.rand(dim, generator=g) + 0.5
    p0 = torch.randn((c, dim), generator=g) / torch.sqrt(inv_mass)
    u = torch.rand(c, generator=g)
    # both through the kernels' device function (its sums in the kernels'
    # order), as kernel 1's plain version evaluates the target
    vag = make_device_vag(tt.value_and_grad_fn)
    state = tbase.init_chain_state(q, tt.log_prob_fn, vag)
    eager, accept, q1, _p1, log_alpha, _div = ttraj.mh_transition_dynamic(
        None, state, vag, 0.4, n, inv_mass, p0=p0, u=u)
    kern = ft.grahmc_step_kernel(tt.value_and_grad_fn.kernel_info, n, 0, q,
                                 state.log_prob, state.grad_log_prob,
                                 ft.kernel_scalars(0.4, 0.0, 1.0, "cpu"), inv_mass,
                                 p0=p0, u=u)
    assert torch.equal(kern[0], eager.position) and torch.equal(kern[1], eager.log_prob)
    assert torch.equal(kern[2], eager.grad_log_prob) and torch.equal(kern[3], accept)
    assert torch.equal(kern[5], q1)
    assert 0 < int(accept.sum()) < c and bool((log_alpha <= 0).all())


# The JAX warmup's spread over three seeds (keys 0, 1, 2) on the 8-D
# standard normal, 128 chains from N(0, 0.5^2), 600 steps (150 exploration,
# windows 50/100/200, 100 cooldown): the port's T and step, from its own
# generator, must land within BAND of the JAX runs' range, widened by the
# larger of 15% of their mean and three of their standard deviations.
WARMUP_KW = dict(num_warmup=600, exploration_steps=150, adaptation_windows=[50, 100, 200],
                 cooldown_steps=100)
VARIANTS = {"hmc": ("hmc", {}),
            "grahmc-grid": ("grahmc", dict(schedule_type="tanh", gamma=0.5,
                                           gamma_coarse_values=[0.1, 0.5],
                                           gamma_samples_per_eval=20)),
            "grahmc-joint": ("grahmc", dict(schedule_type="tanh", gamma=0.5,
                                            gamma_tuner="joint"))}


def _band(values):
    values = np.asarray(values, np.float64)
    pad = max(0.15 * values.mean(), 3.0 * values.std())
    return values.min() - pad, values.max() + pad


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chees_warmup_matches_jax_statistically(variant):
    sampler, extra = VARIANTS[variant]
    jt = j_get_target("standard_normal", dim=8)
    tt = t_get_target("standard_normal", dim=8)
    init = (np.random.default_rng(5).standard_normal((128, 8)) * 0.5).astype(np.float32)
    runs = []
    for seed in range(3):
        step, inv_mass, pos, info = jc.run_chees_warmup(
            sampler, jt.log_prob_fn, None, jnp.asarray(init), random.PRNGKey(seed),
            value_and_grad_fn=jt.value_and_grad_fn, **WARMUP_KW, **extra)
        runs.append((info["trajectory_length"], step))
    step, inv_mass, pos, info = tc.run_chees_warmup(
        sampler, tt.log_prob_fn, None, _t(init), torch.Generator().manual_seed(0),
        value_and_grad_fn=tt.value_and_grad_fn, **WARMUP_KW, **extra)
    for value, name, column in ((info["trajectory_length"], "T", 0), (step, "step", 1)):
        lo, hi = _band([r[column] for r in runs])
        assert lo < value < hi, (variant, name, value, runs)
    assert not info["max_steps_cap_hit"] and 1 <= info["num_steps"]
    assert pos.shape == (128, 8) and bool(torch.isfinite(pos).all())
    np.testing.assert_allclose(inv_mass.numpy(), 1.0, atol=0.3)
    assert len(info["accept_history"]) == len(info["log_t_history"]) == 7
    assert 0.45 < np.mean(info["accept_history"][-2:]) < 0.85
    if sampler == "grahmc":
        assert info["gamma_tuner"] == extra.get("gamma_tuner", "grid")
        assert tc.GAMMA_MIN <= info["gamma"] <= tc.GAMMA_MAX


def test_chees_run_and_warmup_refusals():
    tt = t_get_target("standard_normal", dim=3)
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tc.chees_run(torch.Generator(), tt.log_prob_fn, x, 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="backend"):
        tc.chees_run(torch.Generator(), tt.log_prob_fn, x, 0.1, 1.0, 4, backend="pallas")
    with pytest.raises(TypeError):
        tc.chees_run(torch.Generator(), tt.log_prob_fn, x, 0.1, 1.0, 4, backend="fused")
    with pytest.raises(NotImplementedError, match="parallel"):
        tc.chees_run(torch.Generator(), tt.log_prob_fn, x, 0.1, 1.0, 4, mesh=object())
    with pytest.raises(ValueError):
        tc.run_chees_warmup("nuts", tt.log_prob_fn, None, x, torch.Generator())
    with pytest.raises(ValueError, match="diagonal"):
        tc.run_chees_warmup("grahmc", tt.log_prob_fn, None, x, torch.Generator(),
                            learn_mass_matrix="dense", gamma_tuner="joint")
    with pytest.raises(NotImplementedError, match="parallel"):
        tc.run_chees_warmup("hmc", tt.log_prob_fn, None, x, torch.Generator(), mesh=object())
    assert tc._resolve_backend("auto", tt.value_and_grad_fn, "cpu") == "eager"
    assert tc._resolve_backend("auto", tt.value_and_grad_fn, "cuda") == "fused"
    assert tc._resolve_backend("auto", lambda q: q, "cuda") == "eager"
