"""Port parity: the eager GRAHMC/HMC path of mcmc_tpu_torch against the JAX
package in float64, with the JAX package's random draws injected."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.samplers import trajectory as jtraj  # noqa: E402
from mcmc_tpu.targets import neals_funnel as j_funnel  # noqa: E402
from mcmc_tpu_torch.samplers import base as tbase  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers import hmc as th  # noqa: E402
from mcmc_tpu_torch.samplers import trajectory as ttraj  # noqa: E402
from mcmc_tpu_torch.targets import neals_funnel as t_funnel  # noqa: E402

DIM, CHAINS, L = 10, 64, 12
EPS, GAMMA, STEEP = 0.08, 0.7, 2.0
STEP = 0.12          # full-transition step: accepts some chains, rejects others
SCHEDULES = [None, "constant", "tanh", "sigmoid", "linear", "sine"]


def _schedules(name):
    if name is None:
        return None, None
    return jg.get_friction_schedule(name), tg.get_friction_schedule(name)


def _state_np(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((CHAINS, DIM)) * 0.6
    inv_mass = rng.uniform(0.5, 1.5, DIM)
    return q, inv_mass


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_integrate_trajectory_matches_jax(schedule):
    jsched, tsched = _schedules(schedule)
    q, inv_mass = _state_np()
    p = np.random.default_rng(1).standard_normal((CHAINS, DIM))
    jt, tt = j_funnel(DIM), t_funnel(DIM)
    lp, g = jt.value_and_grad_fn(jnp.asarray(q))
    out_j = jtraj.integrate_trajectory(
        jnp.asarray(q), jnp.asarray(p), lp, g, jt.value_and_grad_fn, EPS, L,
        jnp.asarray(inv_mass), friction_schedule=jsched, gamma_max=GAMMA,
        steepness=STEEP)
    out_t = ttraj.integrate_trajectory(
        _t(q), _t(p), _t(lp), _t(g), tt.value_and_grad_fn, EPS, L,
        _t(inv_mass), friction_schedule=tsched, gamma_max=GAMMA,
        steepness=STEEP)
    for a, b in zip(out_t, out_j):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_grahmc_step_matches_jax_with_injected_draws(schedule):
    """grahmc_transition fed the JAX step's own draws (key, k_mom, k_acc =
    split(key, 3)) reproduces jax grahmc_step."""
    jsched, tsched = _schedules(schedule)
    q, inv_mass = _state_np(2)
    jt, tt = j_funnel(DIM), t_funnel(DIM)
    jstate = jbase.init_chain_state(jnp.asarray(q), jt.log_prob_fn,
                                    jt.value_and_grad_fn)
    key = random.PRNGKey(3)
    _, jstate1, (jacc, jq, jlp, jdh) = jg.grahmc_step(
        key, jstate, jt.value_and_grad_fn, STEP, L, GAMMA, STEEP,
        jnp.asarray(inv_mass), jsched)
    _, k_mom, k_acc = random.split(key, 3)
    p0 = jtraj.sample_momentum(k_mom, (CHAINS, DIM), jnp.asarray(inv_mass),
                               jnp.float64)
    u = random.uniform(k_acc, (CHAINS,), dtype=jnp.float64)

    tstate = tbase.init_chain_state(_t(q), tt.log_prob_fn, tt.value_and_grad_fn)
    tstate1, (tacc, tq, tlp, tdh) = tg.grahmc_transition(
        tstate, _t(p0), _t(u), tt.value_and_grad_fn, STEP, L, GAMMA, STEEP,
        _t(inv_mass), tsched)

    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < int(tacc.sum()) < CHAINS         # both branches exercised
    for a, b in ((tq, jq), (tlp, jlp), (tdh, jdh),
                 (tstate1.position, jstate1.position),
                 (tstate1.log_prob, jstate1.log_prob),
                 (tstate1.grad_log_prob, jstate1.grad_log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_array_equal(tstate1.accept_count.numpy(),
                                  np.asarray(jstate1.accept_count))
    np.testing.assert_array_equal(tstate1.divergence_count.numpy(),
                                  np.asarray(jstate1.divergence_count))


def test_dense_metric_trajectory_matches_jax():
    q, _ = _state_np(4)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((DIM, DIM))
    inv_mass = a @ a.T / DIM + np.eye(DIM)
    p = rng.standard_normal((CHAINS, DIM))
    jt, tt = j_funnel(DIM), t_funnel(DIM)
    lp, g = jt.value_and_grad_fn(jnp.asarray(q))
    out_j = jtraj.integrate_trajectory(
        jnp.asarray(q), jnp.asarray(p), lp, g, jt.value_and_grad_fn, EPS, L,
        jnp.asarray(inv_mass), friction_schedule=jg.tanh_schedule,
        gamma_max=GAMMA, steepness=STEEP)
    out_t = ttraj.integrate_trajectory(
        _t(q), _t(p), _t(lp), _t(g), tt.value_and_grad_fn, EPS, L,
        _t(inv_mass), friction_schedule=tg.tanh_schedule, gamma_max=GAMMA,
        steepness=STEEP)
    for x, y in zip(out_t, out_j):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(
        ttraj.kinetic_energy(_t(p), _t(inv_mass)).numpy(),
        np.asarray(jtraj.kinetic_energy(jnp.asarray(p), jnp.asarray(inv_mass))),
        rtol=1e-12)
    # p = L^{-T} z has covariance M = (M^{-1})^{-1}
    draws = ttraj.sample_momentum(torch.Generator().manual_seed(0), (200000, DIM),
                                  _t(inv_mass), torch.float64)
    np.testing.assert_allclose(np.cov(draws.numpy().T), np.linalg.inv(inv_mass),
                               atol=0.03)


def test_autograd_fallback_matches_analytic_gradient():
    q, _ = _state_np(6)
    tt = t_funnel(DIM)
    lp_a, g_a = tbase.make_value_and_grad(tt.log_prob_fn)(_t(q))
    lp_b, g_b = tt.value_and_grad_fn(_t(q))
    np.testing.assert_allclose(lp_a.numpy(), lp_b.numpy(), rtol=1e-13)
    np.testing.assert_allclose(g_a.numpy(), g_b.numpy(), rtol=1e-12)
    assert not lp_a.requires_grad and not g_a.requires_grad


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_hmc_run_equals_grahmc_run_with_zero_friction(backend):
    """With gamma = 0 every friction scale is exp(0) = 1, so GRAHMC's
    trajectory is HMC's, draw for draw, on both backends."""
    tt = t_funnel(DIM)
    q = torch.from_numpy(_state_np(7)[0]).to(torch.float32)
    kw = dict(step_size=0.1, num_steps=6, num_samples=16, burn_in=4,
              value_and_grad_fn=tt.value_and_grad_fn, backend=backend,
              collect_chains=8)
    h = th.hmc_run(torch.Generator().manual_seed(11), tt.log_prob_fn, q, **kw)
    g = tg.grahmc_run(torch.Generator().manual_seed(11), tt.log_prob_fn, q,
                      gamma=0.0, steepness=1.0,
                      friction_schedule=tg.constant_schedule, **kw)
    assert h.samples.shape == (16, 8, DIM) and h.log_probs.shape == (16, 8)
    assert torch.equal(h.samples, g.samples)
    assert torch.equal(h.accept_rate, g.accept_rate)
    assert torch.equal(h.final_state.position, g.final_state.position)


def test_grahmc_run_track_proposals_layout():
    tt = t_funnel(DIM)
    q = torch.from_numpy(_state_np(8)[0])
    res = tg.grahmc_run(torch.Generator().manual_seed(0), tt.log_prob_fn, q,
                        0.1, 6, 0.5, 1.0, num_samples=10, burn_in=3,
                        track_proposals=True,
                        value_and_grad_fn=tt.value_and_grad_fn)
    assert res.samples.shape == (10, CHAINS, DIM)
    info = res.info
    assert info["pre_positions"].shape == (10, CHAINS, DIM)
    assert info["proposal_log_probs"].shape == (10, CHAINS)
    assert info["delta_H"].dtype == torch.float64
    # each step starts where the previous one ended
    assert torch.equal(info["pre_positions"][1:], res.samples[:-1])
    assert res.accept_rate.shape == (CHAINS,)
    assert int(res.info["total_divergences"]) == 0
