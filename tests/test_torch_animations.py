"""The port's trajectory tracers and animations (mcmc_tpu_torch.animations)
against the JAX package's (mcmc_tpu.animations): the per-substep tracer on
the same numpy q0 and p0 in float64 to 1e-10, the traces' keys and shapes,
the energy checks of tests/test_aux.py:61-82, and the GIFs."""

import jax.numpy as jnp
import jax.random as random
import numpy as np
import pytest
import torch

from mcmc_tpu.animations import animation as janim
from mcmc_tpu.samplers.grahmc import get_friction_schedule as j_schedule
from mcmc_tpu.targets import get_target as j_get_target
from mcmc_tpu_torch.animations import (animate_overlay_comparison, animate_sampler_comparison,
                                       grahmc_proposal_trace, hmc_proposal_trace,
                                       rahmc_proposal_trace)
from mcmc_tpu_torch.animations import animation as tanim
from mcmc_tpu_torch.samplers.grahmc import get_friction_schedule as t_schedule
from mcmc_tpu_torch.targets import get_target, standard_normal

TARGETS = [("gaussian_mixture", 2), ("neals_funnel", 10)]


@pytest.mark.parametrize("schedule", [None, "constant", "tanh"])
@pytest.mark.parametrize("name,dim", TARGETS)
def test_traced_trajectory_matches_the_jax_tracer(name, dim, schedule):
    rng = np.random.default_rng(dim)
    q0 = rng.normal(size=dim) * 0.5
    p0 = rng.normal(size=dim)
    inv_mass = rng.uniform(0.5, 1.5, size=dim)
    step, n_steps, gamma, steep = 0.1, 12, 0.7, 0.5

    j_vag = j_get_target(name, dim=dim).value_and_grad_fn
    lp0, g0 = j_vag(jnp.asarray(q0))
    want = janim._traced_trajectory(
        jnp.asarray(q0), jnp.asarray(p0), lp0, g0, j_vag, step, n_steps, jnp.asarray(inv_mass),
        None if schedule is None else j_schedule(schedule), jnp.asarray(gamma),
        jnp.asarray(steep))

    vag1 = tanim._single_chain(get_target(name, dim=dim).value_and_grad_fn)
    q = torch.from_numpy(q0)
    lp, g = vag1(q)
    got = tanim._traced_trajectory(
        q, torch.from_numpy(p0), lp, g, vag1, step, n_steps, torch.from_numpy(inv_mass),
        None if schedule is None else t_schedule(schedule),
        torch.tensor(gamma, dtype=torch.float64), torch.tensor(steep, dtype=torch.float64))
    for w, x in zip(want, got):
        assert x.dtype == torch.float64 and tuple(x.shape) == tuple(w.shape)
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0, atol=1e-10)


@pytest.mark.parametrize("trace", ["hmc", "rahmc"])
def test_proposal_trace_keys_and_shapes_equal_the_jax_ones(trace):
    jt, tt = j_get_target("neals_funnel", dim=5), get_target("neals_funnel", dim=5)
    q0 = np.linspace(-0.5, 0.5, 5)
    kw = {} if trace == "hmc" else dict(gamma=0.5, schedule_type="tanh")
    want = getattr(janim, f"{trace}_proposal_trace")(
        random.PRNGKey(0), jt.log_prob_fn, jnp.asarray(q0), 0.05, 9,
        value_and_grad_fn=jt.value_and_grad_fn, **kw)
    got = getattr(tanim, f"{trace}_proposal_trace")(
        torch.Generator().manual_seed(0), tt.log_prob_fn, torch.from_numpy(q0), 0.05, 9,
        value_and_grad_fn=tt.value_and_grad_fn, **kw)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert isinstance(got[key], np.ndarray) and got[key].shape == value.shape, key
            assert np.isfinite(got[key]).all()
        else:
            assert got[key] == value
    np.testing.assert_allclose(got["positions"][0], q0)
    np.testing.assert_allclose(got["hamiltonian"], got["potential"] + got["kinetic"])
    assert grahmc_proposal_trace is rahmc_proposal_trace


def test_autograd_trace_equals_the_analytic_one():
    """A log-prob without value_and_grad_fn goes through autograd
    (samplers.base.make_value_and_grad)."""
    t = get_target("neals_funnel", dim=4)
    q0 = torch.tensor([0.3, -0.2, 0.5, 0.1], dtype=torch.float64)
    a = rahmc_proposal_trace(torch.Generator().manual_seed(1), t.log_prob_fn, q0, 0.05, 10,
                             gamma=0.4)
    b = rahmc_proposal_trace(torch.Generator().manual_seed(1), t.log_prob_fn, q0, 0.05, 10,
                             gamma=0.4, value_and_grad_fn=t.value_and_grad_fn)
    for key in ("positions", "momenta", "potential", "kinetic"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-12, atol=1e-12)


def test_hmc_trace_conserves_energy():
    t = standard_normal(2)
    tr = hmc_proposal_trace(torch.Generator().manual_seed(8), t.log_prob_fn,
                            torch.tensor([0.3, -0.7], dtype=torch.float64), 0.05, 30,
                            t.value_and_grad_fn)
    assert tr["positions"].shape == (31, 2)
    H = tr["hamiltonian"]
    assert abs(H[-1] - H[0]) < 0.01  # symplectic: tiny drift at eps=0.05


def test_grahmc_trace_dissipates_then_pumps():
    """Constant-schedule friction: H should NOT be conserved (by design)."""
    t = standard_normal(2)
    tr = rahmc_proposal_trace(torch.Generator().manual_seed(9), t.log_prob_fn,
                              torch.tensor([0.3, -0.7], dtype=torch.float64), 0.05, 30,
                              gamma=2.0, schedule_type="constant",
                              value_and_grad_fn=t.value_and_grad_fn)
    H = tr["hamiltonian"]
    assert np.all(np.isfinite(H))
    assert abs(H[15] - H[0]) > 0.05  # repelling phase pumps energy


def test_overlay_animation_renders(tmp_path):
    out = str(tmp_path / "overlay.gif")
    fig, anim = animate_overlay_comparison(num_steps=8, output_path=out)
    assert (tmp_path / "overlay.gif").stat().st_size > 1000
    assert fig is not None and anim is not None


def test_side_by_side_animation_renders(tmp_path):
    out = str(tmp_path / "side.gif")
    assert animate_sampler_comparison(num_steps=5, n_proposals=2, output_file=out) == out
    assert (tmp_path / "side.gif").stat().st_size > 1000
