"""The port's reference-shaped API (mcmc_tpu_torch.compat) against the JAX
package's (mcmc_tpu.compat): the same names, tuple lengths and element
shapes at the same sizes (tests/test_aux.py:11-58), and each tuple equal
bit for bit to the port's native run seeded alike."""

import jax.random as random
import numpy as np
import pytest
import torch

from mcmc_tpu import compat as jcompat
from mcmc_tpu.targets import standard_normal as j_standard_normal
from mcmc_tpu_torch import compat as tcompat
from mcmc_tpu_torch.samplers import grahmc_run, hmc_run, nuts_run, rwmh_run
from mcmc_tpu_torch.targets import standard_normal


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _init(seed, chains, dim):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(chains, dim)))


def _shapes(out):
    """Each element's shape; a chain state's fields' shapes."""
    return [tuple(tuple(f.shape) for f in x) if isinstance(x, tuple) else tuple(x.shape)
            for x in out]


def test_the_same_public_names():
    assert sorted(tcompat.__all__) == sorted(jcompat.__all__)
    for name in tcompat.__all__:
        assert callable(getattr(tcompat, name)) or isinstance(getattr(tcompat, name), dict)
    assert tcompat.rwMH_init is tcompat.rwmh_init and tcompat.rahmc_init is tcompat.grahmc_init
    assert sorted(tcompat.FRICTION_SCHEDULES) == sorted(jcompat.FRICTION_SCHEDULES)


# (function, arguments after (key, log_prob_fn, init), chains, dim, JAX tuple length)
CASES = {
    "rwMH_run": (dict(num_samples=50, scale=1.0, burn_in=10), 4, 4, 4),
    "hmc_run": (dict(step_size=0.3, num_steps=5, num_samples=20), 4, 4, 4),
    "hmc_run_tracked": (dict(step_size=0.3, num_steps=5, num_samples=20,
                             track_proposals=True), 4, 4, 9),
    "nuts_run": (dict(step_size=0.5, num_samples=20), 4, 3, 6),
    "rahmc_run": (dict(step_size=0.3, num_steps=5, gamma=0.5, steepness=1.0,
                       num_samples=20), 4, 4, 4),
    "rahmc_run_tracked": (dict(step_size=0.3, num_steps=5, gamma=0.5, steepness=1.0,
                               num_samples=20, track_proposals=True), 4, 4, 9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tuple_lengths_and_shapes_equal_the_jax_ones(case):
    kwargs, chains, dim, length = CASES[case]
    name = case.replace("_tracked", "")
    j_init = random.normal(random.PRNGKey(0), (chains, dim))
    want = getattr(jcompat, name)(random.PRNGKey(1), j_standard_normal(dim).log_prob_fn,
                                  j_init, **kwargs)
    got = getattr(tcompat, name)(_gen(1), standard_normal(dim).log_prob_fn,
                                 _init(0, chains, dim), **kwargs)
    assert len(want) == len(got) == length
    assert _shapes(got) == _shapes(want)
    assert all(bool(torch.isfinite(x.double()).all()) for x in got[:3])


def test_tracked_tuple_plumbing():
    out = tcompat.hmc_run(_gen(3), standard_normal(4).log_prob_fn, _init(2, 4, 4),
                          step_size=0.3, num_steps=5, num_samples=20, track_proposals=True)
    samples, lps, acc, state, pre_q, pre_lp, prop_q, prop_lp, dh = out
    assert prop_q.shape == (20, 4, 4) and prop_lp.shape == (20, 4)
    assert dh.shape == (20, 4)
    # ESJD plumbing: pre positions at step t+1 equal post positions at step t
    assert torch.equal(pre_q[1:], samples[:-1])
    assert torch.equal(state.position, samples[-1])


def _native(run, *a, **k):
    r = run(*a, **k)
    return r.samples, r.log_probs, r.accept_rate, r.final_state


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _equal(x, y)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("track", [False, True])
def test_rahmc_run_equals_the_native_run(track):
    t = standard_normal(4)
    kw = dict(step_size=0.3, num_steps=5, gamma=0.5, steepness=1.0, num_samples=20)
    got = tcompat.rahmc_run(_gen(7), t.log_prob_fn, _init(6, 4, 4), track_proposals=track, **kw)
    r = grahmc_run(_gen(7), t.log_prob_fn, _init(6, 4, 4), track_proposals=track, **kw)
    want = (r.samples, r.log_probs, r.accept_rate, r.final_state)
    if track:
        want += tuple(r.info[k] for k in ("pre_positions", "pre_log_probs",
                                          "proposal_positions", "proposal_log_probs", "delta_H"))
    _equal(got, want)


@pytest.mark.parametrize("track", [False, True])
def test_hmc_run_equals_the_native_run(track):
    t = standard_normal(4)
    kw = dict(step_size=0.3, num_steps=5, num_samples=20, inv_mass_matrix=torch.full(
        (4,), 0.8, dtype=torch.float64))
    got = tcompat.hmc_run(_gen(9), t.log_prob_fn, _init(8, 4, 4), track_proposals=track, **kw)
    r = hmc_run(_gen(9), t.log_prob_fn, _init(8, 4, 4), track_proposals=track, **kw)
    assert len(got) == (9 if track else 4)
    _equal(got[:4], (r.samples, r.log_probs, r.accept_rate, r.final_state))
    if track:
        assert torch.equal(got[8], r.info["delta_H"]) and got[8].shape == (20, 4)


def test_rwmh_and_nuts_equal_the_native_runs():
    t = standard_normal(3)
    got = tcompat.rwMH_run(_gen(11), t.log_prob_fn, _init(10, 4, 3), num_samples=30, scale=0.8,
                           burn_in=5)
    _equal(got, _native(rwmh_run, _gen(11), t.log_prob_fn, _init(10, 4, 3), num_samples=30,
                        scale=0.8, burn_in=5))
    got = tcompat.nuts_run(_gen(13), t.log_prob_fn, _init(12, 4, 3), step_size=0.5,
                           num_samples=10, max_tree_depth=6)
    r = nuts_run(_gen(13), t.log_prob_fn, _init(12, 4, 3), step_size=0.5, num_samples=10,
                 max_tree_depth=6)
    _equal(got, (r.samples, r.log_probs, r.accept_rate, r.final_state,
                 r.info["tree_depths"], r.info["mean_accept_probs"]))
    assert got[4].shape == (10, 4)


def test_compat_passes_no_value_and_grad_fn():
    """Like the JAX compat, the runs take the eager backend (autograd): a
    log-prob without an analytic gradient samples as the native run."""
    def log_prob(x):
        return -0.5 * torch.sum(x * x, dim=-1)
    got = tcompat.rahmc_run(_gen(15), log_prob, _init(14, 4, 2), 0.2, 4, 0.3, 1.0, 10)
    r = grahmc_run(_gen(15), standard_normal(2).log_prob_fn, _init(14, 4, 2), 0.2, 4, 0.3,
                   1.0, 10, value_and_grad_fn=standard_normal(2).value_and_grad_fn)
    torch.testing.assert_close(got[0], r.samples, rtol=1e-12, atol=1e-12)
