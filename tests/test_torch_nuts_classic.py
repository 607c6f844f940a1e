"""Port parity for classic NUTS (`samplers/nuts.py`): `_u_turn`,
`_integrate_subtree` and one `_nuts_chain_step` against the JAX package's
(vmapped over chains) on the JAX function's own draws, replayed from
`jax.random` on the same key splits and injected, to float64 tolerance;
then `nuts_run` statistically against the JAX package on
`standard_normal`, and its contract (live-mask loop, one host read per
depth, the run's info)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.samplers import nuts as jn  # noqa: E402
from mcmc_tpu.samplers.trajectory import sample_momentum as j_sample_momentum  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch.samplers import nuts as tn  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402

C = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _start(family, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, dim)) * 0.5
    if family == "rosenbrock":
        x = 1.0 + 0.1 * rng.standard_normal((C, dim))
    jt, tt = j_get_target(family, dim=dim), t_get_target(family, dim=dim)
    lp, g = jt.value_and_grad_fn(jnp.asarray(x))
    return jt, tt, x, np.asarray(lp), np.asarray(g)


def test_u_turn_matches_jax():
    rng = np.random.default_rng(0)
    args = [rng.standard_normal((64, 5)) for _ in range(4)]
    ours = tn._u_turn(*(_t(a) for a in args))
    theirs = jax.vmap(lambda a, b, c, d: jn._u_turn(a, b, c, d, jnp.ones(5)))(
        *(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert 0 < int(ours.sum()) < 64


@pytest.mark.parametrize("dense", [False, True])
def test_integrate_subtree_matches_jax(dense):
    """2^3 leapfrogs in each chain's direction, the sum of alpha: f64, 1e-12."""
    jt, tt, x, lp, g = _start("neals_funnel", 5, 1)
    rng = np.random.default_rng(2)
    p = rng.standard_normal((C, 5))
    direction = np.where(rng.uniform(size=C) < 0.5, 1.0, -1.0)
    h0 = rng.standard_normal(C) + 10.0
    a = rng.standard_normal((5, 5))
    inv_mass = a @ a.T / 5 + np.eye(5) if dense else rng.uniform(0.5, 1.5, 5)
    theirs = jax.vmap(lambda q, p, g, d, h: jn._integrate_subtree(
        q, p, g, d, 0.1, 8, jt.value_and_grad_fn, h, jnp.asarray(inv_mass)))(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(g), jnp.asarray(direction),
        jnp.asarray(h0))
    ours = tn._integrate_subtree(_t(x), _t(p), _t(g), _t(direction), 0.1, 8,
                                 tt.value_and_grad_fn, _t(h0), _t(inv_mass))
    for a_, b_ in zip(ours, theirs):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), rtol=1e-12, atol=1e-12)


def _replayed_draws(key, q, inv_mass, max_depth):
    """The JAX transition's draws for every chain (nuts_step's key split,
    then _nuts_chain_step's: momentum and slice, and per depth the
    direction bit and the swap uniform) as NUTSDraws."""
    keys = random.split(key, C + 1)[1:]
    p0, slc, dirs, swaps = [], [], [], []
    for k in keys:
        k, k_mom, k_slice = random.split(k, 3)
        p0.append(j_sample_momentum(k_mom, q.shape[1:], inv_mass, q.dtype))
        slc.append(random.uniform(k_slice, dtype=jnp.float64))
        d_row, s_row = [], []
        for _ in range(max_depth):
            k, k_dir, k_swap = random.split(k, 3)
            d_row.append(random.bernoulli(k_dir))
            s_row.append(random.uniform(k_swap))
        dirs.append(d_row)
        swaps.append(s_row)
    return tn.NUTSDraws(_t(jnp.stack(p0)), _t(jnp.stack(slc)), _t(np.array(dirs).T),
                        _t(np.array(swaps).T))


@pytest.mark.parametrize("family,dim,step,dense", [
    ("standard_normal", 5, 0.4, False), ("neals_funnel", 6, 0.2, False),
    ("rosenbrock", 5, 0.02, False), ("standard_normal", 4, 0.5, True)])
def test_chain_step_on_the_jax_draws(family, dim, step, dense):
    """One transition of C chains, the port's batched live-mask loop on the
    JAX function's replayed draws against the vmapped JAX function: the
    proposal, its lp and gradient, the tree depth, the mean alpha and the
    divergence flag, float64 to 1e-12."""
    jt, tt, x, lp, g = _start(family, dim, 3)
    depth = 8
    a = np.random.default_rng(4).standard_normal((dim, dim))
    inv_mass = jnp.asarray(a @ a.T / dim + np.eye(dim) if dense
                           else np.random.default_rng(4).uniform(0.5, 1.5, dim))
    key = random.PRNGKey(11)
    keys = random.split(key, C + 1)[1:]
    theirs = jax.vmap(lambda k, q, l, gr: jn._nuts_chain_step(
        k, q, l, gr, jt.value_and_grad_fn, step, depth, 1000.0, inv_mass))(
        keys, jnp.asarray(x), jnp.asarray(lp), jnp.asarray(g))
    draws = _replayed_draws(key, jnp.asarray(x), inv_mass, depth)
    ours = tn._nuts_chain_step(draws, _t(x), _t(lp), _t(g), tt.value_and_grad_fn, step, depth,
                               1000.0, _t(inv_mass))
    names = ("q", "lp", "grad", "depth", "mean_alpha", "diverged")
    for name, a_, b_ in zip(names, ours, theirs):
        np.testing.assert_allclose(a_.numpy().astype(np.float64),
                                   np.asarray(b_).astype(np.float64), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    assert len(set(ours[3].tolist())) > 1 or family == "standard_normal"


def test_nuts_step_contract_and_host_reads(monkeypatch):
    """nuts_step advances every chain (accept_count + 1), counts
    divergences, returns (depths, mean alpha); the depth loop reads one
    bool per depth on the host and runs 2^d leapfrogs at depth d, not one
    host read per leapfrog."""
    tt = t_get_target("standard_normal", dim=3)
    x = torch.randn(16, 3, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    from mcmc_tpu_torch.samplers.base import init_chain_state
    state = init_chain_state(x, tt.log_prob_fn, tt.value_and_grad_fn)
    reads, calls = [], []
    real_any = torch.Tensor.any

    def counted_any(self, *a, **k):
        reads.append(1)
        return real_any(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "any", counted_any)

    def vag(q):
        calls.append(1)
        return tt.value_and_grad_fn(q)
    new, (depths, alpha) = tn.nuts_step(torch.Generator().manual_seed(1), state, vag, 0.3,
                                        torch.ones(3, dtype=torch.float64), max_tree_depth=6)
    monkeypatch.undo()
    d = int(depths.max())
    assert len(calls) == 2 ** d - 1 and len(reads) == min(d, 5), (d, len(calls), len(reads))
    assert (new.accept_count == 1).all() and new.divergence_count.sum() == 0
    assert alpha.shape == (16,) and bool(((alpha > 0) & (alpha <= 1)).all())
    assert new.position.dtype == torch.float64 and depths.dtype == torch.int32


def test_nuts_run_matches_jax_statistically():
    """nuts_run on the 4-D standard normal, 64 chains x 400 draws from a
    warm start at step 0.6: the port's and the JAX package's draws both
    have mean 0 and variance 1 within 5 standard errors, and their mean
    tree depths agree within 0.25; info carries the JAX keys and shapes."""
    dim, n, draws = 4, 64, 400
    x0 = np.random.default_rng(5).standard_normal((n, dim))
    jt = j_get_target("standard_normal", dim=dim)
    jres = jn.nuts_run(random.PRNGKey(0), jt.log_prob_fn, jnp.asarray(x0), 0.6, draws,
                       value_and_grad_fn=jt.value_and_grad_fn)
    tt = t_get_target("standard_normal", dim=dim)
    res = tn.nuts_run(torch.Generator().manual_seed(0), tt.log_prob_fn, _t(x0), 0.6, draws,
                      value_and_grad_fn=tt.value_and_grad_fn, collect_chains=32)
    assert res.samples.shape == (draws, 32, dim)
    assert res.info["tree_depths"].shape == (draws, n)
    assert res.info["mean_accept_probs"].shape == (draws, n)
    assert float(res.accept_rate.mean()) == 1.0
    for samples in (res.samples.double(), torch.from_numpy(np.array(jres.samples))):
        flat = samples.reshape(-1, dim)
        se = 1.0 / flat.shape[0] ** 0.5 * 3      # draws are autocorrelated: a 3x margin
        assert float(flat.mean(0).abs().max()) < 5 * se
        assert float((flat.var(0) - 1.0).abs().max()) < 5 * se * 2 ** 0.5
    depth_t = float(res.info["tree_depths"].double().mean())
    depth_j = float(np.asarray(jres.info["tree_depths"]).mean())
    assert abs(depth_t - depth_j) < 0.25, (depth_t, depth_j)
