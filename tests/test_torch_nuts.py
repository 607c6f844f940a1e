"""Port parity for persistent NUTS: the eager machine against the JAX XLA
machine (`_make_window_step`), kernel 4's plain version against the JAX
Pallas window kernel (interpret mode) at W = 1 and W = 4, both on the JAX
package's own injected draws and from one state carried across with
`interop.nuts_state_from_numpy`; then `nuts_run_persistent`'s contract and
moments.

The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrapper takes its plain version because the
tensors lie on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402
from jax import lax  # noqa: E402

from mcmc_tpu.ops import fused_nuts as jfn  # noqa: E402
from mcmc_tpu.samplers.base import init_chain_state as j_init_chain_state  # noqa: E402
from mcmc_tpu.samplers.nuts_persistent import _init_pstate as j_init_pstate  # noqa: E402
from mcmc_tpu.samplers.nuts_persistent import _make_window_step as j_window_step  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.samplers import nuts_persistent as tn  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402

F32 = jnp.float32
C, N_ITERS, DEPTH = 16, 48, 6
CASES = [("standard_normal", 7, 0.5), ("neals_funnel", 10, 0.2)]

# JAX kernel rows -> the port's field names (R_SUBTREE is 1 << depth there)
_ROWS = {"lp": jfn.R_LP, "lp_prop": jfn.R_LP_PROP, "h0": jfn.R_H0,
         "log_u": jfn.R_LOG_U, "sum_alpha": jfn.R_SUM_ALPHA,
         "n_valid": jfn.R_N_VALID, "n_steps": jfn.R_N_STEPS, "depth": jfn.R_DEPTH,
         "steps_left": jfn.R_STEPS_LEFT, "direction": jfn.R_DIRECTION,
         "diverged": jfn.R_DIVERGED, "needs_start": jfn.R_NEEDS_START,
         "transitions": jfn.R_TRANSITIONS, "divergences": jfn.R_DIVERGENCES,
         "alpha_acc": jfn.R_ALPHA_ACC, "depth_acc": jfn.R_DEPTH_ACC,
         "n_exec": jfn.R_EXEC, "lp_res": jfn.R_LP_RES, "k_res": jfn.R_K_RES}
_DISCRETE = ("transitions", "divergences", "depth", "steps_left", "n_valid",
             "depth_acc", "needs_start", "k_res", "n_steps", "diverged")
_CONTINUOUS = ("q", "q_c", "q_l", "q_r", "q_res", "lp", "lp_res", "alpha_acc")


def _start(family, dim, seed=0):
    """The JAX machine's initial state (_run_both's recipe,
    tests/test_fused_nuts.py) and the window key."""
    jt = j_get_target(family, dim=dim)
    init = (random.normal(random.PRNGKey(seed + 100), (C, dim)) * 0.5).astype(F32)
    s0 = j_init_chain_state(init, jt.log_prob_fn, jt.value_and_grad_fn)
    q0, lp0 = s0.position.astype(F32), jnp.asarray(s0.log_prob, F32)
    return jt, q0, lp0, s0.grad_log_prob.astype(F32), random.PRNGKey(seed)


def _jax_draws(key, dim, n_iters):
    """make_fused_nuts_window's injected draws (interpret mode) for `key`,
    in the XLA machine's xs layout."""
    d_pad = jfn._round_up(dim, jfn.SUBLANE)
    kp, kd, kd2, ks, ku, kr = random.split(key, 6)
    p0 = random.normal(kp, (n_iters, d_pad, C), F32)
    return (jnp.transpose(p0, (0, 2, 1))[:, :, :dim],
            random.bernoulli(kd, 0.5, (n_iters, C)),
            random.bernoulli(kd2, 0.5, (n_iters, C)),
            random.uniform(ks, (n_iters, C), F32),
            random.uniform(ku, (n_iters, C), F32, minval=jnp.finfo(F32).tiny),
            random.uniform(kr, (n_iters, C), F32))


def _port_draws(xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _unpack(ts, dim):
    """A JAX kernel-layout TState as the JAX _PState field names (numpy)."""
    rows = np.asarray(ts.rows)
    out = {f: np.asarray(getattr(ts, f))[:dim].T for f in fn.FULL_FIELDS}
    out.update({name: rows[r] for name, r in _ROWS.items()})
    return out


def _assert_parity(port, jax_fields):
    for name in _DISCRETE:
        np.testing.assert_array_equal(
            getattr(port, name).numpy().astype(np.float64),
            np.asarray(jax_fields[name]).astype(np.float64), err_msg=name)
    for name in _CONTINUOUS:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(jax_fields[name]),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("family,dim,step", CASES)
def test_eager_machine_matches_jax_window_step(family, dim, step):
    """48 iterations of the port's eager machine and the JAX XLA machine on
    the same xs from one carried state: discrete state equal, continuous
    state within 2e-4 (tests/test_fused_nuts.py's _assert_machine_parity)."""
    jt, q0, lp0, g0, key = _start(family, dim)
    xs = _jax_draws(key, dim, N_ITERS)
    inv_mass = jnp.ones(dim, F32)

    def vag_f32(q):
        lp, g = jt.value_and_grad_fn(q)
        return jnp.asarray(lp, F32), g.astype(F32)
    ps0 = j_init_pstate(q0, lp0, g0, F32)
    jstep = j_window_step(vag_f32, jnp.asarray(step, F32), inv_mass, DEPTH, 1000.0, F32)
    ps = lax.scan(jstep, ps0, (xs[0], xs[1], xs[2], xs[3], xs[4], xs[5]))[0]

    s = interop.nuts_state_from_numpy(**{k: np.asarray(v) for k, v in
                                         ps0._asdict().items() if v is not None})
    tt = t_get_target(family, dim=dim)
    tstep = tn._make_window_step(tt.value_and_grad_fn, step, torch.ones(dim),
                                 DEPTH, 1000.0)
    for it_xs in zip(*_port_draws(xs)):
        s = tstep(s, it_xs)
    _assert_parity(s, ps._asdict())
    assert int(s.transitions.sum()) > C
    assert torch.equal(s.n_exec, torch.full((C,), N_ITERS, dtype=torch.int32))


@pytest.mark.parametrize("steps_per_iter", [1, 4])
@pytest.mark.parametrize("family,dim,step", CASES)
def test_plain_window_matches_pallas_kernel(family, dim, step, steps_per_iter):
    """nuts_window_plain == make_fused_nuts_window(interpret=True) at W = 1
    and W = 4 on the JAX window's own injected draws, from one carried
    state: discrete state (executed-leapfrog counts included) equal,
    continuous state within 2e-4."""
    n_iters = N_ITERS // steps_per_iter
    jt, q0, lp0, g0, key = _start(family, dim)
    d_pad = jfn._round_up(dim, jfn.SUBLANE)
    window = jfn.make_fused_nuts_window(jt.value_and_grad_fn, n_iters, DEPTH, C, dim,
                                        interpret=True, steps_per_iter=steps_per_iter)
    ts = window(key, jfn.pack_state(q0, lp0, g0, d_pad), step, jnp.ones(dim, F32))

    ps0 = j_init_pstate(q0, lp0, g0, F32)
    s = interop.nuts_state_from_numpy(**{k: np.asarray(v) for k, v in
                                         ps0._asdict().items() if v is not None})
    info = t_get_target(family, dim=dim).value_and_grad_fn.kernel_info
    out = fn.nuts_window_kernel(info, n_iters, steps_per_iter, DEPTH, s,
                                fn.nuts_scalars(step, 1000.0, "cpu"), torch.ones(dim),
                                draws=_port_draws(_jax_draws(key, dim, n_iters)))
    jax_fields = _unpack(ts, dim)
    _assert_parity(out, jax_fields)
    np.testing.assert_array_equal(out.n_exec.numpy(), jax_fields["n_exec"])
    if steps_per_iter > 1:   # later slots really are masked for some chains
        assert int(out.n_exec.sum()) < N_ITERS * C


def test_window_writes_the_given_state_and_draws_documented_philox():
    """The plain window writes into the state's tensors (cloning fields that
    alias, as _init_pstate's do) and, with a key, draws
    philox_nuts_draws(key, call, it)."""
    t = t_get_target("neals_funnel", dim=6)
    info = t.value_and_grad_fn.kernel_info
    q = t.init_sampler(torch.Generator().manual_seed(0), 24) * 0.4
    lp, g = t.value_and_grad_fn(q)
    scalars = fn.nuts_scalars(0.3, 1000.0, "cpu")
    key = torch.tensor([3, 4], dtype=torch.int32)
    s0 = tn._init_pstate(q, lp, g, torch.float32)
    assert len({t.data_ptr() for t in s0}) == len(s0)
    q_init = s0.q.clone()
    a = fn.nuts_window_kernel(info, 8, 2, 5, s0, scalars, torch.ones(6), key=key, call=5)
    assert a.q.data_ptr() == s0.q.data_ptr() and not torch.equal(a.q, q_init)
    assert torch.equal(q, q_init)                       # the caller's tensor stays
    fresh = tn._init_pstate(q, lp, g, torch.float32)
    out = fn.nuts_window_kernel(info, 1, 1, 5, fresh._replace(q_l=fresh.q), scalars,
                                torch.ones(6), key=key)  # aliasing fields are cloned
    assert out.q_l.data_ptr() != out.q.data_ptr()
    draws = [fn.philox_nuts_draws(key, 5, it, 24, 6, "cpu") for it in range(8)]
    draws = tuple(torch.stack(x) for x in zip(*draws))
    b = fn.nuts_window_kernel(info, 8, 2, 5, tn._init_pstate(q, lp, g, torch.float32),
                              scalars, torch.ones(6), draws=draws)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    z, dirs, dirs2, swap, slc, res = fn.philox_nuts_draws(key, 0, 0, 40000, 3, "cpu")
    for bits in (dirs, dirs2):
        assert abs(float(bits.float().mean()) - 0.5) < 0.01
    for u in (swap, slc, res):
        assert float(u.min()) > 0.0 and abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(torch.corrcoef(torch.stack([swap, slc]))[0, 1])) < 0.03


def test_window_agreement_sorts_chains():
    """window_agreement: a counter that differs splits a chain; an emitted
    field beyond tol marks it off the emitted state; a trajectory field
    beyond tol marks it drifted, NaN in both sides counting as equal; err
    is taken over the chains that agree."""
    t = t_get_target("standard_normal", dim=3)
    q = torch.randn((5, 3), generator=torch.Generator().manual_seed(0))
    lp, g = t.value_and_grad_fn(q)
    a = tn._init_pstate(q, lp, g, torch.float32)
    same, emitted, in_flight, err = fn.window_agreement(a, a)
    assert bool(same.all() & emitted.all() & in_flight.all()) and err == 0.0
    b = tn._PState(*(x.clone() for x in a))
    b.depth[0] += 1
    b.q[1, 2] += 1e-3
    b.lp[3] += 5e-5                          # inside tol: 1e-4 + 1e-4 |lp|
    b.p_c[2, 0] = float("nan")
    a.q_c[4, 1] = b.q_c[4, 1] = float("nan")
    same, emitted, in_flight, err = fn.window_agreement(a, b)
    assert same.tolist() == [False, True, True, True, True]
    assert emitted.tolist() == [True, False, True, True, True]
    assert in_flight.tolist() == [True, True, False, True, True]
    assert err == pytest.approx(5e-5, rel=1e-2)


def _run(backend, **kw):
    t = t_get_target("standard_normal", dim=kw.pop("dim", 4))
    pos = torch.randn((kw.pop("chains", 8), t.dim),
                      generator=torch.Generator().manual_seed(1)) * 0.1
    args = dict(step_size=0.5, num_samples=10, steps_per_sample=8, burn_in_steps=8,
                value_and_grad_fn=t.value_and_grad_fn, backend=backend)
    args.update(kw)
    return tn.nuts_run_persistent(torch.Generator().manual_seed(0), t.log_prob_fn,
                                  pos, **args)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_run_schema_counters_and_determinism(backend):
    """tests/test_fused_nuts.py's schema test on both backends: shapes, info
    keys, every slot accounted, executed leapfrogs never above the slots,
    int32 per chain and int64 totals, and a rerun is identical."""
    res = _run(backend)
    assert res.samples.shape == (10, 8, 4) and res.log_probs.shape == (10, 8)
    for k in ("divergence_count", "total_divergences", "divergence_rate",
              "transitions", "mean_accept_probs", "mean_tree_depth",
              "n_leapfrogs", "n_leapfrogs_per_chain", "n_leapfrog_slots",
              "final_positions"):
        assert k in res.info, k
    slots = (8 + 10 * 8) * 8
    assert int(res.info["n_leapfrog_slots"]) == slots
    n_exec = int(res.info["n_leapfrogs"])
    assert (n_exec == slots) if backend == "eager" else (slots // 4 <= n_exec <= slots)
    assert res.info["n_leapfrogs"].dtype == torch.int64
    assert res.info["transitions"].dtype == torch.int32
    assert res.info["n_leapfrogs_per_chain"].dtype == torch.int32
    assert bool(torch.isfinite(res.samples).all())
    acc = res.info["mean_accept_probs"]
    assert bool(((acc >= 0) & (acc <= 1)).all())
    assert torch.equal(res.final_state.accept_count, res.info["transitions"])
    again = _run(backend)
    assert torch.equal(res.samples, again.samples)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_run_collect_prefix_snapshot_modes_and_burn_in_reset(backend):
    """collect_chains keeps the chain prefix of the full history; "last"
    emits the last completed state; a burn-in resets the transition counters
    (at most one transition per leapfrog of the sampling phase) but not the
    executed-leapfrog count."""
    full = _run(backend, chains=16, burn_in_steps=0, num_samples=6)
    part = _run(backend, chains=16, burn_in_steps=0, num_samples=6, collect_chains=4)
    assert part.samples.shape == (6, 4, 4)
    assert torch.equal(full.samples[:, :4], part.samples)
    assert part.final_state.position.shape == (16, 4)
    assert bool((part.info["transitions"] >= 1).all())

    kw = dict(chains=16, burn_in_steps=0, num_samples=6, steps_per_sample=32)
    last = _run(backend, snapshot_mode="last", **kw)
    assert torch.equal(last.samples[-1], last.final_state.position)
    assert not torch.equal(last.samples, _run(backend, **kw).samples)

    burned = _run(backend, burn_in_steps=64, num_samples=1, steps_per_sample=8)
    assert int(burned.info["transitions"].max()) <= 8
    assert int(burned.info["n_leapfrog_slots"]) == (64 + 8) * 8
    assert int(burned.info["n_leapfrogs"]) > 8 * 8


def test_run_argument_errors():
    t = t_get_target("standard_normal", dim=3)
    pos = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="divisible"):
        _run("fused", dim=3, num_samples=4, steps_per_sample=6, steps_per_iter=4)
    with pytest.raises(ValueError, match="fused"):
        _run("eager", dim=3, steps_per_iter=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run("eager", proposal_scheme="multinomial")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run("fused", inv_mass_matrix=torch.eye(4))
    with pytest.raises(ValueError):
        _run("eager", snapshot_mode="first")
    with pytest.raises(TypeError):
        tn.nuts_run_persistent(torch.Generator(), t.log_prob_fn, pos, 0.4, 2,
                               backend="fused")
    with pytest.raises(TypeError):
        tn.nuts_run_persistent(torch.Generator(), t.log_prob_fn, pos, 0.4, 2,
                               value_and_grad_fn=lambda x: (x.sum(-1), -x),
                               backend="fused")
    assert tn._resolve_backend("auto", t.value_and_grad_fn, "cpu") == "eager"
    assert tn._resolve_backend("auto", t.value_and_grad_fn, "cuda") == "fused"
    assert tn._resolve_backend("auto", None, "cuda") == "eager"
    with pytest.raises(ValueError):
        interop.nuts_state_from_numpy(q=np.zeros((2, 3)))
    with pytest.raises(ValueError):
        interop.nuts_state_from_numpy(q_sub=np.zeros((2, 3)))


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_moments_standard_normal(backend):
    """tests/test_fused_nuts.py::test_pallas_backend_moments on the port:
    5-D standard normal, means within 0.12 and variances within 0.25."""
    res = _run(backend, dim=5, chains=32, step_size=0.4, num_samples=300,
               steps_per_sample=12, burn_in_steps=120)
    flat = res.samples.reshape(-1, 5).numpy()
    assert np.all(np.abs(flat.mean(0)) < 0.12)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.25)
    assert 0.6 < float(res.info["mean_accept_probs"].mean()) <= 1.0
