"""Port parity for persistent NUTS's multinomial scheme (kernel 4a): the
eager machine against the JAX XLA machine (`_make_window_step(
proposal_scheme="multinomial")`) in float64, kernel 4's plain version
against the JAX Pallas window in interpret mode at W = 1 and 4, the Philox
leaf-uniform layout, and the scheme's point on the run: it removes the
endpoint scheme's underdispersion on the 4-D standard normal.

The CUDA kernel runs only on a GPU (tests/test_torch_cuda.py, chip_smoke.py);
here the wrapper takes its plain version because the tensors lie on the
CPU."""

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
from mcmc_tpu_torch.ops.fused_trajectory import (  # noqa: E402
    _bits_to_uniform, kernel_metric, philox4x32_10)
from mcmc_tpu_torch.samplers import nuts_persistent as tn  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402

F32 = jnp.float32
C, N_ITERS, DEPTH = 16, 48, 6

# JAX kernel rows -> the port's field names
ROWS = {"lp": jfn.R_LP, "lp_prop": jfn.R_LP_PROP, "h0": jfn.R_H0,
        "log_u": jfn.R_LOG_U, "sum_alpha": jfn.R_SUM_ALPHA,
        "n_valid": jfn.R_N_VALID, "n_steps": jfn.R_N_STEPS, "depth": jfn.R_DEPTH,
        "steps_left": jfn.R_STEPS_LEFT, "direction": jfn.R_DIRECTION,
        "diverged": jfn.R_DIVERGED, "needs_start": jfn.R_NEEDS_START,
        "transitions": jfn.R_TRANSITIONS, "divergences": jfn.R_DIVERGENCES,
        "alpha_acc": jfn.R_ALPHA_ACC, "depth_acc": jfn.R_DEPTH_ACC,
        "n_exec": jfn.R_EXEC, "lp_res": jfn.R_LP_RES, "k_res": jfn.R_K_RES}
MULTI_ROWS = {"lp_sub": jfn.R_LP_SUB, "lw_tree": jfn.R_LW_TREE,
              "lw_sub": jfn.R_LW_SUB, "div_sub": jfn.R_DIV_SUB,
              "turn_sub": jfn.R_TURN_SUB}
DISCRETE = fn.INT_FIELDS + fn.BOOL_FIELDS + fn.MULTI_BOOL_FIELDS


def random_metric(dim):
    """test_fused_nuts.py's dense metric: a @ a.T / D + 0.5 I, float32."""
    a = np.random.default_rng(0).normal(size=(dim, dim)).astype(np.float32)
    return (a @ a.T / dim + 0.5 * np.eye(dim)).astype(np.float32)


def jax_start(family, dim, seed=0):
    """test_fused_nuts.py::_run_both's initial state (float32) and key."""
    jt = j_get_target(family, dim=dim)
    init = (random.normal(random.PRNGKey(seed + 100), (C, dim)) * 0.5).astype(F32)
    s0 = j_init_chain_state(init, jt.log_prob_fn, jt.value_and_grad_fn)
    return (jt, s0.position.astype(F32), jnp.asarray(s0.log_prob, F32),
            s0.grad_log_prob.astype(F32), random.PRNGKey(seed))


def jax_window_draws(key, dim, n_iters, slots, multinomial):
    """The Pallas window's injected draws for `key`, in the port's layout:
    slice (n_iters * W, C) under the multinomial scheme."""
    d_pad = jfn._round_up(dim, jfn.SUBLANE)
    kp, kd, kd2, ks, ku, kr = random.split(key, 6)
    p0 = random.normal(kp, (n_iters, d_pad, C), F32)
    n_slice = n_iters * slots if multinomial else n_iters
    draws = (jnp.transpose(p0, (0, 2, 1))[:, :, :dim],
             random.bernoulli(kd, 0.5, (n_iters, C)),
             random.bernoulli(kd2, 0.5, (n_iters, C)),
             random.uniform(ks, (n_iters, C), F32),
             random.uniform(ku, (n_slice, C), F32, minval=jnp.finfo(F32).tiny),
             random.uniform(kr, (n_iters, C), F32))
    return tuple(torch.from_numpy(np.array(x)) for x in draws)


def unpack(ts, dim, multinomial, depth):
    """A JAX kernel-layout TState as the port's field names (numpy)."""
    rows = np.asarray(ts.rows)
    full = fn.FULL_FIELDS + (fn.MULTI_FULL_FIELDS if multinomial else ())
    out = {f: np.asarray(getattr(ts, f))[:dim].T for f in full}
    out.update({name: rows[r] for name, r in ROWS.items()})
    if multinomial:
        out.update({name: rows[r] for name, r in MULTI_ROWS.items()})
        d_pad = jfn._round_up(dim, jfn.SUBLANE)
        for f in fn.STACK_FIELDS:
            stk = np.asarray(getattr(ts, f)).reshape(depth, d_pad, C)[:, :dim]
            out[f] = np.transpose(stk, (2, 0, 1))
    return out


def assert_state_close(port, theirs, tol):
    """Discrete state equal; continuous fields within tol (rtol and atol),
    infinities where the other side has them."""
    for name, want in theirs.items():
        if want is None:
            continue
        got = getattr(port, name).numpy().astype(np.float64)
        want = np.asarray(want).astype(np.float64)
        if name in DISCRETE:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def run_pallas_and_plain(family, dim, step, slots, inv_mass, multinomial):
    """The Pallas window (interpret mode) and kernel 4's plain version on
    the Pallas window's own injected draws from one carried state."""
    n_iters = N_ITERS // slots
    scheme = "multinomial" if multinomial else "endpoint"
    jt, q0, lp0, g0, key = jax_start(family, dim)
    dense = inv_mass.ndim == 2
    window = jfn.make_fused_nuts_window(
        jt.value_and_grad_fn, n_iters, DEPTH, C, dim, interpret=True,
        steps_per_iter=slots, dense=dense, proposal_scheme=scheme)
    d_pad = jfn._round_up(dim, jfn.SUBLANE)
    ts = window(key, jfn.pack_state(q0, lp0, g0, d_pad, multinomial=multinomial,
                                    max_tree_depth=DEPTH), step, jnp.asarray(inv_mass))
    ps0 = j_init_pstate(q0, lp0, g0, F32, multinomial=multinomial,
                        max_tree_depth=DEPTH)
    s = interop.nuts_state_from_numpy(device="cpu", **{
        k: np.asarray(v) for k, v in ps0._asdict().items() if v is not None})
    info = t_get_target(family, dim=dim).value_and_grad_fn.kernel_info
    im, l_inv = kernel_metric(torch.from_numpy(inv_mass))
    out = fn.nuts_window_kernel(info, n_iters, slots, DEPTH, s,
                                fn.nuts_scalars(step, 1000.0, "cpu"), im,
                                draws=jax_window_draws(key, dim, n_iters, slots,
                                                       multinomial),
                                l_inv=l_inv)
    return out, unpack(ts, dim, multinomial, DEPTH)


def run_eager_against_jax(family, dim, step, inv_mass, scheme):
    """48 iterations of the port's eager machine and the JAX XLA machine in
    float64 on the same xs from one carried state."""
    multinomial = scheme == "multinomial"
    jt = j_get_target(family, dim=dim)
    init = random.normal(random.PRNGKey(100), (C, dim)) * 0.5
    lp0, g0 = jt.value_and_grad_fn(init)
    kp, kd, kd2, ks, ku, kr = random.split(random.PRNGKey(3), 6)
    xs = (random.normal(kp, (N_ITERS, C, dim)), random.bernoulli(kd, 0.5, (N_ITERS, C)),
          random.bernoulli(kd2, 0.5, (N_ITERS, C)), random.uniform(ks, (N_ITERS, C)),
          random.uniform(ku, (N_ITERS, C), minval=jnp.finfo(F32).tiny),
          random.uniform(kr, (N_ITERS, C)))
    ps0 = j_init_pstate(init, lp0, g0, jnp.float64, multinomial=multinomial,
                        max_tree_depth=DEPTH)
    jstep = j_window_step(jt.value_and_grad_fn, step, jnp.asarray(inv_mass), DEPTH,
                          1000.0, jnp.float64, proposal_scheme=scheme)
    ps = lax.scan(jstep, ps0, xs)[0]

    s = interop.nuts_state_from_numpy(device="cpu", **{
        k: np.asarray(v) for k, v in ps0._asdict().items() if v is not None})
    tstep = tn._make_window_step(t_get_target(family, dim=dim).value_and_grad_fn, step,
                                 torch.from_numpy(np.asarray(inv_mass, np.float64)),
                                 DEPTH, 1000.0, scheme)
    for it_xs in zip(*(torch.from_numpy(np.array(x)) for x in xs)):
        s = tstep(s, it_xs)
    return s, ps._asdict()


@pytest.mark.parametrize("family,dim,step,dense", [
    ("standard_normal", 7, 0.5, False), ("neals_funnel", 10, 0.2, False),
    ("correlated_gaussian", 6, 0.3, True)])
def test_eager_multinomial_machine_matches_jax_window_step(family, dim, step, dense):
    """The eager multinomial machine against JAX _make_window_step(
    proposal_scheme="multinomial") on injected xs, float64: every field,
    reservoir, log weights and checkpoint stacks included, to 1e-10; on a
    diagonal metric and on a dense one."""
    inv_mass = random_metric(dim).astype(np.float64) if dense else np.ones(dim)
    s, theirs = run_eager_against_jax(family, dim, step, inv_mass, "multinomial")
    assert_state_close(s, theirs, 1e-10)
    assert int(s.transitions.sum()) > C
    assert s.q_stk.abs().sum() > 0 and bool(torch.isfinite(s.lw_tree).all())


@pytest.mark.parametrize("family,dim,step,slots", [
    ("standard_normal", 7, 0.5, 1), ("neals_funnel", 10, 0.2, 4)])
def test_plain_window_multinomial_matches_pallas_kernel(family, dim, step, slots):
    """Kernel 4a's plain version against make_fused_nuts_window(interpret=
    True, proposal_scheme="multinomial") at tests/test_fused_nuts.py's
    shapes, W = 1 and 4, on the JAX window's own injected draws (one slice
    uniform per slot): discrete state equal, continuous state -- reservoir,
    log weights and checkpoint stacks included -- within 2e-4. The JAX
    window's unpacked multinomial TState carries across through interop."""
    out, theirs = run_pallas_and_plain(family, dim, step, slots,
                                       np.ones(dim, np.float32), True)
    assert_state_close(out, theirs, 2e-4)
    carried = interop.nuts_state_from_numpy(device="cpu", **theirs)
    assert carried.q_stk.shape == (C, DEPTH, dim) and carried.div_sub.dtype == torch.bool
    assert_state_close(carried, theirs, 0.0)
    assert int(out.transitions.sum()) > C
    if slots > 1:   # later slots really are masked for some chains
        assert int(out.n_exec.sum()) < N_ITERS * C


def test_philox_leaf_uniforms_and_window_draws():
    """Slot k's leaf uniform is word k % 4 of Philox draw SLICE_DRAW + k // 4;
    the plain window with a key equals the plain window fed those draws."""
    key = torch.tensor([11, -12], dtype=torch.int32)
    u = fn.philox_slice_uniforms(key, 3, 2, 5, 6, "cpu")
    assert u.shape == (6, 5)
    chains = torch.arange(5, dtype=torch.int64)
    for k in range(6):
        words = philox4x32_10(chains, torch.tensor(3), torch.tensor(2),
                              torch.tensor(fn.SLICE_DRAW + k // 4), torch.tensor(11),
                              torch.tensor(-12 & 0xFFFFFFFF))
        assert torch.equal(u[k], _bits_to_uniform(words[k % 4]))
    big = fn.philox_slice_uniforms(key, 0, 0, 20000, 4, "cpu")
    assert float(big.min()) > 0.0 and abs(float(big.mean()) - 0.5) < 0.01

    t = t_get_target("neals_funnel", dim=6)
    info = t.value_and_grad_fn.kernel_info
    q = t.init_sampler(torch.Generator().manual_seed(0), 24) * 0.4
    lp, g = t.value_and_grad_fn(q)
    scalars = fn.nuts_scalars(0.3, 1000.0, "cpu")
    ones = torch.ones(6)

    def start():
        return tn._init_pstate(q, lp, g, torch.float32, multinomial=True,
                               max_tree_depth=5)
    a = fn.nuts_window_kernel(info, 8, 3, 5, start(), scalars, ones, key=key, call=5)
    draws = [fn.philox_nuts_draws(key, 5, it, 24, 6, "cpu", slots=3) for it in range(8)]
    draws = tuple(torch.cat(x) if i == 4 else torch.stack(x)
                  for i, x in enumerate(zip(*draws)))
    assert draws[4].shape == (24, 24)
    b = fn.nuts_window_kernel(info, 8, 3, 5, start(), scalars, ones, draws=draws)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.transitions.sum()) > 0


def test_window_agreement_reads_the_multinomial_fields():
    """A differing subtree flag splits a chain; a reservoir, log weight or
    checkpoint-stack entry beyond tol marks its trajectory in flight."""
    t = t_get_target("standard_normal", dim=3)
    q = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    lp, g = t.value_and_grad_fn(q)
    a = tn._init_pstate(q, lp, g, torch.float32, multinomial=True, max_tree_depth=4)
    b = tn._PState(*(x.clone() for x in a))
    b.turn_sub[0] = True
    b.q_stk[1, 3, 2] += 1e-2
    b.lw_sub[2] = -torch.inf
    same, emitted, in_flight, _ = fn.window_agreement(a, b)
    assert same.tolist() == [False, True, True, True]
    assert emitted.all()
    assert in_flight.tolist() == [True, False, False, True]


def test_multinomial_recovers_exact_variance():
    """tests/test_nuts_persistent.py::test_multinomial_scheme_recovers_exact_
    variance on the port, both backends: on the 4-D standard normal the
    multinomial scheme's marginal variance lies within 0.03 of 1, above the
    endpoint scheme's (~0.96)."""
    t = t_get_target("standard_normal", dim=4)
    init = torch.randn((1024, 4), generator=torch.Generator().manual_seed(5)) * 0.3
    out = {}
    for scheme, backend in (("endpoint", "eager"), ("multinomial", "eager"),
                            ("multinomial", "fused")):
        r = tn.nuts_run_persistent(
            torch.Generator().manual_seed(7), t.log_prob_fn, init, step_size=0.5,
            num_samples=60, steps_per_sample=64, burn_in_steps=256, max_tree_depth=8,
            value_and_grad_fn=t.value_and_grad_fn, proposal_scheme=scheme,
            backend=backend)
        assert bool(torch.isfinite(r.samples).all())
        out[scheme, backend] = float(r.samples.reshape(-1, 4).var(0).mean())
    for backend in ("eager", "fused"):
        assert 0.97 < out["multinomial", backend] < 1.03, out
        assert out["endpoint", "eager"] < out["multinomial", backend], out


def test_multinomial_fused_run_counters_and_determinism():
    """tests/test_fused_nuts.py::test_multinomial_steps_per_iter_unroll on
    the port: W = 4, every slot accounted, executed leapfrogs between a
    quarter of the slots and all of them, moments sane, a rerun identical."""
    t = t_get_target("standard_normal", dim=5)
    pos = torch.randn((32, 5), generator=torch.Generator().manual_seed(1)) * 0.1
    kw = dict(step_size=0.4, num_samples=48, steps_per_sample=16, burn_in_steps=32,
              value_and_grad_fn=t.value_and_grad_fn, backend="fused",
              proposal_scheme="multinomial", steps_per_iter=4)
    res = tn.nuts_run_persistent(torch.Generator().manual_seed(0), t.log_prob_fn, pos, **kw)
    slots = (32 + 48 * 16) * 32
    assert int(res.info["n_leapfrog_slots"]) == slots
    assert slots // 4 <= int(res.info["n_leapfrogs"]) <= slots
    assert bool((res.info["transitions"] >= 1).all())
    flat = res.samples.reshape(-1, 5)
    assert bool(torch.isfinite(flat).all())
    assert bool((flat.mean(0).abs() < 0.2).all())
    assert bool(((flat.var(0) - 1.0).abs() < 0.35).all())
    again = tn.nuts_run_persistent(torch.Generator().manual_seed(0), t.log_prob_fn, pos, **kw)
    assert torch.equal(res.samples, again.samples)
