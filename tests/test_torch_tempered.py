"""Port parity for parallel tempering: kernel 1b's plain version against the
JAX package's scaled Pallas kernel (interpret mode, injected draws), the
one-launch rung table against per-rung calls, beta = 1 against kernel 1,
the per-chain step row of the eager integrator, the swap phase against a
numpy transcription of the JAX one on injected uniforms, and tempered_run
(eager and fused) against the JAX package's runs and statistical checks.

The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrappers take their plain versions because the
tensors lie on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.ops.padded_targets import _mask_row, make_padded_vag  # noqa: E402
from mcmc_tpu.samplers import geometric_ladder as j_ladder  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.samplers import tempered_run as j_tempered_run  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch.ops import _cuda  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import base as tbase  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers import tempered as tt  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_scaled_step(value_and_grad_fn, num_steps, schedule, q, lp, grad, p0, u, eps,
                    gamma, steep, beta, inv_mass, layout="lanes"):
    """One transition of the JAX package's scaled Pallas kernel (interpret
    mode, injected draws), built through _build_call as
    make_fused_grahmc_step builds it with lp_scale (its debug hook has no
    lp_scale)."""
    n, dim = q.shape
    ax = 1 if layout == "lanes" else 0
    d_pad = jft._round_up(dim, jft.LANE if ax == 1 else jft.SUBLANE)
    dense = np.ndim(inv_mass) == 2
    call = jft._build_call(make_padded_vag(value_and_grad_fn, d_pad, ax), num_steps,
                           schedule, n, d_pad, n, inject_randoms=True, interpret=True,
                           dim_axis=ax, dense=dense, scaled=True)
    pad = ((0, 0), (0, d_pad - dim))
    qp, gp, pp = (jnp.pad(jnp.asarray(a, jnp.float32), pad) for a in (q, grad, p0))
    lpp, up = (jnp.asarray(a, jnp.float32)[:, None] for a in (lp, u))
    if dense:
        invm = jft._pad_dense_block(jnp.asarray(inv_mass), dim, d_pad)
    else:
        invm = jnp.pad(jnp.asarray(inv_mass, jnp.float32), (0, d_pad - dim),
                       constant_values=1.0)[None, :]
    mask = _mask_row(dim, d_pad, dim_axis=1)
    if ax == 0:
        qp, gp, pp, lpp, up, mask = qp.T, gp.T, pp.T, lpp.T, up.T, mask.T
        if not dense:
            invm = invm.T
    scalars = jnp.asarray([eps, gamma, steep, beta], jnp.float32)
    q1, lp1, g1, acc, dh, _, _ = call(jnp.zeros((2,), jnp.int32), scalars, qp, lpp, gp,
                                      invm, mask, pp, up)
    if ax == 0:
        q1, lp1, g1, acc, dh = q1.T, lp1.T, g1.T, acc.T, dh.T
    return (np.asarray(q1)[:, :dim], np.asarray(lp1)[:, 0], np.asarray(g1)[:, :dim],
            np.asarray(acc)[:, 0] > 0.5, np.asarray(dh)[:, 0])


def _inputs(family, dim, n, beta, seed):
    """float32 numpy (q, tempered lp and grad, p0, u) for a family."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((n, dim)) * 0.8).astype(np.float32)
    if family == "gaussian_mixture":
        q[:, 0] += np.where(rng.uniform(size=n) < 0.5, -2.5, 2.5).astype(np.float32)
    lp, grad = j_get_target(family, dim=dim).value_and_grad_fn(jnp.asarray(q))
    lp = (beta * np.asarray(lp, np.float32)).astype(np.float32)
    grad = (beta * np.asarray(grad, np.float32)).astype(np.float32)
    p0 = rng.standard_normal((n, dim)).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    return q, lp, grad, p0, u


@pytest.mark.parametrize("layout", ["lanes", "transposed"])
@pytest.mark.parametrize("family,schedule,beta", [
    ("gaussian_mixture", "tanh", 0.3), ("gaussian_mixture", None, 0.05),
    ("neals_funnel", "constant", 0.6), ("standard_normal", "sine", 0.1)])
def test_scaled_plain_matches_jax_scaled_kernel(family, schedule, beta, layout):
    """Kernel 1b's plain version at K = 1 == the JAX package's scaled Pallas
    kernel in interpret mode on injected momentum and uniforms: accepts
    equal, q, lp and grad within 2e-4, delta H within 2e-3 (the tolerances
    of kernel 1's parity test against the Pallas kernel)."""
    dim, n, L = 6, 16, 8
    eps, gamma, steep = (0.05 if family == "neals_funnel" else 0.3), 0.1, 5.0
    q, lp, grad, p0, u = _inputs(family, dim, n, beta, 3)
    inv_mass = np.linspace(0.7, 1.3, dim).astype(np.float32)
    jsched = jg.get_friction_schedule(schedule) if schedule else None
    outs_j = jax_scaled_step(j_get_target(family, dim=dim).value_and_grad_fn, L, jsched, q,
                             lp, grad, p0, u, eps, gamma, steep, beta, inv_mass, layout)
    tsched = tg.get_friction_schedule(schedule) if schedule else None
    run = ft.make_debug_trajectory(t_get_target(family, dim=dim).value_and_grad_fn, L,
                                   tsched, n, dim)
    outs_t = run(*(_t(a) for a in (q, lp, grad, p0, u)), eps, gamma, steep, _t(inv_mass),
                 lp_scale=beta)
    np.testing.assert_array_equal(outs_t[3].numpy(), outs_j[3])
    for ours, theirs in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs_t[4].numpy(), outs_j[4], rtol=2e-3, atol=2e-3)


def test_scaled_dense_plain_matches_jax_scaled_dense_kernel():
    """The same with a dense metric (scaled + dense in the JAX kernel)."""
    dim, n, L, beta = 5, 8, 6, 0.4
    q, lp, grad, p0, u = _inputs("gaussian_mixture", dim, n, beta, 4)
    a = np.random.default_rng(5).standard_normal((dim, dim))
    invm = (a @ a.T / dim + 0.5 * np.eye(dim)).astype(np.float32)
    outs_j = jax_scaled_step(j_get_target("gaussian_mixture", dim=dim).value_and_grad_fn, L,
                             jg.tanh_schedule, q, lp, grad, p0, u, 0.2, 0.1, 5.0, beta, invm)
    run = ft.make_debug_trajectory(t_get_target("gaussian_mixture", dim=dim).value_and_grad_fn,
                                   L, tg.tanh_schedule, n, dim)
    outs_t = run(*(_t(x) for x in (q, lp, grad, p0, u)), 0.2, 0.1, 5.0, _t(invm),
                 lp_scale=beta)
    np.testing.assert_array_equal(outs_t[3].numpy(), outs_j[3])
    for ours, theirs in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dense", [False, True])
def test_rung_table_equals_per_rung_calls(dense):
    """1b over K rungs in one call == K one-rung calls on the replica slices
    (injected draws), bit for bit: each row reads its own rung's scalars."""
    dim, chains, betas = 7, 6, [1.0, 0.4, 0.1]
    n = chains * len(betas)
    t = t_get_target("gaussian_mixture", dim=dim)
    info = t.value_and_grad_fn.kernel_info
    g = torch.Generator().manual_seed(0)
    q = t.init_sampler(g, n)
    beta_row = torch.tensor(betas).repeat_interleave(chains)
    lp, grad = t.value_and_grad_fn(q)
    lp, grad = beta_row * lp, beta_row[:, None] * grad
    p0, u = torch.randn((n, dim), generator=g), torch.rand(n, generator=g)
    invm, l_inv = ft.kernel_metric(t.true_cov.float() if dense else torch.ones(dim))
    steps = torch.tensor([0.3, 0.45, 0.8])
    whole = ft.grahmc_scaled_kernel(info, 8, 2, q, lp, grad,
                                    ft.rung_table(steps, 0.1, 5.0, torch.tensor(betas), "cpu"),
                                    invm, p0=p0, u=u, l_inv=l_inv)
    for k in range(len(betas)):
        sl = slice(k * chains, (k + 1) * chains)
        part = ft.grahmc_scaled_kernel(
            info, 8, 2, q[sl].contiguous(), lp[sl].contiguous(), grad[sl].contiguous(),
            ft.rung_table(steps[k], 0.1, 5.0, betas[k], "cpu"), invm, p0=p0[sl].contiguous(),
            u=u[sl].contiguous(), l_inv=l_inv)
        for a, b in zip(whole, part):
            assert torch.equal(a[sl], b)


@pytest.mark.parametrize("dense", [False, True])
def test_variants_at_beta_one_equal_kernel_1_plain(dense):
    """At beta = 1 the scaled (one rung) and bridged plain versions give
    kernel 1's plain version bit for bit, injected and Philox (the JAX
    package's test_bridge_beta_one_equals_plain_kernel)."""
    dim, n = 6, 12
    t = t_get_target("gaussian_mixture", dim=dim)
    info = t.value_and_grad_fn.kernel_info
    g = torch.Generator().manual_seed(1)
    q = t.init_sampler(g, n)
    lp, grad = t.value_and_grad_fn(q)
    invm, l_inv = ft.kernel_metric(t.true_cov.float() if dense else torch.ones(dim))
    base = ft.bridge_base(0.5, 3.0, dim, "cpu")
    key = torch.tensor([5, -6], dtype=torch.int32)
    for rand in (dict(p0=torch.randn((n, dim), generator=g), u=torch.rand(n, generator=g)),
                 dict(key=key, call=4)):
        plain = ft.grahmc_step_plain(info, 10, 2, q, lp, grad,
                                     ft.kernel_scalars(0.3, 0.1, 5.0, "cpu"), invm,
                                     l_inv=l_inv, **rand)
        scaled = ft.grahmc_scaled_plain(info, 10, 2, q, lp, grad,
                                        ft.rung_table(0.3, 0.1, 5.0, 1.0, "cpu"), invm,
                                        l_inv=l_inv, **rand)
        bridged = ft.grahmc_bridged_plain(
            info, 10, 2, q, lp, grad, ft.bridge_scalars(0.3, 0.1, 5.0, 1.0, base.log_norm,
                                                        "cpu"),
            base.mean, base.inv_scale, invm, l_inv=l_inv, **rand)
        for out in (scaled, bridged):
            for a, b in zip(out, plain):
                assert torch.equal(a, b)


def test_eager_step_row_equals_scalar_slices():
    """grahmc_transition with a (C, 1) step-size row == per-slice
    transitions with each slice's scalar step (float64, tanh friction, the
    friction time T = eps L per chain)."""
    dim, chains, steps = 5, 8, [0.1, 0.25, 0.4]
    t = t_get_target("gaussian_mixture", dim=dim)
    n = chains * len(steps)
    g = torch.Generator().manual_seed(2)
    state = tbase.init_chain_state(t.init_sampler(g, n, dtype=torch.float64), t.log_prob_fn,
                                   t.value_and_grad_fn)
    p0 = torch.randn((n, dim), generator=g, dtype=torch.float64)
    u = torch.rand(n, generator=g, dtype=torch.float64)
    invm = torch.linspace(0.8, 1.2, dim, dtype=torch.float64)
    row = torch.tensor(steps, dtype=torch.float64).repeat_interleave(chains)[:, None]
    whole, (acc, q1, lp1, dh) = tg.grahmc_transition(state, p0, u, t.value_and_grad_fn, row,
                                                     12, 0.3, 5.0, invm, tg.tanh_schedule)
    for k, step in enumerate(steps):
        sl = slice(k * chains, (k + 1) * chains)
        part, (acc_k, q_k, lp_k, dh_k) = tg.grahmc_transition(
            tbase.ChainState(*(f[sl] for f in state)), p0[sl], u[sl], t.value_and_grad_fn,
            step, 12, 0.3, 5.0, invm, tg.tanh_schedule)
        assert torch.equal(acc[sl], acc_k)
        for a, b in zip(tuple(whole) + (q1, lp1, dh), tuple(part) + (q_k, lp_k, dh_k)):
            np.testing.assert_allclose(a[sl].numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def swap_phase_numpy(q, lp, g, betas, phase, u, swap_acc):
    """A numpy transcription of mcmc_tpu/samplers/tempered.py:233-274."""
    k = betas.shape[0]
    n, dim = q.shape
    c = n // k
    b = betas.astype(lp.dtype)
    lp_un = lp.reshape(k, c) / b[:, None]
    qq = q.reshape(k, c, dim)
    g_un = g.reshape(k, c, dim) / b[:, None, None]

    def nxt(a):
        return np.roll(a, -1, axis=0)
    d_beta = (betas - np.roll(betas, -1)).astype(lp.dtype)
    log_acc = d_beta[:, None] * (nxt(lp_un) - lp_un)
    idx = np.arange(k)
    active = ((idx < k - 1) & (idx % 2 == phase))[:, None]
    take_next = active & (np.log(u) < log_acc)
    take_prev = np.roll(take_next, 1, axis=0)

    def mix(x, m2, m3):
        return np.where(m2, nxt(x), np.where(m3, np.roll(x, 1, axis=0), x))
    q_new = mix(qq, take_next[..., None], take_prev[..., None])
    lp_new = mix(lp_un, take_next, take_prev)
    g_new = mix(g_un, take_next[..., None], take_prev[..., None])
    acc = swap_acc[0] + np.where(active, take_next, False).sum(1).astype(np.float32)[:k - 1]
    att = swap_acc[1] + active[:, 0].astype(np.float32)[:k - 1] * c
    return (q_new.reshape(n, dim), (b[:, None] * lp_new).reshape(n),
            (b[:, None, None] * g_new).reshape(n, dim), acc, att)


@pytest.mark.parametrize("n_temps", [1, 2, 5])
@pytest.mark.parametrize("phase", [0, 1])
def test_swap_phase_matches_numpy_transcription(n_temps, phase):
    """The swap phase on injected uniforms == the numpy transcription of the
    JAX one, exactly: the exchanges, the tempered energies re-derived
    through the betas, and the per-pair accounting ((0,) at K = 1)."""
    chains, dim = 64, 3
    rng = np.random.default_rng(10 + n_temps)
    betas = np.asarray(j_ladder(n_temps, 0.1), np.float32)
    b_row = np.repeat(betas.astype(np.float64), chains)
    q = rng.standard_normal((n_temps * chains, dim))
    lp = b_row * (-0.5 * np.sum(q * q, axis=1) - rng.uniform(0, 3, n_temps * chains))
    g = b_row[:, None] * -q
    u = rng.uniform(size=(n_temps, chains))
    acc0 = (np.arange(n_temps - 1, dtype=np.float32), np.ones(n_temps - 1, np.float32))
    state = tbase.ChainState(_t(q), _t(lp), _t(g), torch.zeros(1), torch.zeros(1))
    new, (acc, att) = tt.swap_phase(state, _t(betas), phase, _t(u), tuple(map(_t, acc0)))
    want = swap_phase_numpy(q, lp, g, betas, phase, u, acc0)
    for ours, theirs in zip((new.position, new.log_prob, new.grad_log_prob, acc, att), want):
        np.testing.assert_array_equal(ours.numpy(), theirs)
    assert acc.shape == (n_temps - 1,)
    if n_temps == 5:
        assert 0 < int((new.position != state.position).any(dim=1).sum())


def test_geometric_ladder_matches_jax():
    for k, b_min in ((6, 0.05), (4, 0.01), (2, 0.5)):
        np.testing.assert_allclose(tt.geometric_ladder(k, b_min, device="cpu").numpy(),
                                   np.asarray(j_ladder(k, b_min)), rtol=1e-6)
    np.testing.assert_array_equal(tt.geometric_ladder(1, device="cpu").numpy(), [1.0])
    with pytest.raises(ValueError, match="beta_min"):
        tt.geometric_ladder(4, 1.5, device="cpu")
    with pytest.raises(ValueError, match="n_temps"):
        tt.geometric_ladder(0, device="cpu")


def _kw(t, **extra):
    return dict(value_and_grad_fn=t.value_and_grad_fn, **extra)


def test_swap_attempts_accounting():
    """swap_attempts counts per-pair attempt events (chains x swap phases):
    [40, 40, 40] over 10 transitions at swap_interval 1, and a burst of one
    swap phase leaves the odd pair at exactly 0 (tests/test_tempered.py)."""
    t = t_get_target("standard_normal", dim=3)
    init = torch.randn((8, 3), generator=torch.Generator().manual_seed(1)) * 0.2
    kw = _kw(t, step_size=0.5, num_steps=4, n_temps=4, beta_min=0.05)
    for backend in ("eager", "fused"):
        r = tt.tempered_run(torch.Generator().manual_seed(0), t.log_prob_fn, init,
                            num_samples=10, backend=backend, **kw)
        np.testing.assert_array_equal(r.info["swap_attempts"].numpy(), [40.0, 40.0, 40.0])
    r2 = tt.tempered_run(torch.Generator().manual_seed(0), t.log_prob_fn, init,
                         num_samples=16, swap_interval=16, **kw)
    np.testing.assert_array_equal(r2.info["swap_attempts"].numpy(), [8.0, 0.0, 8.0])
    assert float(r2.info["swap_accept_rate"][1]) == 0.0


def test_tempered_run_validation_messages():
    """Bad ladders, swap intervals, step shapes and continuation states
    raise with the JAX package's messages; an unknown backend raises."""
    t = t_get_target("standard_normal", dim=3)
    init = torch.zeros((4, 3))
    kw = _kw(t, step_size=0.5, num_steps=4, num_samples=4)
    g = torch.Generator()
    for betas, match in (([0.9, 0.3, 0.1], r"betas\[0\] must be 1"),
                         ([1.0, 0.5, 0.0], "strictly positive"),
                         ([1.0, 0.5, 0.5], "descending"), (np.ones((2, 2)), "1-D")):
        with pytest.raises(ValueError, match=match):
            tt.tempered_run(g, t.log_prob_fn, init, betas=torch.tensor(betas), **kw)
    with pytest.raises(ValueError, match="swap_interval"):
        tt.tempered_run(g, t.log_prob_fn, init, swap_interval=0, **kw)
    with pytest.raises(ValueError, match="step_size"):
        tt.tempered_run(g, t.log_prob_fn, init, **dict(kw, step_size=torch.ones(5)),
                        n_temps=3)
    with pytest.raises(ValueError, match="init_replica_position"):
        tt.tempered_run(g, t.log_prob_fn, init, init_replica_position=torch.zeros((7, 3)),
                        **kw)
    with pytest.raises(ValueError, match="backend"):
        tt.tempered_run(g, t.log_prob_fn, init, backend="pallas", **kw)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_tempered_normal_moments_and_schema_against_jax(backend):
    """The cold replica's marginals on N(0, I) stay exact, the emitted
    log-probs are the untempered target's, the info schema carries the
    ladder diagnostics, and every pair's swap rate lies within 0.12 of the
    JAX package's run at the same configuration (tests/test_tempered.py)."""
    t = t_get_target("standard_normal", dim=4)
    init_np = np.asarray(random.normal(random.PRNGKey(1), (64, 4))) * 0.2
    kw = dict(step_size=0.5, num_steps=8, num_samples=400, burn_in=100, n_temps=4)
    r = tt.tempered_run(torch.Generator().manual_seed(0), t.log_prob_fn,
                        _t(init_np).float(), value_and_grad_fn=t.value_and_grad_fn,
                        backend=backend, **kw)
    assert r.samples.shape == (400, 64, 4) and r.log_probs.shape == (400, 64)
    m = r.samples.reshape(-1, 4).double()
    assert float(m.mean(0).abs().max()) < 0.12
    assert float((m.var(0) - 1.0).abs().max()) < 0.15
    torch.testing.assert_close(r.log_probs[-1], t.log_prob_fn(r.samples[-1]),
                               rtol=1e-5, atol=1e-5)
    assert set(r.info) >= {"divergence_count", "total_divergences", "divergence_rate",
                           "final_positions", "replica_final_positions", "swap_accept_rate",
                           "swap_attempts", "betas", "replica_step_sizes", "n_temps",
                           "replica_accept_rate"}
    assert r.info["betas"].shape == (4,) and r.info["replica_step_sizes"].shape == (4,)
    acc = r.info["replica_accept_rate"]
    assert acc.shape == (4,) and bool(((acc > 0.3) & (acc <= 1.0)).all())
    assert r.final_state.position.shape == (64, 4)
    assert r.info["replica_final_positions"].shape == (256, 4)

    jt = j_get_target("standard_normal", dim=4)
    rj = j_tempered_run(random.PRNGKey(0), jt.log_prob_fn, jnp.asarray(init_np, jnp.float32),
                        value_and_grad_fn=jt.value_and_grad_fn, **kw)
    sw, swj = r.info["swap_accept_rate"].numpy(), np.asarray(rj.info["swap_accept_rate"])
    assert sw.shape == (3,) and np.all((sw > 0.05) & (sw < 1.0))
    assert np.all(np.abs(sw - swj) < 0.12), (sw, swj)
    assert abs(float(r.accept_rate.mean()) - float(rj.accept_rate.mean())) < 0.05


def test_single_temperature_and_explicit_ladder():
    """K = 1 is plain sampling with (0,)-shaped swap statistics; explicit
    betas and per-replica steps with tanh friction compose, and
    collect_chains truncates the emitted prefix (tests/test_tempered.py)."""
    t = t_get_target("standard_normal", dim=3)
    init = torch.randn((8, 3), generator=torch.Generator().manual_seed(1)) * 0.2
    r = tt.tempered_run(torch.Generator().manual_seed(0), t.log_prob_fn, init, 0.5, 8, 300,
                        burn_in=50, n_temps=1, value_and_grad_fn=t.value_and_grad_fn)
    assert r.samples.shape == (300, 8, 3) and r.info["swap_accept_rate"].shape == (0,)
    assert float((r.samples.reshape(-1, 3).var(0) - 1.0).abs().max()) < 0.25
    steps = torch.tensor([0.15, 0.25, 0.4])
    for backend in ("eager", "fused"):
        r = tt.tempered_run(torch.Generator().manual_seed(0), t.log_prob_fn, init, steps, 8,
                            500, burn_in=100, betas=torch.tensor([1.0, 0.3, 0.1]), gamma=1.0,
                            steepness=5.0, friction_schedule=tg.tanh_schedule,
                            swap_interval=2, collect_chains=4,
                            value_and_grad_fn=t.value_and_grad_fn, backend=backend)
        assert r.samples.shape == (500, 4, 3)
        assert torch.equal(r.info["replica_step_sizes"], steps)
        m = r.samples.reshape(-1, 3)
        assert bool(torch.isfinite(m).all())
        assert float((m.var(0) - 1.0).abs().max()) < 0.35
        assert float(m.mean(0).abs().max()) < 0.25


def test_mixture_crosses_where_hmc_cannot():
    """The 4-D mixture with a 5-sigma barrier (separation 10), every chain
    started in the left mode: fused HMC stays there while the fused
    tempered ladder (kernel 1b's plain version) finds both modes with
    Var x0 = 1 + 25 (tests/test_tempered.py's crossing test, on 64 chains)."""
    t = t_get_target("gaussian_mixture", dim=4, separation=10.0)
    init = torch.randn((64, 4), generator=torch.Generator().manual_seed(2)) * 0.3
    init[:, 0] -= 5.0
    kw = dict(step_size=0.3, num_steps=16, num_samples=800, burn_in=200,
              value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    from mcmc_tpu_torch.samplers import hmc_run
    rh = hmc_run(torch.Generator().manual_seed(3), t.log_prob_fn, init, **kw)
    assert float((rh.samples[..., 0] > 0).double().mean()) < 0.15
    rt = tt.tempered_run(torch.Generator().manual_seed(3), t.log_prob_fn, init, n_temps=6,
                         beta_min=0.01, **kw)
    x0 = rt.samples[..., 0].reshape(-1).double()
    assert 0.4 < float((x0 > 0).double().mean()) < 0.6
    assert abs(float(x0.mean())) < 0.6
    assert abs(float(x0.var()) - 26.0) < 3.0
    assert bool((rt.info["swap_accept_rate"] > 0.1).all()), rt.info["swap_accept_rate"]


def test_jax_replica_positions_continue_in_the_port():
    """A JAX run's info["replica_final_positions"] carried across as numpy
    continues the full ladder in the port: the hot rungs keep their
    dispersion, the cold marginal needs no new burn-in."""
    jt = j_get_target("standard_normal", dim=4)
    init = random.normal(random.PRNGKey(1), (32, 4)) * 0.2
    rj = j_tempered_run(random.PRNGKey(0), jt.log_prob_fn, init, step_size=0.5, num_steps=8,
                        num_samples=300, burn_in=100, n_temps=4, beta_min=0.05,
                        value_and_grad_fn=jt.value_and_grad_fn)
    rep = torch.from_numpy(np.array(rj.info["replica_final_positions"]))
    assert float(rep[-32:].var()) > 4.0 * float(rep[:32].var())
    t = t_get_target("standard_normal", dim=4)
    r = tt.tempered_run(torch.Generator().manual_seed(5), t.log_prob_fn, _t(init), 0.5, 8, 300,
                        n_temps=4, beta_min=0.05, init_replica_position=rep,
                        value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    rep2 = r.info["replica_final_positions"]
    assert float(rep2[-32:].var()) > 4.0 * float(rep2[:32].var())
    assert float((r.samples.reshape(-1, 4).var(0) - 1.0).abs().max()) < 0.15


def test_wrappers_never_fall_back(monkeypatch, tmp_path):
    """Kernels 1b and 1c on tensors that are not on the CPU launch or raise:
    a meta tensor is refused as not CUDA, and past that check the request
    reaches the build (which raises here, with no nvcc), never a plain
    version; the CPU path counts no launch."""
    t = t_get_target("gaussian_mixture", dim=3)
    info = t.value_and_grad_fn.kernel_info
    base = ft.bridge_base(None, 2.0, 3, "cpu")

    def calls(dev):
        q = torch.zeros((4, 3), device=dev)
        lp, key = torch.zeros(4, device=dev), torch.zeros(2, dtype=torch.int32, device=dev)
        invm = torch.ones(3, device=dev)
        yield lambda: ft.grahmc_scaled_kernel(info, 4, 2, q, lp, q, ft.rung_table(
            0.1, 0.1, 5.0, torch.ones(2), dev), invm, key=key)
        yield lambda: ft.grahmc_bridged_kernel(info, 4, 0, q, lp, q, ft.bridge_scalars(
            0.1, 0.0, 1.0, 0.5, base.log_norm, dev), base.mean.to(dev),
            base.inv_scale.to(dev), invm, key=key)

    ft.reset_launches()
    for call in calls("cpu"):
        call()
    assert ft.grahmc_scaled_kernel.launches == ft.grahmc_bridged_kernel.launches == 0
    for call in calls("meta"):
        with pytest.raises(ValueError, match="CUDA"):
            call()

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(ft, "_kernel_device", lambda q: None)
    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    for call in calls("meta"):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    with pytest.raises(ValueError, match="rungs"):
        ft.grahmc_scaled_kernel(info, 4, 2, torch.zeros((5, 3)), torch.zeros(5),
                                torch.zeros((5, 3)), ft.rung_table(0.1, 0.1, 5.0,
                                                                   torch.ones(2), "cpu"),
                                torch.ones(3), key=torch.zeros(2, dtype=torch.int32))
