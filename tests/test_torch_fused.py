"""Port parity: the plain versions of the fused GRAHMC kernels against the
JAX package's Pallas kernels (interpret mode), and the wrapper contracts.

The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrappers take their plain versions because the
tensors lie on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch.ops import _cuda  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers.base import init_chain_state  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402

PALLAS_DIM = 20


def _t(a):
    return torch.from_numpy(np.array(a))


def _debug_inputs(seed, family, n_chains):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((n_chains, PALLAS_DIM)) * 0.7).astype(np.float32)
    p0 = rng.standard_normal((n_chains, PALLAS_DIM)).astype(np.float32)
    u = rng.uniform(size=n_chains).astype(np.float32)
    jt = j_get_target(family, dim=PALLAS_DIM)
    lp, grad = jt.value_and_grad_fn(jnp.asarray(q))
    return jt, q, np.asarray(lp, np.float32), np.asarray(grad, np.float32), p0, u


@pytest.mark.parametrize("layout", ["lanes", "transposed"])
@pytest.mark.parametrize("schedule", [None, "tanh", "constant", "sine"])
def test_step_plain_matches_pallas_debug_kernel(schedule, layout):
    """Kernel 1's plain version == the JAX fused kernel (interpret mode) on
    injected randomness, in both TPU block layouts."""
    n_chains, L = 8, 10
    eps, gamma, steep = 0.15, 0.8, 2.0
    jt, q, lp, grad, p0, u = _debug_inputs(1, "standard_normal", n_chains)
    inv_mass = np.ones(PALLAS_DIM, np.float32)
    jsched = jg.get_friction_schedule(schedule) if schedule else None
    run_j = jft.make_debug_trajectory(jt.value_and_grad_fn, L, jsched, n_chains,
                                      PALLAS_DIM, layout=layout)
    qj, lpj, gj, accj, dhj = run_j(jnp.asarray(q), jnp.asarray(lp),
                                   jnp.asarray(grad), jnp.asarray(p0),
                                   jnp.asarray(u), eps, gamma, steep,
                                   jnp.asarray(inv_mass))

    tt = t_get_target("standard_normal", dim=PALLAS_DIM)
    tsched = tg.get_friction_schedule(schedule) if schedule else None
    run_t = ft.make_debug_trajectory(tt.value_and_grad_fn, L, tsched, n_chains,
                                     PALLAS_DIM)
    qt, lpt, gt, acct, dht = run_t(_t(q), _t(lp), _t(grad), _t(p0), _t(u), eps,
                                   gamma, steep, _t(inv_mass))
    np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dht.numpy(), np.asarray(dhj), rtol=2e-3, atol=2e-3)


def test_step_plain_matches_pallas_debug_kernel_funnel():
    n_chains, L = 8, 6
    eps, gamma, steep = 0.05, 1.0, 0.5
    jt, q, lp, grad, p0, u = _debug_inputs(2, "neals_funnel", n_chains)
    inv_mass = np.ones(PALLAS_DIM, np.float32)
    run_j = jft.make_debug_trajectory(jt.value_and_grad_fn, L, jg.tanh_schedule,
                                      n_chains, PALLAS_DIM)
    _, _, _, accj, dhj = run_j(jnp.asarray(q), jnp.asarray(lp), jnp.asarray(grad),
                               jnp.asarray(p0), jnp.asarray(u), eps, gamma,
                               steep, jnp.asarray(inv_mass))
    tt = t_get_target("neals_funnel", dim=PALLAS_DIM)
    run_t = ft.make_debug_trajectory(tt.value_and_grad_fn, L, tg.tanh_schedule,
                                     n_chains, PALLAS_DIM)
    _, _, _, acct, dht = run_t(_t(q), _t(lp), _t(grad), _t(p0), _t(u), eps,
                               gamma, steep, _t(inv_mass))
    np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
    np.testing.assert_allclose(dht.numpy(), np.asarray(dhj), rtol=5e-3, atol=5e-3)


def test_multistep_plain_matches_pallas_multistep_kernel():
    """Kernel 2's plain version == the JAX multi-transition kernel
    (interpret mode), its draws reproduced from the key split."""
    dim, C, T, L = 10, 16, 4, 6
    eps, gamma, steep = 0.15, 1.0, 0.5
    jt = j_get_target("neals_funnel", dim=dim)
    init = (np.random.default_rng(8).standard_normal((C, dim)) * 0.4).astype(np.float32)
    state = jbase.init_chain_state(jnp.asarray(init), jt.log_prob_fn,
                                   jt.value_and_grad_fn)
    state = state._replace(position=state.position.astype(jnp.float32),
                           log_prob=state.log_prob.astype(jnp.float32),
                           grad_log_prob=state.grad_log_prob.astype(jnp.float32))
    inv_mass = np.full(dim, 1.7, np.float32)
    key = random.PRNGKey(7)
    multi = jft.make_fused_grahmc_multistep(jt.log_prob_fn, jt.value_and_grad_fn,
                                            L, jg.tanh_schedule, T, interpret=True)
    _, ms, (acc_j, hist_q_j, hist_lp_j, dh_j) = multi(
        key, state, eps, gamma, steep, jnp.asarray(inv_mass))

    d_pad = 16
    _, seed_key = random.split(key)
    k_mom, k_u = random.split(seed_key)
    invm_col = jnp.pad(jnp.asarray(inv_mass), (0, d_pad - dim),
                       constant_values=1.0)[:, None]
    p0 = random.normal(k_mom, (T, d_pad, C), jnp.float32) / jnp.sqrt(invm_col)
    u = random.uniform(k_u, (T, C), jnp.float32)
    p0 = np.ascontiguousarray(np.transpose(np.asarray(p0)[:, :dim, :], (0, 2, 1)))

    tt = t_get_target("neals_funnel", dim=dim)
    q1, lp1, g1, acc_t, dh_t, hist_q_t, hist_lp_t = ft.grahmc_multistep_kernel(
        tt.value_and_grad_fn.kernel_info, L, ft.SCHEDULE_IDS["tanh"], T,
        _t(state.position), _t(state.log_prob), _t(state.grad_log_prob),
        ft.kernel_scalars(eps, gamma, steep, "cpu"), _t(inv_mass),
        p0=_t(p0), u=_t(u))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    for a, b in ((hist_q_t, hist_q_j), (hist_lp_t, hist_lp_j), (q1, ms.position),
                 (lp1, ms.log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # delta H is the difference of two float32 energies of magnitude ~20
    # (ulp 2e-6), and the funnel's neck gradient cancels float32 terms of
    # magnitude ~5; both rest on sums taken in another order than the TPU
    # kernel's (10 coordinates here, 16 padded sublanes there): a few ulps
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(ms.grad_log_prob),
                               rtol=1e-6, atol=1e-5)


def test_multistep_plain_equals_chained_step_plain():
    """T transitions of kernel 2 == T chained kernel-1 transitions on the
    same Philox stream (counter transition index t)."""
    dim, C, T = 12, 32, 4
    t = t_get_target("neals_funnel", dim=dim)
    info = t.value_and_grad_fn.kernel_info
    q = t.init_sampler(torch.Generator().manual_seed(0), C) * 0.5
    lp, g = t.value_and_grad_fn(q)
    scalars = ft.kernel_scalars(0.1, 0.5, 1.0, "cpu")
    inv_mass = torch.ones(dim)
    key = torch.tensor([12345, -678], dtype=torch.int32)
    out = ft.grahmc_multistep_kernel(info, 5, 1, T, q, lp, g, scalars, inv_mass,
                                     key=key, call=3)
    qs, lps, gs = q, lp, g
    for k in range(T):
        p0 = ft.philox_normal(key, 3, k, C, dim, "cpu")
        u = ft.philox_uniform(key, 3, k, C, "cpu")
        qs, lps, gs, acc, dh, _, _ = ft.grahmc_step_kernel(
            info, 5, 1, qs, lps, gs, scalars, inv_mass, p0=p0, u=u)
        assert torch.equal(acc, out[3][k])
        assert torch.equal(qs, out[5][k]) and torch.equal(lps, out[6][k])
    assert torch.equal(gs, out[2])


@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, expected):
    """Random123's philox4x32_10 known-answer vectors."""
    words = ft.philox4x32_10(*(torch.tensor(c, dtype=torch.int64) for c in ctr),
                             *(torch.tensor(k, dtype=torch.int64) for k in key))
    assert tuple(int(w) for w in words) == expected


def test_philox_draws_are_standard():
    key = torch.tensor([7, 9], dtype=torch.int32)
    z = ft.philox_normal(key, 0, 0, 50000, 7, "cpu")
    assert z.shape == (50000, 7) and z.dtype == torch.float32
    np.testing.assert_allclose(z.mean(0).numpy(), 0.0, atol=0.03)
    np.testing.assert_allclose(z.var(0).numpy(), 1.0, atol=0.03)
    # independent across coordinates, calls and transitions
    assert abs(float(torch.corrcoef(z[:, :2].T)[0, 1])) < 0.03
    z2 = ft.philox_normal(key, 1, 0, 50000, 7, "cpu")
    z3 = ft.philox_normal(key, 0, 1, 50000, 7, "cpu")
    assert not torch.equal(z, z2) and not torch.equal(z, z3)
    u = ft.philox_uniform(key, 0, 0, 50000, "cpu")
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    # never 0 (log u stays finite); the top value 1 - 2^-25 rounds to 1.0f
    bits = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    edge = ft._bits_to_uniform(bits)
    assert float(edge[0]) == 2.0 ** -25 and float(edge[1]) == 1.0


def test_unknown_schedule_family_or_metric_raises():
    t = t_get_target("neals_funnel", dim=5)
    with pytest.raises(KeyError):
        ft.make_fused_grahmc_step(t.value_and_grad_fn, 4, lambda *a: 0.0)
    with pytest.raises(TypeError):
        ft.make_fused_grahmc_step(lambda x: (x.sum(-1), -x), 4, None)
    with pytest.raises(TypeError):
        ft.make_fused_grahmc_multistep(None, 4, None, 2)

    def other_family(x):
        return x.sum(-1), -x
    other_family.kernel_info = {"family": "no_such_family", "dim": 5, "params": {}}
    with pytest.raises(KeyError):
        ft.make_fused_grahmc_step(other_family, 4, tg.tanh_schedule)

    # a dense metric runs kernel 1a (tests/test_torch_dense_grahmc.py); one
    # that is not (D,) or (D, D) raises
    q = torch.zeros(4, 5)
    for bad in (torch.ones(5, 4), torch.ones(2, 5, 5)):
        with pytest.raises(ValueError):
            tg.grahmc_run(torch.Generator(), t.log_prob_fn, q, 0.1, 4, 1.0, 1.0, 2,
                          inv_mass_matrix=bad,
                          value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    with pytest.raises(TypeError):
        tg.grahmc_run(torch.Generator(), t.log_prob_fn, q, 0.1, 4, 1.0, 1.0, 2,
                      backend="fused")
    wide = t_get_target("standard_normal", dim=129)
    with pytest.raises(ValueError):
        tg.grahmc_run(torch.Generator(), wide.log_prob_fn, torch.zeros(2, 129),
                      0.1, 4, 1.0, 1.0, 2,
                      value_and_grad_fn=wide.value_and_grad_fn, backend="fused")


def _kernel_args(dim=6, chains=4, dtype=torch.float32, device="cpu"):
    t = t_get_target("standard_normal", dim=dim)
    q = torch.zeros((chains, dim), dtype=dtype, device=device)
    lp = torch.zeros(chains, dtype=dtype, device=device)
    return (t.value_and_grad_fn.kernel_info, 4, 0, q, lp, torch.zeros_like(q),
            torch.ones(3, dtype=dtype, device=device),
            torch.ones(dim, dtype=dtype, device=device))


def test_wrappers_validate_inputs():
    args = _kernel_args()
    with pytest.raises(ValueError):
        ft.grahmc_step_kernel(*args)                      # no key, no randoms
    with pytest.raises(ValueError):
        ft.grahmc_step_kernel(*args, p0=torch.zeros(4, 6))   # p0 without u
    with pytest.raises(TypeError):
        ft.grahmc_step_kernel(*_kernel_args(dtype=torch.float64),
                              key=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ft.grahmc_multistep_kernel(*args[:3], 2, *args[3:],
                                   p0=torch.zeros(4, 6), u=torch.zeros(4))


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, tmp_path):
    """For tensors that are not on the CPU the wrappers launch the kernel or
    raise: meta tensors are refused, and on a host with no nvcc a request
    that passes the device check fails in the build instead of falling
    back. No launch is counted."""
    before = (ft.grahmc_step_kernel.launches, ft.grahmc_multistep_kernel.launches)
    args = _kernel_args(device="meta")
    key = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ft.grahmc_step_kernel(*args, key=key)
    with pytest.raises(ValueError, match="CUDA"):
        ft.grahmc_multistep_kernel(*args[:3], 2, *args[3:], key=key)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(ft, "_kernel_device", lambda q: None)
    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        ft.grahmc_step_kernel(*args, key=key)
    with pytest.raises(RuntimeError, match="nvcc"):
        ft.grahmc_multistep_kernel(*args[:3], 2, *args[3:], key=key)
    assert not (tmp_path / "build").exists()
    assert (ft.grahmc_step_kernel.launches,
            ft.grahmc_multistep_kernel.launches) == before


def test_cpu_path_counts_no_launches():
    before = (ft.grahmc_step_kernel.launches, ft.grahmc_multistep_kernel.launches)
    t = t_get_target("neals_funnel", dim=5)
    q = t.init_sampler(torch.Generator().manual_seed(0), 8) * 0.3
    for n_chains, samples in ((8, 8), (8, 3)):          # multistep, then step
        res = tg.grahmc_run(torch.Generator().manual_seed(1), t.log_prob_fn,
                            q[:n_chains], 0.1, 4, 1.0, 1.0, samples,
                            value_and_grad_fn=t.value_and_grad_fn,
                            backend="fused")
        assert res.samples.shape == (samples, n_chains, 5)
    assert (ft.grahmc_step_kernel.launches,
            ft.grahmc_multistep_kernel.launches) == before


def test_fused_step_state_contract():
    """make_fused_grahmc_step keeps the state's dtypes and counters, and
    advances the stream's call index once per transition."""
    t = t_get_target("neals_funnel", dim=5)
    q = t.init_sampler(torch.Generator().manual_seed(0), 16).double() * 0.3
    state = init_chain_state(q, t.log_prob_fn, t.value_and_grad_fn)
    fused = ft.make_fused_grahmc_step(t.value_and_grad_fn, 4, tg.tanh_schedule)
    stream = ft.PhiloxStream(torch.tensor([1, 2], dtype=torch.int32))
    for _ in range(3):
        state, (acc, prop_q, prop_lp, dh) = fused(stream, state, 0.1, 0.5, 1.0,
                                                   torch.ones(5))
    assert stream.calls == 3
    assert state.position.dtype == torch.float64 == prop_q.dtype
    assert state.log_prob.dtype == torch.float64 == dh.dtype
    assert state.accept_count.dtype == torch.int32
    assert 0 < int(state.accept_count.sum()) <= 48
