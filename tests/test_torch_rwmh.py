"""Port parity for RWMH: kernel 3's plain version against the JAX package's
Pallas kernel (interpret mode, its own injected draws), the eager sampler
against the JAX sampler's moments, and the fused backend's contract.

The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrapper takes its plain version because the
tensors lie on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops.fused_rwmh import make_fused_rwmh_multistep as j_multistep  # noqa: E402
from mcmc_tpu.ops.fused_trajectory import SUBLANE, _round_up  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers.rwmh import rwmh_run as j_rwmh_run  # noqa: E402
from mcmc_tpu.samplers.rwmh import rwmh_step as j_rwmh_step  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch.ops import _cuda  # noqa: E402
from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import rwmh as tr  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("family,dim", [("standard_normal", 7), ("neals_funnel", 12)])
def test_plain_matches_pallas_kernel(family, dim):
    """rwmh_multistep_plain == make_fused_rwmh_multistep(interpret=True) on
    the draws the JAX wrapper makes (tests/test_pallas_ops.py:509's recipe),
    T = 8: accepts equal, q and lp within 1e-6; the history of the first
    n_hist chains equals the full history's prefix."""
    C, T, scale = 16, 8, 0.45
    jt = j_get_target(family, dim=dim)
    init = (np.random.default_rng(dim).standard_normal((C, dim)) * 0.4).astype(np.float32)
    state = jbase.init_chain_state(jnp.asarray(init), jt.log_prob_fn, needs_grad=False)
    state = state._replace(position=state.position.astype(jnp.float32),
                           log_prob=state.log_prob.astype(jnp.float32))
    key = random.PRNGKey(dim)
    multi = j_multistep(jt.log_prob_fn, jt.value_and_grad_fn, T, interpret=True)
    _, ms, (acc_j, hist_q_j, hist_lp_j) = multi(key, state, scale)

    d_pad = _round_up(dim, SUBLANE)
    _, seed_key = random.split(key)
    k_noise, k_u = random.split(seed_key)
    noise = random.normal(k_noise, (T, d_pad, C), jnp.float32)
    u = random.uniform(k_u, (T, C), jnp.float32)
    noise = np.ascontiguousarray(np.transpose(np.asarray(noise), (0, 2, 1))[:, :, :dim])

    info = t_get_target(family, dim=dim).value_and_grad_fn.kernel_info
    args = (info, T, _t(state.position), _t(state.log_prob), fr.rwmh_scale(scale, "cpu"))
    q1, lp1, acc_t, hist_q_t, hist_lp_t = fr.rwmh_multistep_kernel(
        *args, C, noise=_t(noise), u=_t(u))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert 0 < int(acc_t.sum()) < T * C
    for a, b in ((hist_q_t, hist_q_j), (hist_lp_t, hist_lp_j), (q1, ms.position),
                 (lp1, ms.log_prob)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    _, _, acc_p, hq_p, hlp_p = fr.rwmh_multistep_kernel(*args, 5, noise=_t(noise), u=_t(u))
    assert torch.equal(acc_p, acc_t)
    assert torch.equal(hq_p, hist_q_t[:, :5]) and torch.equal(hlp_p, hist_lp_t[:, :5])


def test_philox_plain_draws_the_documented_counters():
    """With a key, transition t of the plain version draws
    philox_normal(key, call, t) and philox_uniform(key, call, t)."""
    t = t_get_target("neals_funnel", dim=9)
    info = t.value_and_grad_fn.kernel_info
    q = t.init_sampler(torch.Generator().manual_seed(0), 32) * 0.4
    lp, _ = t.value_and_grad_fn(q)
    key = torch.tensor([5, -6], dtype=torch.int32)
    scale = fr.rwmh_scale(0.3, "cpu")
    out = fr.rwmh_multistep_kernel(info, 4, q, lp, scale, 32, key=key, call=11)
    noise = torch.stack([ft.philox_normal(key, 11, k, 32, 9, "cpu") for k in range(4)])
    u = torch.stack([ft.philox_uniform(key, 11, k, 32, "cpu") for k in range(4)])
    ref = fr.rwmh_multistep_kernel(info, 4, q, lp, scale, 32, noise=noise, u=u)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family,dim", [("standard_normal", 5), ("neals_funnel", 8)])
def test_eager_transition_matches_jax_step_on_its_draws(family, dim):
    """rwmh_transition fed the draws JAX rwmh_step makes from its key (split
    in three: carried key, noise, accept uniform) follows the JAX chain step
    for step in float64: accepts equal, states within 1e-12."""
    C, scale = 32, 0.6
    init = np.random.default_rng(dim).standard_normal((C, dim)) * 0.5
    jt, tt = j_get_target(family, dim=dim), t_get_target(family, dim=dim)
    js = jbase.init_chain_state(jnp.asarray(init), jt.log_prob_fn, needs_grad=False)
    ts = tr.rwmh_init(_t(init), tt.log_prob_fn)
    key = random.PRNGKey(3)
    for _ in range(20):
        _, k_noise, k_accept = random.split(key, 3)
        noise = random.normal(k_noise, (C, dim), dtype=jnp.float64)
        u = random.uniform(k_accept, (C,), dtype=jnp.float64)
        key, js, j_acc = j_rwmh_step(key, js, jt.log_prob_fn, scale)
        ts, t_acc = tr.rwmh_transition(ts, _t(noise), _t(u), tt.log_prob_fn, scale)
        np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
        np.testing.assert_allclose(ts.position.numpy(), np.asarray(js.position),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ts.log_prob.numpy(), np.asarray(js.log_prob),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ts.accept_count.numpy(), np.asarray(js.accept_count))
    assert 0 < int(ts.accept_count.sum()) < 20 * C


def test_eager_run_matches_jax_moments():
    """rwmh_run eager against the JAX rwmh_run on the 5-D standard normal:
    means within 0.1 and variances within 0.15 of each other."""
    dim, C, n, burn = 5, 256, 400, 200
    scale = 2.38 / dim ** 0.5
    init = (np.random.default_rng(3).standard_normal((C, dim)) * 0.3).astype(np.float32)
    jt = j_get_target("standard_normal", dim=dim)
    jres = j_rwmh_run(random.PRNGKey(0), jt.log_prob_fn, jnp.asarray(init),
                      num_samples=n, scale=scale, burn_in=burn)
    tt = t_get_target("standard_normal", dim=dim)
    tres = tr.rwmh_run(torch.Generator().manual_seed(0), tt.log_prob_fn, _t(init),
                       num_samples=n, scale=scale, burn_in=burn)
    j_flat = np.asarray(jres.samples).reshape(-1, dim)
    t_flat = tres.samples.reshape(-1, dim).numpy()
    assert np.all(np.abs(t_flat.mean(0) - j_flat.mean(0)) < 0.1)
    assert np.all(np.abs(t_flat.var(0) - j_flat.var(0)) < 0.15)
    assert abs(float(tres.accept_rate.mean()) - float(jres.accept_rate.mean())) < 0.03
    assert tres.accept_rate.dtype == torch.float32 and tres.accept_rate.shape == (C,)


def test_fused_run_contract(monkeypatch):
    """backend="fused": T is the largest of (32, 16, 8, 4, 2, 1) dividing
    num_samples and burn_in, the kernel keeps the history of the
    collect_chains prefix only, that prefix equals a full-history run's, and
    the draws stay stationary."""
    calls = []
    kernel = fr.rwmh_multistep_kernel

    def spy(info, transitions, q, lp, scale, n_hist, **kw):
        calls.append((transitions, n_hist))
        return kernel(info, transitions, q, lp, scale, n_hist, **kw)
    monkeypatch.setattr(fr, "rwmh_multistep_kernel", spy)

    t = t_get_target("standard_normal", dim=4)
    q0 = torch.randn((512, 4), generator=torch.Generator().manual_seed(1))
    kw = dict(num_samples=96, scale=1.2, burn_in=32,
              value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    res = tr.rwmh_run(torch.Generator().manual_seed(2), t.log_prob_fn, q0,
                      collect_chains=8, **kw)
    assert calls == [(32, 8)] * 4
    assert res.samples.shape == (96, 8, 4) and res.log_probs.shape == (96, 8)
    full = tr.rwmh_run(torch.Generator().manual_seed(2), t.log_prob_fn, q0, **kw)
    assert full.samples.shape == (96, 512, 4)
    assert torch.equal(full.samples[:, :8], res.samples)
    assert torch.equal(full.final_state.position, res.final_state.position)
    flat = full.samples.reshape(-1, 4)
    assert bool((flat.mean(0).abs() < 0.1).all())
    assert bool(((flat.var(0) - 1.0).abs() < 0.1).all())
    assert 0.2 < float(full.accept_rate.mean()) < 0.6

    calls.clear()
    tr.rwmh_run(torch.Generator().manual_seed(2), t.log_prob_fn, q0[:16],
                num_samples=24, scale=1.2, burn_in=12,
                value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    assert calls == [(4, 16)] * 9


def test_fused_backend_refuses_untagged_targets():
    """Deviation on purpose: the JAX package silently runs its scan for an
    untagged target; the port raises instead of swapping the path."""
    t = t_get_target("standard_normal", dim=3)
    q = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        tr.rwmh_run(torch.Generator(), t.log_prob_fn, q, 8, 1.0, backend="fused")
    with pytest.raises(TypeError):
        tr.rwmh_run(torch.Generator(), t.log_prob_fn, q, 8, 1.0,
                    value_and_grad_fn=lambda x: (x.sum(-1), -x), backend="fused")
    with pytest.raises(ValueError):
        tr.rwmh_run(torch.Generator(), t.log_prob_fn, q, 8, 1.0, backend="xla")


def test_wrapper_validates_and_never_falls_back(monkeypatch, tmp_path):
    """Bad arguments raise; tensors that are not on the CPU launch the kernel
    or raise (meta tensors are refused; with no nvcc the build fails), and
    no launch is counted."""
    t = t_get_target("standard_normal", dim=6)
    info = t.value_and_grad_fn.kernel_info
    q, lp, scale = torch.zeros(4, 6), torch.zeros(4), torch.ones(1)
    key = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fr.rwmh_multistep_kernel(info, 2, q, lp, scale, 4)          # no randomness
    with pytest.raises(ValueError):
        fr.rwmh_multistep_kernel(info, 2, q, lp, scale, 5, key=key)  # n_hist > C
    with pytest.raises(ValueError):
        fr.rwmh_multistep_kernel(info, 2, q, lp, scale, 4, noise=torch.zeros(2, 4, 6))
    with pytest.raises(TypeError):
        fr.rwmh_multistep_kernel(info, 2, q.double(), lp, scale, 4, key=key)

    before = fr.rwmh_multistep_kernel.launches
    meta = [x.to("meta") for x in (q, lp, scale, key)]
    with pytest.raises(ValueError, match="CUDA"):
        fr.rwmh_multistep_kernel(info, 2, *meta[:3], 4, key=meta[3])

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(fr, "_kernel_device", lambda q: None)
    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        fr.rwmh_multistep_kernel(info, 2, *meta[:3], 4, key=meta[3])
    assert fr.rwmh_multistep_kernel.launches == before
