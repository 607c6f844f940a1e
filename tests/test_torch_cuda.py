"""The hand-written CUDA kernels (GRAHMC 1 and 2, RWMH 3, persistent NUTS 4)
against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it runs on a GPU host without the JAX package's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers import nuts_persistent as tn  # noqa: E402
from mcmc_tpu_torch.samplers import rwmh as tr  # noqa: E402
from mcmc_tpu_torch.targets import get_target  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, family, dim, chains, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = get_target(family, dim=dim)
    q = torch.randn((chains, dim), generator=g, device=dev) * 0.5
    lp, grad = t.value_and_grad_fn(q)
    return t.value_and_grad_fn.kernel_info, q, lp.contiguous(), grad.contiguous(), g


def _assert_close(kern, plain, log_u):
    """Accepts equal away from the MH borderline; states within 1e-4."""
    acc_k, acc_p, dh_p = kern[3], plain[3], plain[4]
    border = (log_u - torch.clamp(-dh_p, max=0.0)).abs() < 1e-4
    assert not bool(((acc_k != acc_p) & ~border).any())
    same = acc_k == acc_p
    for a, b in zip(kern[:3], plain[:3]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kern[4][same], dh_p[same], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dim", [1, 3, 50, 128])
@pytest.mark.parametrize("family", ["standard_normal", "neals_funnel"])
@pytest.mark.parametrize("schedule", sorted(ft.SCHEDULE_IDS, key=str))
def test_step_kernel_matches_plain(dev, family, dim, schedule):
    info, q, lp, grad, g = _inputs(dev, family, dim, 1000, dim)
    scalars = ft.kernel_scalars(0.05, 0.7, 3.0, dev)
    inv_mass = torch.rand(dim, generator=g, device=dev) + 0.5
    args = (info, 8, ft.SCHEDULE_IDS[schedule], q, lp, grad, scalars, inv_mass)
    p0 = torch.randn((1000, dim), generator=g, device=dev)
    u = torch.rand(1000, generator=g, device=dev).clamp_min(2.0 ** -25)
    before = ft.grahmc_step_kernel.launches
    kern = ft.grahmc_step_kernel(*args, p0=p0, u=u)
    assert ft.grahmc_step_kernel.launches == before + 1
    _assert_close(kern, ft.grahmc_step_plain(*args, p0=p0, u=u), torch.log(u))
    key = torch.tensor([3, -4], dtype=torch.int32, device=dev)
    kern = ft.grahmc_step_kernel(*args, key=key, call=5)
    _assert_close(kern, ft.grahmc_step_plain(*args, key=key, call=5),
                  torch.log(ft.philox_uniform(key, 5, 0, 1000, dev)))


@pytest.mark.parametrize("family", ["standard_normal", "neals_funnel"])
def test_multistep_kernel_matches_plain(dev, family):
    info, q, lp, grad, g = _inputs(dev, family, 50, 512, 1)
    args = (info, 16, ft.SCHEDULE_IDS["constant"], 8, q, lp, grad,
            ft.kernel_scalars(0.03, 1.0, 1.0, dev), torch.ones(50, device=dev))
    key = torch.tensor([9, 10], dtype=torch.int32, device=dev)
    kern = ft.grahmc_multistep_kernel(*args, key=key, call=2)
    plain = ft.grahmc_multistep_plain(*args, key=key, call=2)
    torch.testing.assert_close(kern[3], plain[3])          # accepts, (T, C)
    for a, b in zip(kern[5:], plain[5:]):                  # histories
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_fused_run_shapes_and_dim_limit(dev):
    t = get_target("neals_funnel", dim=20)
    q = torch.randn((8192, 20), device=dev) * 0.5
    for n_chains, samples in ((8192, 24), (1024, 24)):     # kernel 1, then 2
        res = tg.grahmc_run(torch.Generator(device=dev).manual_seed(0),
                            t.log_prob_fn, q[:n_chains], 0.05, 8, 1.0, 1.0,
                            samples, value_and_grad_fn=t.value_and_grad_fn,
                            collect_chains=16, backend="fused")
        assert res.samples.shape == (samples, 16, 20)
        assert bool(torch.isfinite(res.samples).all())
        assert 0.2 < float(res.accept_rate.mean()) <= 1.0
    wide = get_target("standard_normal", dim=129)
    with pytest.raises(ValueError):
        tg.grahmc_run(torch.Generator(device=dev), wide.log_prob_fn,
                      torch.zeros((4, 129), device=dev), 0.1, 4, 1.0, 1.0, 2,
                      value_and_grad_fn=wide.value_and_grad_fn, backend="fused")


@pytest.mark.parametrize("family,dim", [("standard_normal", 10), ("neals_funnel", 50),
                                        ("neals_funnel", 3), ("standard_normal", 128)])
def test_rwmh_kernel_matches_plain(dev, family, dim):
    """Kernel 3 against its plain version, injected and Philox: accepts
    equal, states and the n_hist-chain histories within 1e-4."""
    info, q, lp, _, g = _inputs(dev, family, dim, 1000, dim)
    scale = fr.rwmh_scale(0.3, dev)
    noise = torch.randn((8, 1000, dim), generator=g, device=dev)
    u = torch.rand((8, 1000), generator=g, device=dev).clamp_min(2.0 ** -25)
    key = torch.tensor([7, -8], dtype=torch.int32, device=dev)
    for rand in (dict(noise=noise, u=u), dict(key=key, call=3)):
        before = fr.rwmh_multistep_kernel.launches
        kern = fr.rwmh_multistep_kernel(info, 8, q, lp, scale, 37, **rand)
        assert fr.rwmh_multistep_kernel.launches == before + 1
        plain = fr.rwmh_multistep_plain(info, 8, q, lp, scale, 37, **rand)
        torch.testing.assert_close(kern[2], plain[2])
        for a, b in zip(kern[:2] + kern[3:], plain[:2] + plain[3:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family,dim,step", [("standard_normal", 10, 0.5),
                                             ("neals_funnel", 50, 0.2)])
@pytest.mark.parametrize("slots", [1, 4])
def test_nuts_window_kernel_matches_plain(dev, family, dim, step, slots):
    """Kernel 4 against its plain version, injected and Philox, over 64
    leapfrog slots: identical discrete state and emitted state within 1e-4 on
    >= 99% of 2048 chains, the trajectory in flight as well on all but a few
    (window_agreement), and transitions completed."""
    info, q, lp, grad, g = _inputs(dev, family, dim, 2048, dim)
    scalars = fn.nuts_scalars(step, 1000.0, dev)
    n_iters = 64 // slots
    draws = (torch.randn((n_iters, 2048, dim), generator=g, device=dev),
             torch.rand((n_iters, 2048), generator=g, device=dev) < 0.5,
             torch.rand((n_iters, 2048), generator=g, device=dev) < 0.5,
             torch.rand((n_iters, 2048), generator=g, device=dev),
             torch.rand((n_iters, 2048), generator=g, device=dev).clamp_min(2.0 ** -25),
             torch.rand((n_iters, 2048), generator=g, device=dev))
    key = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    for rand in (dict(draws=draws), dict(key=key, call=4)):
        args = (info, n_iters, slots, 10)
        start = tn._init_pstate(q, lp, grad, torch.float32)
        before = fn.nuts_window_kernel.launches
        kern = fn.nuts_window_kernel(*args, start, scalars, torch.ones(dim, device=dev),
                                     **rand)
        assert fn.nuts_window_kernel.launches == before + 1
        plain = fn.nuts_window_plain(*args, tn._init_pstate(q, lp, grad, torch.float32),
                                     scalars, torch.ones(dim, device=dev), **rand)
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted
        assert float(kept.float().mean()) >= 0.99, (float(same.float().mean()), err)
        # the funnel's neck is unstable at this step: a rounding difference
        # grows within a subtree until it ends divergent (chip_smoke.py)
        drift = float((kept & ~in_flight).float().mean())
        assert drift <= (0.05 if family == "neals_funnel" else 0.01), drift
        assert int(kern.transitions.sum()) > 0


def test_fused_rwmh_and_nuts_runs(dev):
    """rwmh_run and nuts_run_persistent through their fused backends (auto
    resolves to fused for CUDA tensors): shapes, finite draws, accept."""
    t = get_target("standard_normal", dim=10)
    q = torch.randn((4096, 10), device=dev)
    res = tr.rwmh_run(torch.Generator(device=dev).manual_seed(0), t.log_prob_fn, q,
                      num_samples=64, scale=0.75, collect_chains=16,
                      value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    assert res.samples.shape == (64, 16, 10)
    assert 0.2 < float(res.accept_rate.mean()) < 0.35
    before = fn.nuts_window_kernel.launches
    res = tn.nuts_run_persistent(torch.Generator(device=dev).manual_seed(0), t.log_prob_fn,
                                 q, step_size=0.5, num_samples=8, steps_per_sample=16,
                                 burn_in_steps=16, value_and_grad_fn=t.value_and_grad_fn,
                                 collect_chains=16)
    assert fn.nuts_window_kernel.launches == before + 9
    assert res.samples.shape == (8, 16, 10)
    assert bool(torch.isfinite(res.samples).all())
    assert 0.5 < float(res.info["mean_accept_probs"].mean()) <= 1.0
    assert int(res.info["n_leapfrogs"]) <= int(res.info["n_leapfrog_slots"])
