"""The hand-written CUDA kernels (GRAHMC 1 and 2 with their dense variants
1a and 2a and 1's scaled and bridged variants 1b and 1c, RWMH 3, persistent
NUTS 4 with its multinomial and dense variants, and each of them on the
data-carrying hierarchical posterior: 1d, 2b, 3a, 4c) against their plain
versions, on the card, for every target family (Rosenbrock and the RAHMC
paper's among them, with the L1 shell cap), and the dense warmup,
tempered, SMC and persistent-NUTS-warmup runs that run them; the
tune-and-sample CLI's launches, the profiler's trace and the compat API.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it runs on a GPU host without the JAX package's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from mcmc_tpu_torch.ops import fused_rwmh as fr  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.ops import padded_targets as pt  # noqa: E402
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


def _dense_metric(dev, dim, g):
    a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
    return ft.prepare_dense_metric(a @ a.T / dim + 0.5 * torch.eye(dim, device=dev,
                                                                   dtype=torch.float64))


@pytest.mark.parametrize("dim", [1, 3, 50, 128])
@pytest.mark.parametrize("family", ["standard_normal", "neals_funnel", "correlated_gaussian"])
def test_dense_kernels_match_plain(dev, family, dim):
    """Kernels 1a and 2a against their plain versions with a random dense
    metric, injected and Philox: accepts equal away from the MH borderline,
    states within 1e-4 (1a); each chain's accept sequence and history
    within 1e-4 on >= 99% of chains (2a, T = 4); the dense launch counts."""
    info, q, lp, grad, g = _inputs(dev, family, dim, 1000, dim + 7)
    invm, l_inv = _dense_metric(dev, dim, g)
    eps = 0.02 if family == "neals_funnel" else 0.05
    scalars = ft.kernel_scalars(eps, 0.7, 3.0, dev)
    args = (info, 8, ft.SCHEDULE_IDS["constant"], q, lp, grad, scalars, invm)
    p0 = ft.unwhiten(torch.randn((1000, dim), generator=g, device=dev), invm, l_inv)
    u = torch.rand(1000, generator=g, device=dev).clamp_min(2.0 ** -25)
    key = torch.tensor([3, -4], dtype=torch.int32, device=dev)
    for rand, log_u in ((dict(p0=p0, u=u), torch.log(u)),
                        (dict(key=key, call=5),
                         torch.log(ft.philox_uniform(key, 5, 0, 1000, dev)))):
        before = dict(ft.grahmc_step_kernel.variant_launches)
        kern = ft.grahmc_step_kernel(*args, l_inv=l_inv, **rand)
        assert ft.grahmc_step_kernel.variant_launches == dict(before, dense=before["dense"] + 1)
        _assert_close(kern, ft.grahmc_step_plain(*args, l_inv=l_inv, **rand), log_u)

        margs = args[:3] + (4,) + args[3:]
        mrand = dict(key=key, call=5) if "key" in rand else dict(
            p0=p0.expand(4, -1, -1).contiguous(), u=u.expand(4, -1).contiguous())
        before = ft.grahmc_multistep_kernel.variant_launches["dense"]
        kern = ft.grahmc_multistep_kernel(*margs, l_inv=l_inv, **mrand)
        assert ft.grahmc_multistep_kernel.variant_launches["dense"] == before + 1
        plain = ft.grahmc_multistep_plain(*margs, l_inv=l_inv, **mrand)
        agree = (kern[3] == plain[3]).all(dim=0)
        assert float(agree.float().mean()) >= 0.99
        for a, b in zip(kern[5:], plain[5:]):
            torch.testing.assert_close(a[:, agree], b[:, agree], rtol=1e-4, atol=1e-4)


def test_dense_warmup_on_the_card(dev, monkeypatch):
    """run_adaptive_warmup(learn_mass_matrix="dense") at 1,024 chains of the
    10-D rho = 0.9 Gaussian: "auto" runs kernel 1a for every warmup and tune
    transition (never the eager step), and the metric learns rho."""
    from mcmc_tpu_torch import tuning
    from mcmc_tpu_torch.tuning import sequential

    def eager_step(*a, **k):
        raise AssertionError("the fused warmup ran the eager step")
    monkeypatch.setattr(sequential, "grahmc_step", eager_step)
    t = get_target("correlated_gaussian", dim=10)
    q = torch.randn((1024, 10), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev) * 0.5
    ft.reset_launches()
    step, inv_mass, pos, info = tuning.run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, q, torch.Generator(device=dev).manual_seed(1),
        num_warmup=425, learn_mass_matrix="dense", num_steps=8, schedule_type="constant",
        value_and_grad_fn=t.value_and_grad_fn, exploration_steps=100,
        adaptation_windows=[25, 50, 125], cooldown_steps=125, max_iter_step=100,
        gamma_samples_per_eval=25)
    # 1 + 1 + 1 + 2 + 2 batches of 100 steps, then 7 evaluations of 100 + 25
    assert ft.grahmc_step_kernel.variant_launches == {"diagonal": 0, "dense": 700 + 875,
                                                      "diagonal+data": 0, "dense+data": 0}
    corr = inv_mass / torch.sqrt(torch.outer(torch.diagonal(inv_mass),
                                             torch.diagonal(inv_mass)))
    assert float(corr[~torch.eye(10, dtype=torch.bool, device=dev)].min()) > 0.5
    assert step > 0 and bool(torch.isfinite(pos).all())
    assert 0.4 < sum(info["accept_trace"][-2:]) / 2 < 0.9


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


@pytest.mark.parametrize("multinomial,dense,family,dim,step", [
    (True, False, "neals_funnel", 50, 0.2), (True, False, "standard_normal", 10, 0.5),
    (False, True, "correlated_gaussian", 50, 0.3), (True, True, "correlated_gaussian", 50, 0.3),
    (False, False, "correlated_gaussian", 50, 0.3), (True, True, "standard_normal", 128, 0.3)])
def test_nuts_window_variants_match_plain(dev, multinomial, dense, family, dim, step):
    """Kernel 4's multinomial and dense variants (and the correlated
    Gaussian's device function) against their plain versions, injected and
    Philox, W = 4 over 64 slots from a state one window in: as
    test_nuts_window_kernel_matches_plain, with the variant's own launch
    count."""
    info, q, lp, grad, g = _inputs(dev, family, dim, 2048, dim)
    scalars = fn.nuts_scalars(step, 1000.0, dev)
    if dense:
        a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
        metric = a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64)
    else:
        metric = torch.rand(dim, generator=g, device=dev) + 0.5
    inv_mass, l_inv = ft.kernel_metric(metric)
    key = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    args = (info, 16, 4, 10)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    n_slice = 64 if multinomial else 16
    draws = (torch.randn((16, 2048, dim), generator=g, device=dev),
             torch.rand((16, 2048), generator=g, device=dev) < 0.5,
             torch.rand((16, 2048), generator=g, device=dev) < 0.5,
             torch.rand((16, 2048), generator=g, device=dev),
             torch.rand((n_slice, 2048), generator=g, device=dev).clamp_min(2.0 ** -25),
             torch.rand((16, 2048), generator=g, device=dev))
    name = fn.VARIANTS[(multinomial, dense)]
    for rand in (dict(draws=draws), dict(key=key, call=4)):
        def clone():
            return tn._PState(*(None if t is None else t.clone() for t in warm))
        before = fn.nuts_window_kernel.variant_launches[name]
        kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        assert fn.nuts_window_kernel.variant_launches[name] == before + 1
        plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted
        assert float(kept.float().mean()) >= 0.99, (float(same.float().mean()), err)
        drift = float((kept & ~in_flight).float().mean())
        assert drift <= (0.05 if family == "neals_funnel" else 0.01), drift
        assert int((kern.transitions - warm.transitions).sum()) > 0


def test_fused_multinomial_dense_run(dev):
    """nuts_run_persistent with the multinomial scheme and the oracle dense
    metric on the card: one kernel 4 call per window, all of the
    multinomial+dense variant, and the correlated Gaussian's covariance."""
    t = get_target("correlated_gaussian", dim=20)
    q = torch.randn((4096, 20), device=dev)
    fn.reset_launches()
    res = tn.nuts_run_persistent(torch.Generator(device=dev).manual_seed(0), t.log_prob_fn,
                                 q, step_size=0.5, num_samples=64, steps_per_sample=16,
                                 burn_in_steps=32, inv_mass_matrix=t.true_cov.to(dev),
                                 value_and_grad_fn=t.value_and_grad_fn,
                                 proposal_scheme="multinomial")
    assert fn.nuts_window_kernel.variant_launches["multinomial+dense"] == 65
    assert fn.nuts_window_kernel.launches == 65
    s = res.samples.reshape(-1, 20).double()
    assert float((torch.cov(s.T) - t.true_cov.to(dev)).abs().max()) < 0.1


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


def _rand(dev, g, n, dim, invm=None, l_inv=None):
    """Injected (p0, u) and Philox randomness, each with its log u."""
    z = torch.randn((n, dim), generator=g, device=dev)
    p0 = z if invm is None else ft.unwhiten(z, invm, l_inv)
    u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
    key = torch.tensor([11, -12], dtype=torch.int32, device=dev)
    return ((dict(p0=p0.contiguous(), u=u), torch.log(u)),
            (dict(key=key, call=3), torch.log(ft.philox_uniform(key, 3, 0, n, dev))))


@pytest.mark.parametrize("dim", [1, 10, 128])
@pytest.mark.parametrize("family", ["standard_normal", "neals_funnel", "correlated_gaussian",
                                    "gaussian_mixture"])
def test_mixture_in_kernels_1_and_2(dev, family, dim):
    """The gaussian_mixture device function in kernels 1 and 2 beside the
    other families: kernel against plain version, injected and Philox."""
    info, q, lp, grad, g = _inputs(dev, family, dim, 1000, dim + 3)
    args = (info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad,
            ft.kernel_scalars(0.05, 0.1, 5.0, dev), torch.ones(dim, device=dev))
    for rand, log_u in _rand(dev, g, 1000, dim):
        _assert_close(ft.grahmc_step_kernel(*args, **rand),
                      ft.grahmc_step_plain(*args, **rand), log_u)
    key = torch.tensor([9, 10], dtype=torch.int32, device=dev)
    margs = args[:3] + (4,) + args[3:]
    kern = ft.grahmc_multistep_kernel(*margs, key=key, call=2)
    plain = ft.grahmc_multistep_plain(*margs, key=key, call=2)
    agree = (kern[3] == plain[3]).all(dim=0)
    assert float(agree.float().mean()) >= 0.99
    for a, b in zip(kern[5:], plain[5:]):
        torch.testing.assert_close(a[:, agree], b[:, agree], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("dim", [1, 10, 50, 128])
@pytest.mark.parametrize("family", ["standard_normal", "neals_funnel", "correlated_gaussian",
                                    "gaussian_mixture"])
def test_scaled_and_bridged_kernels_match_plain(dev, family, dim, dense):
    """Kernels 1b (three rungs of 400 rows, their own steps and betas) and
    1c (beta 0.05, 0.5, 1; base N(0.5, 2^2 I)) against their plain
    versions, injected and Philox: accepts equal away from the MH
    borderline, states within 1e-4; each variant's launch count."""
    n_rungs, chains = 3, 400
    n = n_rungs * chains
    info, q, lp, grad, g = _inputs(dev, family, dim, n, dim + 5)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) + 0.5, None)
    eps = 0.02 if family == "neals_funnel" else 0.05
    betas = torch.tensor([1.0, 0.3, 0.05], device=dev)
    rungs = ft.rung_table(eps / torch.sqrt(betas), 0.1, 5.0, betas, dev)
    beta_row = betas.repeat_interleave(chains)
    sargs = (info, 8, ft.SCHEDULE_IDS["tanh"], q, (beta_row * lp).contiguous(),
             (beta_row[:, None] * grad).contiguous(), rungs, invm)
    variant = "dense" if dense else "diagonal"
    for rand, log_u in _rand(dev, g, n, dim, invm if dense else None, l_inv):
        before = ft.grahmc_scaled_kernel.variant_launches[variant]
        kern = ft.grahmc_scaled_kernel(*sargs, l_inv=l_inv, **rand)
        assert ft.grahmc_scaled_kernel.variant_launches[variant] == before + 1
        _assert_close(kern, ft.grahmc_scaled_plain(*sargs, l_inv=l_inv, **rand), log_u)

    base = ft.bridge_base(0.5, 2.0, dim, dev)
    for beta in (0.05, 0.5, 1.0):
        mixture = ft.bridged_vag(ft.device_vag(info), torch.tensor(beta, device=dev),
                                 torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                 base.mean, base.inv_scale)
        blp, bgrad = mixture(q)
        bargs = (info, 8, 0, q, blp.contiguous(), bgrad.contiguous(),
                 ft.bridge_scalars(eps, 0.0, 1.0, beta, base.log_norm, dev), base.mean,
                 base.inv_scale, invm)
        for rand, log_u in _rand(dev, g, n, dim, invm if dense else None, l_inv):
            before = ft.grahmc_bridged_kernel.variant_launches[variant]
            kern = ft.grahmc_bridged_kernel(*bargs, l_inv=l_inv, **rand)
            assert ft.grahmc_bridged_kernel.variant_launches[variant] == before + 1
            _assert_close(kern, ft.grahmc_bridged_plain(*bargs, l_inv=l_inv, **rand), log_u)


@pytest.mark.parametrize("family", ["standard_normal", "gaussian_mixture"])
def test_variants_at_beta_one_equal_kernel_1_bit_for_bit(dev, family):
    """At beta = 1 kernels 1b (one rung) and 1c give kernel 1's results bit
    for bit, injected and Philox."""
    info, q, lp, grad, g = _inputs(dev, family, 10, 2048, 17)
    ones = torch.ones(10, device=dev)
    base = ft.bridge_base(0.0, 6.0, 10, dev)
    for rand, _ in _rand(dev, g, 2048, 10):
        plain = ft.grahmc_step_kernel(info, 16, 2, q, lp, grad,
                                      ft.kernel_scalars(0.3, 0.1, 5.0, dev), ones, **rand)
        scaled = ft.grahmc_scaled_kernel(info, 16, 2, q, lp, grad,
                                         ft.rung_table(0.3, 0.1, 5.0, 1.0, dev), ones, **rand)
        bridged = ft.grahmc_bridged_kernel(
            info, 16, 2, q, lp, grad, ft.bridge_scalars(0.3, 0.1, 5.0, 1.0, base.log_norm, dev),
            base.mean, base.inv_scale, ones, **rand)
        for out in (scaled, bridged):
            for a, b in zip(out, plain):
                assert torch.equal(a, b)


def test_tempered_and_smc_runs_on_the_card(dev):
    """tempered_run and smc_run on CUDA tensors resolve "auto" to their
    fused backends: one kernel-1b launch per sweep, one kernel-1c launch
    per SMC move, no kernel 1; the cold replica keeps N(0, I), SMC's log Z
    reads 0 on the normalized mixture and finds both modes."""
    from mcmc_tpu_torch.samplers import smc_run, tempered_run
    t = get_target("standard_normal", dim=4)
    q = torch.randn((512, 4), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev) * 0.2
    ft.reset_launches()
    res = tempered_run(torch.Generator(device=dev).manual_seed(0), t.log_prob_fn, q, 0.5, 8,
                       300, burn_in=100, n_temps=4, value_and_grad_fn=t.value_and_grad_fn)
    assert ft.grahmc_scaled_kernel.launches == 400
    assert ft.grahmc_step_kernel.launches == 0
    m = res.samples.reshape(-1, 4)
    assert float(m.mean(0).abs().max()) < 0.05 and float((m.var(0) - 1).abs().max()) < 0.08
    sw = res.info["swap_accept_rate"]
    assert sw.shape == (3,) and bool(((sw > 0.05) & (sw < 1.0)).all())

    mt = get_target("gaussian_mixture", dim=10)
    ft.reset_launches()
    r = smc_run(torch.Generator(device=dev).manual_seed(4), mt.log_prob_fn, 8192, 10, 0.4, 8,
                move_steps=2, base_scale=6.0, value_and_grad_fn=mt.value_and_grad_fn,
                final_resample=True)
    assert ft.grahmc_bridged_kernel.launches == 2 * r.info["n_stages"]
    assert ft.grahmc_step_kernel.launches == 0
    assert abs(float(r.log_Z)) < 0.1
    assert 0.4 < float((r.particles[:, 0] > 0).float().mean()) < 0.6


HIER = "hierarchical_logistic"


def _hier(dev, dim, n_data, chains, seed):
    """The hierarchical posterior's kernel_info, a state from its init
    sampler spread twice as wide, and a generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = get_target(HIER, dim=dim, n_data=n_data)
    q = t.init_sampler(g, chains) * 2.0
    lp, grad = t.value_and_grad_fn(q)
    return t.value_and_grad_fn.kernel_info, q, lp.contiguous(), grad.contiguous(), g


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("dim,n_data", [(9, 20), (20, 64), (100, 256), (128, 33)])
def test_hierarchical_kernels_1_and_2_match_plain(dev, dim, n_data, dense):
    """Kernels 1d and 2b (and their dense forms) against their plain
    versions on the hierarchical posterior, injected and Philox: accepts
    equal away from the MH borderline, states within 1e-4 (kernel 1); each
    chain's accept sequence and history within 1e-4 on >= 99% of chains
    (kernel 2, T = 4); the data variants' launch counts."""
    info, q, lp, grad, g = _hier(dev, dim, n_data, 1000, dim + n_data)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) * 0.5 + 0.25, None)
    eps = (0.2 if dim <= 20 else 0.1) if dense else (0.3 if dim <= 20 else 0.2)
    args = (info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad,
            ft.kernel_scalars(eps, 0.5, 0.5, dev), invm)
    name = "dense+data" if dense else "diagonal+data"
    for rand, log_u in _rand(dev, g, 1000, dim, invm if dense else None, l_inv):
        before = ft.grahmc_step_kernel.variant_launches[name]
        kern = ft.grahmc_step_kernel(*args, l_inv=l_inv, **rand)
        assert ft.grahmc_step_kernel.variant_launches[name] == before + 1
        plain = ft.grahmc_step_plain(*args, l_inv=l_inv, **rand)
        assert 0.05 < float(plain[3].float().mean()) < 0.99
        _assert_close(kern, plain, log_u)
    key = torch.tensor([9, 10], dtype=torch.int32, device=dev)
    margs = args[:3] + (4,) + args[3:]
    before = ft.grahmc_multistep_kernel.variant_launches[name]
    kern = ft.grahmc_multistep_kernel(*margs, key=key, call=2, l_inv=l_inv)
    assert ft.grahmc_multistep_kernel.variant_launches[name] == before + 1
    plain = ft.grahmc_multistep_plain(*margs, key=key, call=2, l_inv=l_inv)
    agree = (kern[3] == plain[3]).all(dim=0)
    assert float(agree.float().mean()) >= 0.99
    for a, b in zip(kern[5:], plain[5:]):
        torch.testing.assert_close(a[:, agree], b[:, agree], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("dim", [20, 100])
def test_hierarchical_scaled_and_bridged_match_plain(dev, dim, dense):
    """Kernels 1b and 1c on the hierarchical posterior (its data-carrying
    form, which tempering and SMC reach through "auto") against their plain
    versions, injected and Philox."""
    n_rungs, chains = 3, 400
    n = n_rungs * chains
    info, q, lp, grad, g = _hier(dev, dim, 64, n, dim + 5)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) * 0.05 + 0.02, None)
    eps = 0.02 if dense else 0.1
    betas = torch.tensor([1.0, 0.3, 0.05], device=dev)
    rungs = ft.rung_table(eps / torch.sqrt(betas), 0.1, 5.0, betas, dev)
    beta_row = betas.repeat_interleave(chains)
    sargs = (info, 8, ft.SCHEDULE_IDS["tanh"], q, (beta_row * lp).contiguous(),
             (beta_row[:, None] * grad).contiguous(), rungs, invm)
    name = "dense+data" if dense else "diagonal+data"
    for rand, log_u in _rand(dev, g, n, dim, invm if dense else None, l_inv):
        before = ft.grahmc_scaled_kernel.variant_launches[name]
        kern = ft.grahmc_scaled_kernel(*sargs, l_inv=l_inv, **rand)
        assert ft.grahmc_scaled_kernel.variant_launches[name] == before + 1
        _assert_close(kern, ft.grahmc_scaled_plain(*sargs, l_inv=l_inv, **rand), log_u)
    base = ft.bridge_base(0.0, 1.5, dim, dev)
    for beta in (0.05, 1.0):
        mixture = ft.bridged_vag(ft.device_vag(info), torch.tensor(beta, device=dev),
                                 torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                 base.mean, base.inv_scale)
        blp, bgrad = mixture(q)
        bargs = (info, 8, 0, q, blp.contiguous(), bgrad.contiguous(),
                 ft.bridge_scalars(eps, 0.0, 1.0, beta, base.log_norm, dev), base.mean,
                 base.inv_scale, invm)
        for rand, log_u in _rand(dev, g, n, dim, invm if dense else None, l_inv):
            before = ft.grahmc_bridged_kernel.variant_launches[name]
            kern = ft.grahmc_bridged_kernel(*bargs, l_inv=l_inv, **rand)
            assert ft.grahmc_bridged_kernel.variant_launches[name] == before + 1
            _assert_close(kern, ft.grahmc_bridged_plain(*bargs, l_inv=l_inv, **rand), log_u)


@pytest.mark.parametrize("dim,n_data", [(5, 20), (9, 20), (20, 64), (100, 256), (128, 33),
                                        (9, 50), (9, 1000), (20, 50), (20, 256), (20, 1000),
                                        (100, 50), (100, 1000)])
def test_hierarchical_rwmh_kernel_matches_plain(dev, dim, n_data):
    """Kernel 3a (block-tiled, the log-density alone in kernel 3's lane
    layout: G = 2, 4, 8 and 32 lanes a chain sum its rows here) against its
    plain version over X's row tiles of 128 (n_data 50: one partial tile;
    1,000: eight, through both buffers), 1,000 chains (a ragged last
    block), injected and Philox: accepts equal, states and histories within
    1e-4."""
    info, q, lp, _, g = _hier(dev, dim, n_data, 1000, dim)
    scale = fr.rwmh_scale(0.3 / dim ** 0.5, dev)
    noise = torch.randn((8, 1000, dim), generator=g, device=dev)
    u = torch.rand((8, 1000), generator=g, device=dev).clamp_min(2.0 ** -25)
    key = torch.tensor([7, -8], dtype=torch.int32, device=dev)
    for rand in (dict(noise=noise, u=u), dict(key=key, call=3)):
        before = fr.rwmh_multistep_kernel.variant_launches["rwmh+data"]
        kern = fr.rwmh_multistep_kernel(info, 8, q, lp, scale, 37, **rand)
        assert fr.rwmh_multistep_kernel.variant_launches["rwmh+data"] == before + 1
        plain = fr.rwmh_multistep_plain(info, 8, q, lp, scale, 37, **rand)
        assert 0.05 < float(plain[2].float().mean()) < 1.0
        torch.testing.assert_close(kern[2], plain[2])
        for a, b in zip(kern[:2] + kern[3:], plain[:2] + plain[3:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("multinomial,dense", [(False, False), (True, False), (False, True),
                                               (True, True)])
@pytest.mark.parametrize("dim", [20, 100])
def test_hierarchical_nuts_window_matches_plain(dev, dim, multinomial, dense):
    """Kernel 4c (and the multinomial and dense forms on the hierarchical
    posterior) against its plain version, injected and Philox, W = 4 over 64
    slots from a state one window in: window_agreement's split and drift
    rule, each variant's own launch count."""
    info, q, lp, grad, g = _hier(dev, dim, 64, 2048, dim)
    scalars = fn.nuts_scalars(0.05 if dense else 0.15, 1000.0, dev)
    metric = (_dense_metric(dev, dim, g)[0] * 0.1 if dense else
              torch.rand(dim, generator=g, device=dev) * 0.05 + 0.02)
    inv_mass, l_inv = ft.kernel_metric(metric)
    key = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    args = (info, 16, 4, 10)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    n_slice = 64 if multinomial else 16
    draws = (torch.randn((16, 2048, dim), generator=g, device=dev),
             torch.rand((16, 2048), generator=g, device=dev) < 0.5,
             torch.rand((16, 2048), generator=g, device=dev) < 0.5,
             torch.rand((16, 2048), generator=g, device=dev),
             torch.rand((n_slice, 2048), generator=g, device=dev).clamp_min(2.0 ** -25),
             torch.rand((16, 2048), generator=g, device=dev))
    name = fn.variant(warm, inv_mass, info)
    assert name.endswith("+data")
    for rand in (dict(draws=draws), dict(key=key, call=4)):
        def clone():
            return tn._PState(*(None if t is None else t.clone() for t in warm))
        before = fn.nuts_window_kernel.variant_launches[name]
        kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        assert fn.nuts_window_kernel.variant_launches[name] == before + 1
        plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted
        assert float(kept.float().mean()) >= 0.999, (float(same.float().mean()), err)
        assert float((kept & ~in_flight).float().mean()) <= 0.01
        assert int((kern.transitions - warm.transitions).sum()) > 0


def test_hierarchical_runs_take_the_data_kernels(dev):
    """On CUDA positions of the hierarchical posterior "auto" resolves to
    the fused paths, and every launch is a data variant's: the windowed
    warmup (kernel 1d), grahmc_run at <= 4,096 chains (2b), rwmh_run (3a),
    nuts_run_persistent (4c)."""
    from mcmc_tpu_torch import tuning
    t = get_target(HIER, dim=20, n_data=64)
    q = t.init_sampler(torch.Generator(device=dev).manual_seed(0), 1024)
    ft.reset_launches()
    fr.reset_launches()
    fn.reset_launches()
    step, inv_mass, pos, info = tuning.run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, q, torch.Generator(device=dev).manual_seed(1),
        num_warmup=425, learn_mass_matrix=True, num_steps=8, schedule_type="tanh",
        value_and_grad_fn=t.value_and_grad_fn, exploration_steps=100,
        adaptation_windows=[25, 50, 125], cooldown_steps=125, max_iter_step=100,
        gamma_samples_per_eval=25)
    assert ft.grahmc_step_kernel.variant_launches["diagonal+data"] == 700 + 875
    res = tg.grahmc_run(torch.Generator(device=dev).manual_seed(2), t.log_prob_fn, pos, step,
                        8, info["gamma"], info["steepness"], 64, inv_mass_matrix=inv_mass,
                        friction_schedule=tg.tanh_schedule,
                        value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    assert ft.grahmc_multistep_kernel.variant_launches["diagonal+data"] == 8
    assert 0.5 < float(res.accept_rate.mean()) < 0.8
    tr.rwmh_run(torch.Generator(device=dev).manual_seed(3), t.log_prob_fn, pos, 64,
                0.1, value_and_grad_fn=t.value_and_grad_fn, backend="fused")
    assert fr.rwmh_multistep_kernel.variant_launches == {"rwmh": 0, "rwmh+data": 2}
    tn.nuts_run_persistent(torch.Generator(device=dev).manual_seed(4), t.log_prob_fn, pos,
                           step_size=step, num_samples=8, steps_per_sample=16,
                           inv_mass_matrix=inv_mass, value_and_grad_fn=t.value_and_grad_fn)
    assert fn.nuts_window_kernel.variant_launches["endpoint+data"] == 8
    assert fn.nuts_window_kernel.launches == 8


def test_smc_draws_repeat(dev):
    """smc_run calls with one seed on the card give the same log Z and
    particles bit for bit (the resampling CDF is summed in a fixed order):
    chip_smoke.py's SMC row, its five seeds, three runs each. With
    torch.cumsum's CDF, runs of these seeds differed in three of four
    processes on an H100 (chip_smoke.py --smc-repeat)."""
    from mcmc_tpu_torch.samplers import smc_run
    mt = get_target("gaussian_mixture", dim=10)
    for seed in range(60, 65):
        runs = [smc_run(torch.Generator(device=dev).manual_seed(seed), mt.log_prob_fn, 32768,
                        10, 0.4, 8, move_steps=2, base_scale=6.0,
                        value_and_grad_fn=mt.value_and_grad_fn, final_resample=True)
                for _ in range(3)]
        assert runs[0].info["n_resamples"] > 0
        for r in runs[1:]:
            assert torch.equal(runs[0].log_Z, r.log_Z), seed
            assert torch.equal(runs[0].particles, r.particles), seed


NEW_FAMILIES = ["neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t",
                "log_gamma", "log_gamma_unconstrained"]
# the families' bounds at these tests' sizes: kernels 1, 1b, 1c's drifted
# proposals and proposals diverged apart (each rejected by both) of 1,200
# chains, kernel 4's drifted trajectories in flight of 2,048; ~4x the
# largest count read on an H100 (log_gamma 1, 5 and 8; the unconstrained
# gamma's 1b with a dense metric at D 50-128, whose hot rungs' leapfrog
# diverges in both versions, 0, 181 and 0; every other family 0, 0 and 0)
FAMILY_DRIFT = {"log_gamma": (4, 20, 32), "log_gamma_unconstrained": (0, 724, 2)}
FAMILY_STEP = {"neals_funnel_noncentered": 0.3, "ill_conditioned_gaussian": 0.3,
               "student_t": 0.3, "log_gamma": 0.1, "log_gamma_unconstrained": 0.2,
               "correlated_gaussian": 0.1, "gaussian_mixture": 0.3, "standard_normal": 0.3}


def _family_inputs(dev, family, dim, chains, seed):
    """(info, q, lp, grad, generator) with q in the family's bulk: log_gamma
    away from its support's boundary, the ill-conditioned Gaussian at its
    scales, the mixture half in each mode."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = get_target(family, dim=dim)
    q = torch.randn((chains, dim), generator=g, device=dev) * 0.5
    if family == "log_gamma":
        q = torch.rand((chains, dim), generator=g, device=dev) * 2.0 + 0.5
    elif family == "log_gamma_unconstrained":
        q = q + 0.4
    elif family == "ill_conditioned_gaussian":
        q = q * torch.sqrt(torch.linspace(1.0, 100.0, dim, device=dev))
    elif family == "gaussian_mixture":
        q = t.init_sampler(g, chains)
    lp, grad = t.value_and_grad_fn(q)
    return t.value_and_grad_fn.kernel_info, q, lp.contiguous(), grad.contiguous(), g


def _assert_close_or_drift(kern, plain, log_u, max_drift, max_wild, label=""):
    """_assert_close where the geometry may amplify rounding (log_gamma's
    (shape - 1) / x near its boundary, Student-t's convex tails): accepts
    equal away from the MH borderline; a proposal apart from the plain
    version's (beyond 1e-4) drifted, on at most `max_drift` chains (one
    trajectory diverging alone counts here), or diverged apart where both
    trajectories diverged (|delta H| >= 1000), on at most `max_wild`
    chains, each rejected by both; the new state within 1e-4 wherever the
    accepts agree but on accepted drifted chains. With a `label`, prints
    the counts."""
    acc_k, acc_p, dh_p = kern[3], plain[3], plain[4]
    border = (log_u - torch.clamp(-dh_p, max=0.0)).abs() < 1e-4
    assert not bool(((acc_k != acc_p) & ~border).any())
    same = acc_k == acc_p
    close = ((kern[5] - plain[5]).abs() <= 1e-4 + 1e-4 * plain[5].abs()).all(dim=1)
    apart = same & ~close
    both = (kern[4].abs() >= 1000.0) & (dh_p.abs() >= 1000.0)
    drifted, wild = int((apart & ~both).sum()), int((apart & both).sum())
    if label:
        print(f"READING {label}: drifted {drifted}, diverged apart {wild}")
    assert drifted <= max_drift and wild <= max_wild, (drifted, wild)
    assert not bool((apart & both & acc_k).any())
    in_step = same & (close | ~acc_k)
    for a, b in zip(kern[:3], plain[:3]):
        torch.testing.assert_close(a[in_step], b[in_step], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("dim", [1, 10, 50, 128])
@pytest.mark.parametrize("family", NEW_FAMILIES)
def test_new_families_in_kernel_1_2_and_variants(dev, family, dim, dense):
    """Each family of the ChEES slice in kernel 1 (1a dense), 1b (three
    rungs), 1c (beta 0.5) and kernel 2 (2a; T = 4) against the plain
    versions, injected and Philox, with each variant's launch count."""
    n = 1200
    info, q, lp, grad, g = _family_inputs(dev, family, dim, n, dim + 11)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) + 0.5, None)
    eps, variant = FAMILY_STEP[family], "dense" if dense else "diagonal"
    drift, wild, _ = FAMILY_DRIFT.get(family, (0, 0, 2))
    args = (info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad, ft.kernel_scalars(eps, 0.3, 2.0, dev),
            invm)
    betas = torch.tensor([1.0, 0.3, 0.05], device=dev)
    beta_row = betas.repeat_interleave(n // 3)
    sargs = args[:4] + ((beta_row * lp).contiguous(), (beta_row[:, None] * grad).contiguous(),
                        ft.rung_table(eps / torch.sqrt(betas), 0.3, 2.0, betas, dev), invm)
    base = ft.bridge_base(0.5, 2.0, dim, dev)
    mixture = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                             torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                             base.mean, base.inv_scale)
    blp, bgrad = mixture(q)
    bargs = (info, 8, 0, q, blp.contiguous(), bgrad.contiguous(),
             ft.bridge_scalars(eps, 0.0, 1.0, 0.5, base.log_norm, dev), base.mean,
             base.inv_scale, invm)
    cases = ((ft.grahmc_step_kernel, ft.grahmc_step_plain, args),
             (ft.grahmc_scaled_kernel, ft.grahmc_scaled_plain, sargs),
             (ft.grahmc_bridged_kernel, ft.grahmc_bridged_plain, bargs))
    for kernel, plain_fn, a in cases:
        for rand, log_u in _rand(dev, g, n, dim, invm if dense else None, l_inv):
            before = kernel.variant_launches[variant]
            kern = kernel(*a, l_inv=l_inv, **rand)
            assert kernel.variant_launches[variant] == before + 1
            _assert_close_or_drift(kern, plain_fn(*a, l_inv=l_inv, **rand), log_u, drift, wild)
    key = torch.tensor([9, 10], dtype=torch.int32, device=dev)
    margs = args[:3] + (4,) + args[3:]
    before = ft.grahmc_multistep_kernel.variant_launches[variant]
    kern = ft.grahmc_multistep_kernel(*margs, key=key, call=2, l_inv=l_inv)
    assert ft.grahmc_multistep_kernel.variant_launches[variant] == before + 1
    plain = ft.grahmc_multistep_plain(*margs, key=key, call=2, l_inv=l_inv)
    agree = (kern[3] == plain[3]).all(dim=0)
    close = ((kern[5] - plain[5]).abs() <= 1e-4 + 1e-4 * plain[5].abs()).all(dim=2).all(dim=0)
    calm = ((kern[4].abs() < 1000.0) & (plain[4].abs() < 1000.0)).all(dim=0)
    split, drifted = int((~agree).sum()), int((agree & ~close & calm).sum())
    assert split <= 2 and drifted <= drift, (split, drifted)
    torch.testing.assert_close(kern[6][:, agree & close], plain[6][:, agree & close],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim", [1, 10, 50, 128])
@pytest.mark.parametrize("family", NEW_FAMILIES + ["correlated_gaussian", "gaussian_mixture"])
def test_new_families_in_kernel_3(dev, family, dim):
    """Kernel 3's log-density in its lane groups for the ChEES slice's
    families and the two it gains (the correlated Gaussian, the mixture)
    against the plain version, injected and Philox: accepts equal, states
    and histories within 1e-4."""
    info, q, lp, _, g = _family_inputs(dev, family, dim, 1000, dim + 2)
    lp = pt.device_lp(info)(q).contiguous()
    scale = fr.rwmh_scale(0.5 * FAMILY_STEP[family], dev)
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


@pytest.mark.parametrize("multinomial,dense", [(False, False), (True, False), (False, True),
                                               (True, True)])
@pytest.mark.parametrize("family", NEW_FAMILIES + ["gaussian_mixture"])
def test_new_families_in_kernel_4(dev, family, multinomial, dense):
    """Kernel 4 and its variants on the ChEES slice's families and the
    mixture, D = 10, W = 4 over 64 slots from a state one window in, Philox:
    window_agreement as test_nuts_window_variants_match_plain's."""
    dim, n = 10, 2048
    info, q, lp, grad, g = _family_inputs(dev, family, dim, n, 3)
    step = 1.0 if family == "ill_conditioned_gaussian" else FAMILY_STEP[family]
    scalars = fn.nuts_scalars(step, 1000.0, dev)
    if dense:
        metric = _dense_metric(dev, dim, g)
        inv_mass, l_inv = metric
    else:
        inv_mass, l_inv = torch.rand(dim, generator=g, device=dev) + 0.5, None
    key = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    args = (info, 16, 4, 10)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    name = fn.VARIANTS[(multinomial, dense)]

    def clone():
        return tn._PState(*(None if t is None else t.clone() for t in warm))
    before = fn.nuts_window_kernel.variant_launches[name]
    kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, l_inv=l_inv, key=key, call=4)
    assert fn.nuts_window_kernel.variant_launches[name] == before + 1
    plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, l_inv=l_inv, key=key, call=4)
    same, emitted, in_flight, err = fn.window_agreement(kern, plain)
    kept = same & emitted
    assert int((~kept).sum()) <= 2, (float(same.float().mean()), err)
    assert int((kept & ~in_flight).sum()) <= FAMILY_DRIFT.get(family, (0, 0, 2))[2]
    assert int((kern.transitions - warm.transitions).sum()) > 0


def test_chees_on_the_card(dev):
    """ChEES on CUDA positions: the warmup (eager transitions), then
    chees_run's "auto" backend, which is kernel 1 once per draw (1a for a
    dense metric) at the draw's jitter level, and the ChEES-tuned SMC
    moves (eager); the noncentered funnel's moments."""
    from mcmc_tpu_torch import tuning
    from mcmc_tpu_torch.samplers import smc_run
    t = get_target("neals_funnel_noncentered", dim=20)
    q = torch.randn((2048, 20), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev) * 0.5
    step, inv_mass, pos, info = tuning.run_chees_warmup(
        "hmc", t.log_prob_fn, None, q, torch.Generator(device=dev).manual_seed(1),
        num_warmup=400, value_and_grad_fn=t.value_and_grad_fn)
    assert not info["max_steps_cap_hit"] and 1.0 < info["trajectory_length"] < 20.0
    ft.reset_launches()
    res = tuning.chees_run(torch.Generator(device=dev).manual_seed(2), t.log_prob_fn, pos, step,
                           info["trajectory_length"], 256, burn_in=64, inv_mass_matrix=inv_mass,
                           value_and_grad_fn=t.value_and_grad_fn, collect_chains=256)
    assert res.info["jitter_backend"] == "fused"
    assert ft.grahmc_step_kernel.variant_launches["diagonal"] == 320
    assert ft.grahmc_step_kernel.launches == 320
    assert 0.5 < float(res.accept_rate.mean()) < 0.9
    var = res.samples.reshape(-1, 20).double().var(0)
    assert abs(float(var[0]) - 9.0) < 2.0 and float((var[1:] - 1.0).abs().max()) < 0.25
    ft.reset_launches()
    tuning.chees_run(torch.Generator(device=dev).manual_seed(3), t.log_prob_fn, pos, step,
                     info["trajectory_length"], 16, inv_mass_matrix=torch.diag(inv_mass),
                     value_and_grad_fn=t.value_and_grad_fn)
    assert ft.grahmc_step_kernel.variant_launches["dense"] == 16
    mt = get_target("gaussian_mixture", dim=4)
    r = smc_run(torch.Generator(device=dev).manual_seed(4), mt.log_prob_fn, 4096, 4, 0.3, 4,
                base_scale=6.0, value_and_grad_fn=mt.value_and_grad_fn, tune_trajectory=True)
    assert abs(float(r.log_Z)) < 0.2 and r.info["n_leapfrogs"] > 0


# Rosenbrock and the RAHMC paper's three families, each at dims that cross
# its layouts: Rosenbrock's neighbour exchange within a lane, across lanes
# and across registers (D 1, 2, 5, 33, 65), the 2-D funnel, the L1 shells
# at D 2, 3 and 50
RAHMC_DIMS = {"rosenbrock": (1, 2, 5, 33, 65), "multimodal_funnel_2d": (2,),
              "concentric_l1_balls": (2, 3, 50), "nested_l1_balls": (2, 3, 50)}
RAHMC_STEP = {"rosenbrock": 0.02, "multimodal_funnel_2d": 0.3, "concentric_l1_balls": 0.1,
              "nested_l1_balls": 0.1}
# Every kernel rounds these families' leapfrog as their plain version does
# (csrc/targets.cuh:ROUNDED_LEAPFROG), so none may drift: an H100 read 0
# drifted and 0 diverged-apart proposals and 0 drifted trajectories in
# flight on every case below
RAHMC_CASES = [(f, d) for f, dims in RAHMC_DIMS.items() for d in dims]


def _rahmc_inputs(dev, family, dim, chains, seed):
    """(info, q, lp, grad, generator): Rosenbrock near its mode (1, ..., 1),
    the others from their init samplers."""
    from mcmc_tpu_torch.targets import rahmc_paper, rosenbrock
    g = torch.Generator(device=dev).manual_seed(seed)
    t = {"rosenbrock": lambda: rosenbrock(dim),
         "multimodal_funnel_2d": rahmc_paper.multimodal_funnel_2d,
         "concentric_l1_balls": lambda: rahmc_paper.concentric_l1_balls(dim=dim),
         "nested_l1_balls": lambda: rahmc_paper.nested_l1_balls(dim=dim)}[family]()
    if family == "rosenbrock":
        q = 1.0 + 0.05 * torch.randn((chains, dim), generator=g, device=dev)
    else:
        q = t.init_sampler(g, chains)
    lp, grad = t.value_and_grad_fn(q)
    return t.value_and_grad_fn.kernel_info, q, lp.contiguous(), grad.contiguous(), g


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("family,dim", RAHMC_CASES)
def test_rahmc_families_in_kernel_1_2_and_variants(dev, family, dim, dense):
    """Rosenbrock and the RAHMC families in kernel 1 (1a dense), 1b (three
    rungs), 1c (beta 0.5) and kernel 2 (2a; T = 4) against the plain
    versions, injected and Philox, with each variant's launch count."""
    n = 1200
    info, q, lp, grad, g = _rahmc_inputs(dev, family, dim, n, dim + 21)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) + 0.5, None)
    eps, variant = RAHMC_STEP[family], "dense" if dense else "diagonal"
    args = (info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad, ft.kernel_scalars(eps, 0.3, 2.0, dev),
            invm)
    betas = torch.tensor([1.0, 0.3, 0.05], device=dev)
    beta_row = betas.repeat_interleave(n // 3)
    sargs = args[:4] + ((beta_row * lp).contiguous(), (beta_row[:, None] * grad).contiguous(),
                        ft.rung_table(eps / torch.sqrt(betas), 0.3, 2.0, betas, dev), invm)
    base = ft.bridge_base(0.5, 2.0, dim, dev)
    bridge = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                            torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                            base.mean, base.inv_scale)
    blp, bgrad = bridge(q)
    bargs = (info, 8, 0, q, blp.contiguous(), bgrad.contiguous(),
             ft.bridge_scalars(eps, 0.0, 1.0, 0.5, base.log_norm, dev), base.mean,
             base.inv_scale, invm)
    for kernel, plain_fn, a in ((ft.grahmc_step_kernel, ft.grahmc_step_plain, args),
                                (ft.grahmc_scaled_kernel, ft.grahmc_scaled_plain, sargs),
                                (ft.grahmc_bridged_kernel, ft.grahmc_bridged_plain, bargs)):
        for rand, log_u in _rand(dev, g, n, dim, invm if dense else None, l_inv):
            before = kernel.variant_launches[variant]
            kern = kernel(*a, l_inv=l_inv, **rand)
            assert kernel.variant_launches[variant] == before + 1
            _assert_close_or_drift(kern, plain_fn(*a, l_inv=l_inv, **rand), log_u, 0, 0,
                                   f"{kernel.__name__} {family} D={dim} {variant} "
                                   f"{'injected' if 'p0' in rand else 'philox'}")
    key = torch.tensor([9, 10], dtype=torch.int32, device=dev)
    margs = args[:3] + (4,) + args[3:]
    before = ft.grahmc_multistep_kernel.variant_launches[variant]
    kern = ft.grahmc_multistep_kernel(*margs, key=key, call=2, l_inv=l_inv)
    assert ft.grahmc_multistep_kernel.variant_launches[variant] == before + 1
    plain = ft.grahmc_multistep_plain(*margs, key=key, call=2, l_inv=l_inv)
    agree = (kern[3] == plain[3]).all(dim=0)
    close = ((kern[5] - plain[5]).abs() <= 1e-4 + 1e-4 * plain[5].abs()).all(dim=2).all(dim=0)
    calm = ((kern[4].abs() < 1000.0) & (plain[4].abs() < 1000.0)).all(dim=0)
    split, drifted = int((~agree).sum()), int((agree & ~close & calm).sum())
    print(f"READING grahmc_multistep_kernel {family} D={dim} {variant}: split {split}, "
          f"drifted {drifted}")
    assert split <= 2 and drifted == 0, (split, drifted)
    torch.testing.assert_close(kern[6][:, agree & close], plain[6][:, agree & close],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family,dim", RAHMC_CASES + [("rosenbrock", 10), ("rosenbrock", 128)])
def test_rahmc_families_in_kernel_3(dev, family, dim):
    """Kernel 3's log-density in its lane groups (G = 1 at D <= 4, where
    Rosenbrock's neighbours all sit in one lane) against the plain version,
    injected and Philox: accepts equal, states and histories within 1e-4."""
    info, q, lp, _, g = _rahmc_inputs(dev, family, dim, 1000, dim + 5)
    lp = pt.device_lp(info)(q).contiguous()
    scale = fr.rwmh_scale(0.5 * RAHMC_STEP[family], dev)
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


@pytest.mark.parametrize("multinomial,dense", [(False, False), (True, False), (False, True),
                                               (True, True)])
@pytest.mark.parametrize("family,dim", [("rosenbrock", 10), ("multimodal_funnel_2d", 2),
                                        ("concentric_l1_balls", 3), ("nested_l1_balls", 2)])
def test_rahmc_families_in_kernel_4(dev, family, dim, multinomial, dense):
    """Kernel 4 and its variants on Rosenbrock and the RAHMC families, W =
    4 over 64 slots from a state one window in, Philox: window_agreement as
    test_new_families_in_kernel_4's."""
    n = 2048
    info, q, lp, grad, g = _rahmc_inputs(dev, family, dim, n, 4)
    scalars = fn.nuts_scalars(RAHMC_STEP[family], 1000.0, dev)
    inv_mass, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) + 0.5, None)
    key = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    args = (info, 16, 4, 10)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    name = fn.VARIANTS[(multinomial, dense)]

    def clone():
        return tn._PState(*(None if t is None else t.clone() for t in warm))
    before = fn.nuts_window_kernel.variant_launches[name]
    kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, l_inv=l_inv, key=key, call=4)
    assert fn.nuts_window_kernel.variant_launches[name] == before + 1
    plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, l_inv=l_inv, key=key, call=4)
    same, emitted, in_flight, err = fn.window_agreement(kern, plain)
    kept = same & emitted
    split, drifted = int((~kept).sum()), int((kept & ~in_flight).sum())
    print(f"READING nuts_window_kernel[{name}] {family} D={dim}: split {split}, in flight "
          f"drifted {drifted}, max |err| {err:.3g}")
    assert split <= 2, (float(same.float().mean()), err)
    assert drifted == 0, drifted
    assert int((kern.transitions - warm.transitions).sum()) > 0


def test_shells_past_the_cap_raise_before_a_launch(dev):
    """An L1 target with more shells than TargetParams carries
    (padded_targets.MAX_SHELLS) is refused by every fused entry point
    with ValueError naming the cap; nothing launches and nothing runs
    eagerly in its place."""
    from mcmc_tpu_torch.targets import rahmc_paper
    t = rahmc_paper.concentric_l1_balls(dim=3, radii=tuple(range(1, pt.MAX_SHELLS + 2)))
    q = t.init_sampler(torch.Generator(device=dev).manual_seed(0), 64)
    ft.reset_launches()
    fr.reset_launches()
    fn.reset_launches()
    runs = (lambda: tg.grahmc_run(torch.Generator(device=dev), t.log_prob_fn, q, 0.1, 4, 0.5,
                                  1.0, 8, value_and_grad_fn=t.value_and_grad_fn, backend="fused"),
            lambda: tr.rwmh_run(torch.Generator(device=dev), t.log_prob_fn, q, 32, 0.1,
                                value_and_grad_fn=t.value_and_grad_fn, backend="fused"),
            lambda: tn.nuts_run_persistent(torch.Generator(device=dev), t.log_prob_fn, q, 0.1,
                                           2, steps_per_sample=8,
                                           value_and_grad_fn=t.value_and_grad_fn,
                                           backend="fused"))
    for run in runs:
        with pytest.raises(ValueError, match="MAX_SHELLS"):
            run()
    assert ft.grahmc_step_kernel.launches == ft.grahmc_multistep_kernel.launches == 0
    assert fr.rwmh_multistep_kernel.launches == fn.nuts_window_kernel.launches == 0


@pytest.mark.parametrize("family,dim", [("rosenbrock", 10), ("multimodal_funnel_2d", 2),
                                        ("concentric_l1_balls", 2), ("nested_l1_balls", 2)])
def test_rahmc_family_runs_take_the_kernels(dev, family, dim):
    """grahmc_run, rwmh_run and nuts_run_persistent with backend="fused"
    on the four families launch kernels 2, 3 and 4 (no KeyError, no eager
    path), their draws finite."""
    info, q, lp, grad, g = _rahmc_inputs(dev, family, dim, 256, 6)
    from mcmc_tpu_torch.interop import target_from_tag
    t = target_from_tag(dict(info))
    ft.reset_launches()
    fr.reset_launches()
    fn.reset_launches()
    eps = RAHMC_STEP[family]
    res = [tg.grahmc_run(torch.Generator(device=dev).manual_seed(1), t.log_prob_fn, q, eps, 8,
                         0.3, 2.0, 64, value_and_grad_fn=t.value_and_grad_fn, backend="fused"),
           tr.rwmh_run(torch.Generator(device=dev).manual_seed(2), t.log_prob_fn, q, 64,
                       0.5 * eps, value_and_grad_fn=t.value_and_grad_fn, backend="fused"),
           tn.nuts_run_persistent(torch.Generator(device=dev).manual_seed(3), t.log_prob_fn, q,
                                  eps, 8, steps_per_sample=16,
                                  value_and_grad_fn=t.value_and_grad_fn, backend="fused")]
    assert ft.grahmc_multistep_kernel.launches == 8
    assert fr.rwmh_multistep_kernel.launches == 2
    assert fn.nuts_window_kernel.launches == 8
    for r in res:
        assert bool(torch.isfinite(r.samples).all())


def test_persistent_warmup_kernel_4_against_its_eager_machine(dev, monkeypatch):
    """run_adaptive_warmup("nuts", backend="persistent") on CUDA positions
    runs one kernel-4 window per warmup step; the same warmup on CPU
    positions with fused_warmup=True runs the window's plain version, the
    eager machine's iteration at W slots, and with one Philox key
    (PhiloxStream.from_generator patched) both draw the same numbers: the
    tuned step, the learned metric and the chains agree to rounding, but
    for chains whose U-turn sign split."""
    from mcmc_tpu_torch.tuning import adaptation
    t = get_target("standard_normal", dim=10)
    q = torch.randn((256, 10), generator=torch.Generator().manual_seed(0)) * 0.5
    monkeypatch.setattr(ft.PhiloxStream, "from_generator", classmethod(
        lambda cls, g, device: cls(torch.tensor([5, -6], dtype=torch.int32, device=device))))
    kw = dict(exploration_steps=40, adaptation_windows=[40], cooldown_steps=20, update_freq=20,
              steps_per_warmup_step=16, value_and_grad_fn=t.value_and_grad_fn,
              backend="persistent")
    fn.reset_launches()
    s_k, m_k, p_k, _ = adaptation.run_adaptive_warmup(
        "nuts", t.log_prob_fn, None, q.to(dev), torch.Generator(device=dev), **kw)
    assert fn.nuts_window_kernel.launches == 100
    s_p, m_p, p_p, _ = adaptation.run_adaptive_warmup(
        "nuts", t.log_prob_fn, None, q, torch.Generator(), fused_warmup=True, **kw)
    assert abs(s_k - s_p) <= 1e-3 * s_p, (s_k, s_p)
    torch.testing.assert_close(m_k.cpu(), m_p, rtol=0.02, atol=0.02)
    close = ((p_k.cpu() - p_p).abs() <= 1e-3).all(dim=1)
    assert float(close.float().mean()) >= 0.95, float(close.float().mean())


# Kernel 1's block-tiled variants (csrc/tiled_step.cuh): 1a, the dense
# metric on every family, and 1d, the hierarchical posterior under either
# metric. Under the dense metric the leapfrog and the D x D products round
# each product in the plain version's order, and these families' functors
# do too (padded_targets.LANE_ORDER_FAMILIES, the hierarchical posterior):
# with injected draws the trajectory -- the new q, its gradient and the
# proposal -- equals the plain version's bit for bit wherever the accepts
# agree (the energies' sums are taken in another order, so an accept may
# differ at the MH borderline). lp passes through log1p, log and exp, which
# PyTorch's CUDA kernels and the card's math library round apart, so lp is
# held within 1e-4. The other families and the Philox draws (the card's sin
# and cos against PyTorch's) are held within 1e-4; 1d's diagonal leapfrog
# (nvcc's FMA) against its own device function: its proposal within 1e-4 of
# the plain trajectory, its lp and gradient within 1e-4 of the potential
# at its own q.
TILED_EXACT = set(pt.LANE_ORDER_FAMILIES) | {HIER}
TILED_FAMILIES = ([(f, d) for f in ["standard_normal", "neals_funnel", "correlated_gaussian",
                                    "gaussian_mixture"] + NEW_FAMILIES for d in (10, 50)]
                  + [("rosenbrock", 10), ("rosenbrock", 50), ("multimodal_funnel_2d", 2),
                     ("concentric_l1_balls", 2), ("concentric_l1_balls", 3),
                     ("nested_l1_balls", 2), ("nested_l1_balls", 3)])


def _assert_bits(a, b, label):
    """a and b equal bit for bit (any NaN equal to any NaN)."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    bad = (~same).nonzero()
    assert not len(bad), (f"{label}: {len(bad)} entries differ, e.g. at {bad[0].tolist()} "
                          f"{a[tuple(bad[0])].item()!r} against {b[tuple(bad[0])].item()!r}")


def _tiled_check(args, l_inv, rands, exact, drift=(0, 0), potential=None):
    """Kernel 1 (tiled) against its plain version on each of `rands`
    (injected first): accepts equal away from the MH borderline; where they
    agree, with injected draws and `exact`, the trajectory (new q, its
    gradient, the proposal q) bit for bit and lp within 1e-4; with a
    `potential` (lp, grad) function, the proposal within 1e-4 of the plain
    version's, a rejected chain's state its input bit for bit, an accepted
    chain's its proposal with lp and gradient within 1e-4 of the potential
    there; else _assert_close_or_drift within `drift`. Counts one launch of
    the variant per call."""
    info, q_in, lp_in, grad_in = args[0], args[3], args[4], args[5]
    name = ft.variant_name(ft.VARIANTS[args[-1].ndim == 2], info)
    for i, (rand, log_u) in enumerate(rands):
        before = ft.grahmc_step_kernel.variant_launches[name]
        kern = ft.grahmc_step_kernel(*args, l_inv=l_inv, **rand)
        assert ft.grahmc_step_kernel.variant_launches[name] == before + 1
        plain = ft.grahmc_step_plain(*args, l_inv=l_inv, **rand)
        if not (exact and i == 0) and potential is None:
            _assert_close_or_drift(kern, plain, log_u, *drift)
            continue
        border = (log_u - torch.clamp(-plain[4], max=0.0)).abs() < 1e-4
        same = kern[3] == plain[3]
        assert not bool((~same & ~border).any())
        if exact and i == 0:
            for k, label in ((0, "q"), (2, "grad"), (5, "proposal q")):
                _assert_bits(kern[k][same], plain[k][same], label)
            for k in (1, 6):
                torch.testing.assert_close(kern[k][same], plain[k][same], rtol=1e-4, atol=1e-4)
            continue
        torch.testing.assert_close(kern[5][same], plain[5][same], rtol=1e-4, atol=1e-4)
        acc = kern[3]
        for k, x in ((0, q_in), (1, lp_in), (2, grad_in)):
            _assert_bits(kern[k][~acc], x[~acc], f"rejected chains' output {k}")
        _assert_bits(kern[0][acc], kern[5][acc], "accepted q")
        lp_at, grad_at = potential(kern[0])
        torch.testing.assert_close(kern[1][acc], lp_at[acc], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(kern[2][acc], grad_at[acc], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 7, 9, 31, 33, 8191])
@pytest.mark.parametrize("variant", ["1a", "1d", "1a+data"])
def test_tiled_kernel_1_at_ragged_chain_counts(dev, variant, n):
    """The last block's warps past n_chains take part in its products and
    store nothing: every chain of a ragged count (on both sides of 1a's 8
    chains a block and 1d's 32) matches the plain version."""
    if variant == "1a":
        info, q, lp, grad, g = _inputs(dev, "correlated_gaussian", 50, n, n)
    else:
        info, q, lp, grad, g = _hier(dev, 100, 256, n, n)
    dense = variant != "1d"
    invm, l_inv = _dense_metric(dev, q.shape[1], g) if dense else (
        torch.rand(q.shape[1], generator=g, device=dev) * 0.5 + 0.25, None)
    args = (info, 8, ft.SCHEDULE_IDS["constant"], q, lp, grad,
            ft.kernel_scalars(0.05, 0.5, 0.5, dev), invm)
    _tiled_check(args, l_inv, _rand(dev, g, n, q.shape[1], invm if dense else None, l_inv),
                 exact=dense, potential=None if dense else ft.device_vag(info))


@pytest.mark.parametrize("dim", [1, 32, 33, 50, 100, 128])
def test_tiled_dense_kernel_at_register_edges(dev, dim):
    """1a at D on both sides of K's steps (32 coordinates a register) and
    of the products' float4 columns."""
    info, q, lp, grad, g = _inputs(dev, "correlated_gaussian", dim, 1000, dim + 5)
    invm, l_inv = _dense_metric(dev, dim, g)
    args = (info, 8, ft.SCHEDULE_IDS["constant"], q, lp, grad,
            ft.kernel_scalars(0.05, 0.7, 3.0, dev), invm)
    _tiled_check(args, l_inv, _rand(dev, g, 1000, dim, invm, l_inv), exact=True)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_data", [50, 256, 1000])
@pytest.mark.parametrize("dim", [9, 20, 100])
def test_tiled_hierarchical_kernel(dev, dim, n_data, dense):
    """1d (and 1a's data form) over X's row tiles: n_data 50 and 1,000 are
    no multiple of the tile, 1,000 spans 16 tiles through both buffers."""
    info, q, lp, grad, g = _hier(dev, dim, n_data, 1000, dim * n_data)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) * 0.5 + 0.25, None)
    eps = 0.08 * min(1.0, 256 / n_data)      # the posterior narrows with n_data
    args = (info, 8, ft.SCHEDULE_IDS["constant"], q, lp, grad,
            ft.kernel_scalars(eps, 0.5, 0.5, dev), invm)
    plain_accept = ft.grahmc_step_plain(*args, l_inv=l_inv, **_rand(dev, g, 1000, dim)[0][0])[3]
    assert 0.05 < float(plain_accept.float().mean())
    _tiled_check(args, l_inv, _rand(dev, g, 1000, dim, invm if dense else None, l_inv),
                 exact=dense, potential=None if dense else ft.device_vag(info))


@pytest.mark.parametrize("family,dim", TILED_FAMILIES)
def test_tiled_dense_kernel_on_every_family(dev, family, dim):
    """1a on each family (the hierarchical posterior's form in the tests
    above) at D 10 and 50, the 2- and 3-D families at theirs."""
    n = 1200
    if family in RAHMC_STEP:
        info, q, lp, grad, g = _rahmc_inputs(dev, family, dim, n, dim + 13)
        eps = RAHMC_STEP[family]
    else:
        info, q, lp, grad, g = _family_inputs(dev, family, dim, n, dim + 13)
        eps = FAMILY_STEP.get(family, 0.05)
    invm, l_inv = _dense_metric(dev, dim, g)
    drift, wild, _ = FAMILY_DRIFT.get(family, (0, 0, 2))
    args = (info, 8, ft.SCHEDULE_IDS["constant"], q, lp, grad,
            ft.kernel_scalars(eps, 0.3, 2.0, dev), invm)
    _tiled_check(args, l_inv, _rand(dev, g, n, dim, invm, l_inv),
                 exact=info["family"] in TILED_EXACT, drift=(drift, wild))


def test_tiled_geometry_agrees_with_the_kernel(dev):
    """The wrapper's tile_geometry against csrc/tiled_step.cuh's, through
    the library's grahmc_tile_geometry: chains a block, rows a tile and
    shared memory for every D, metric and data flag."""
    import ctypes
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    chains, rows = ctypes.c_int(), ctypes.c_int()
    for dim in range(1, ft.MAX_DIM + 1):
        for dense in (0, 1):
            for n_data in (0, 33, 256):
                geo = ft.tile_geometry(100, dim, n_data, bool(dense))
                nbytes = lib.grahmc_tile_geometry(dim, n_data, dense, int(n_data > 0),
                                                  ctypes.byref(chains), ctypes.byref(rows))
                assert (nbytes, chains.value, rows.value) == (geo.smem_bytes, geo.chains,
                                                              geo.row_tile), (dim, dense, n_data)


def test_each_launch_counts_at_its_shape(dev):
    """Every wrapper adds one launch at (variant, family, n_chains, dim)
    where it launches: kernel 1 and 1a, kernel 3 and kernel 4."""
    info, q, lp, grad, g = _inputs(dev, "neals_funnel", 10, 33, 5)
    key = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    scalars = ft.kernel_scalars(0.05, 0.7, 3.0, dev)
    invm, l_inv = _dense_metric(dev, 10, g)
    for metric, factor, name in ((torch.ones(10, device=dev), None, "diagonal"),
                                 (invm, l_inv, "dense")):
        shape = (name, "neals_funnel", 33, 10)
        before = ft.grahmc_step_kernel.shape_launches.get(shape, 0)
        ft.grahmc_step_kernel(info, 4, 0, q, lp, grad, scalars, metric, key=key, call=0,
                              l_inv=factor)
        assert ft.grahmc_step_kernel.shape_launches[shape] == before + 1
    shape = ("rwmh", "neals_funnel", 33, 10)
    before = fr.rwmh_multistep_kernel.shape_launches.get(shape, 0)
    fr.rwmh_multistep_kernel(info, 2, q, lp, fr.rwmh_scale(0.5, dev), 4, key=key, call=0)
    assert fr.rwmh_multistep_kernel.shape_launches[shape] == before + 1
    state = tn._init_pstate(q, lp, grad, torch.float32, multinomial=False, max_tree_depth=4)
    shape = ("endpoint", "neals_funnel", 33, 10)
    before = fn.nuts_window_kernel.shape_launches.get(shape, 0)
    fn.nuts_window_kernel(info, 2, 2, 4, state, fn.nuts_scalars(0.1, 1000.0, dev),
                          torch.ones(10, device=dev), key=key, call=0)
    assert fn.nuts_window_kernel.shape_launches[shape] == before + 1


# Kernel 4's redesigned variant (csrc/nuts_window.cuh:nuts_tiled_window_
# kernel): 4c and 4a's data form with either metric, at dims, data sizes
# and chain counts on both sides of the tiles' edges, against the plain
# window under chip_smoke.py [3f]'s rules: no chain split or drifted in
# flight, or at most one in 1,000 (SPLIT_MAX, [3f]'s rule for 4a's data
# form) where the case says why.
def _tiled_nuts_check(args, q, lp, grad, g, step, inv_mass, l_inv, multinomial, moved=True,
                      max_off=0):
    """Injected and Philox windows of 16 iterations x W = 4 from a state one
    plain window in: one launch of the variant each; every chain's discrete
    state equal to the plain version's and its emitted and in-flight state
    within window_agreement's 1e-4, but for at most `max_off` chains split
    or drifted; and (`moved`) transitions completed."""
    info, n_iters, slots, depth = args
    n, dim = q.shape
    scalars = fn.nuts_scalars(step, 1000.0, q.device)
    key = torch.tensor([1, 2], dtype=torch.int32, device=q.device)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    n_slice = n_iters * (slots if multinomial else 1)
    draws = (torch.randn((n_iters, n, dim), generator=g, device=q.device),
             torch.rand((n_iters, n), generator=g, device=q.device) < 0.5,
             torch.rand((n_iters, n), generator=g, device=q.device) < 0.5,
             torch.rand((n_iters, n), generator=g, device=q.device),
             torch.rand((n_slice, n), generator=g, device=q.device).clamp_min(2.0 ** -25),
             torch.rand((n_iters, n), generator=g, device=q.device))
    name = fn.variant(warm, inv_mass, info)

    def clone():
        return tn._PState(*(None if t is None else t.clone() for t in warm))
    for mode, rand in (("injected", dict(draws=draws)), ("philox", dict(key=key, call=4))):
        before = fn.nuts_window_kernel.variant_launches[name]
        kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        assert fn.nuts_window_kernel.variant_launches[name] == before + 1
        plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted
        split, drifted = int((~kept).sum()), int((kept & ~in_flight).sum())
        print(f"READING {name} {n} x {dim} {mode}: split {split}, in flight drifted "
              f"{drifted}, max |err| {err:.3g}")
        assert split + drifted <= max_off, (split, drifted, err)
        if moved:
            assert int((kern.transitions - warm.transitions).sum()) > 0


@pytest.mark.parametrize("multinomial", [False, True])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n_data", [50, 256, 1000])
@pytest.mark.parametrize("dim", [9, 20, 100])
def test_tiled_nuts_hierarchical(dev, dim, n_data, dense, multinomial):
    """4c and 4a's data form, with either metric, over X's row tiles: n_data
    50 and 1,000 are no multiple of the tile, 1,000 spans 16 tiles through
    both buffers. At most one chain in 1,000 may split or drift: the
    posterior's expf and log1pf on the card and PyTorch's CUDA exp and
    log1p differ by an ulp (the lp within 1e-4,
    test_tiled_hierarchical_kernel), so a chain whose slice, swap or U-turn
    test lies within an ulp of its edge takes the other branch in one of
    the two. On an H100 four of these 36 cases have one such chain, under
    the warp-per-chain kernel as under the tiled one (their outputs are
    equal bit for bit)."""
    n = 1000
    info, q, lp, grad, g = _hier(dev, dim, n_data, n, dim * n_data + multinomial)
    metric = (_dense_metric(dev, dim, g)[0] * 0.1 if dense else
              torch.rand(dim, generator=g, device=dev) * 0.05 + 0.02)
    inv_mass, l_inv = ft.kernel_metric(metric)
    step = (0.05 if dense else 0.15) * min(1.0, (64 / n_data) ** 0.5)
    _tiled_nuts_check((info, 16, 4, 10), q, lp, grad, g, step, inv_mass, l_inv, multinomial,
                      max_off=n // 1000)


@pytest.mark.parametrize("n", [1, 7, 9, 31, 33, 8191])
@pytest.mark.parametrize("dense", [False, True])
def test_tiled_nuts_at_ragged_chain_counts(dev, dense, n):
    """The last block's warps past n_chains are never live, meet every
    barrier and store nothing: every chain of a ragged count (on both sides
    of the tile's 32 chains a block; at 1 and 33 one chain past the full
    blocks, alone in its block) matches the plain version, with either
    metric."""
    info, q, lp, grad, g = _hier(dev, 100, 256, n, n)
    metric = (_dense_metric(dev, 100, g)[0] * 0.1 if dense else
              torch.rand(100, generator=g, device=dev) * 0.05 + 0.02)
    inv_mass, l_inv = ft.kernel_metric(metric)
    _tiled_nuts_check((info, 16, 4, 10), q, lp, grad, g, 0.025 if dense else 0.08, inv_mass,
                      l_inv, multinomial=n % 2 == 1, moved=n >= 31)


def test_tiled_nuts_geometry_agrees_with_the_kernel(dev):
    """The wrapper's tile_geometry against csrc/nuts_window.cuh's, through
    the library's nuts_tile_geometry: chains a block, rows a tile and shared
    memory for every D and metric."""
    import ctypes
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    chains, rows = ctypes.c_int(), ctypes.c_int()
    for dim in range(1, ft.MAX_DIM + 1):
        for dense in (0, 1):
            geo = fn.tile_geometry(100, dim, 256, bool(dense))
            nbytes = lib.nuts_tile_geometry(dim, dense, ctypes.byref(chains), ctypes.byref(rows))
            assert (nbytes, chains.value, rows.value) == (geo.smem_bytes, geo.chains,
                                                          geo.row_tile), (dim, dense)


# Kernel 4's warp window under the dense metric (4b, 4a+4b): its products
# (csrc/metric.cuh, the loop over i outside the registers) sum in the
# plain version's order (trajectory.ordered_matmul). Where the plain
# version also repeats the target's gradient bit for bit (the standard
# normal's -q, the correlated Gaussian's rounded sums), every chain that
# agrees within window_agreement's 1e-4 must agree bit for bit in its
# positions, momenta and gradients: a product summed in another order
# would differ there in the last ulps. Energies may not: the kinetic
# energy's warp sum and the plain version's torch.sum round differently.
EXACT_GRAD_FAMILIES = ("standard_normal", "correlated_gaussian")
POSITION_FIELDS = fn.FULL_FIELDS + fn.MULTI_FULL_FIELDS + fn.STACK_FIELDS


def _dense_window_check(info, q, lp, grad, g, step, multinomial, label, max_split=0,
                        max_drift=0):
    """Injected and Philox windows of 16 iterations x W = 4 from a state one
    plain window in, a random SPD metric: one launch of the variant each;
    at most `max_split` chains split and `max_drift` drifted in flight
    (window_agreement), and with an exact-gradient family and injected
    draws the other chains' positions bit for bit (the Philox normals' logf, sinf and cosf may
    differ from PyTorch's in the last ulp)."""
    n, dim = q.shape
    inv_mass, l_inv = _dense_metric(q.device, dim, g)
    args = (info, 16, 4, 10)
    scalars = fn.nuts_scalars(step, 1000.0, q.device)
    key = torch.tensor([3, 4], dtype=torch.int32, device=q.device)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0, l_inv=l_inv)
    n_slice = 64 if multinomial else 16
    draws = (torch.randn((16, n, dim), generator=g, device=q.device),
             torch.rand((16, n), generator=g, device=q.device) < 0.5,
             torch.rand((16, n), generator=g, device=q.device) < 0.5,
             torch.rand((16, n), generator=g, device=q.device),
             torch.rand((n_slice, n), generator=g, device=q.device).clamp_min(2.0 ** -25),
             torch.rand((16, n), generator=g, device=q.device))
    name = fn.VARIANTS[(multinomial, True)]
    exact = info["family"] in EXACT_GRAD_FAMILIES

    def clone():
        return tn._PState(*(None if t is None else t.clone() for t in warm))
    for mode, rand in (("injected", dict(draws=draws)), ("philox", dict(key=key, call=4))):
        before = fn.nuts_window_kernel.variant_launches[name]
        kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        assert fn.nuts_window_kernel.variant_launches[name] == before + 1
        plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, l_inv=l_inv, **rand)
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted & in_flight
        split, drifted = int((~(same & emitted)).sum()), int((same & emitted & ~in_flight).sum())
        print(f"READING {name} {label} {mode}: split {split}, drifted {drifted} of {n}, "
              f"max |err| {err:.3g}")
        assert split <= max_split and drifted <= max_drift, (split, drifted, err)
        if exact and mode == "injected":
            for field in POSITION_FIELDS:
                a, b = getattr(kern, field), getattr(plain, field)
                if a is not None:
                    _assert_bits(a[kept], b[kept], f"{label} {mode} {field}")


WARP_FAMILY_CASES = ([(f, d) for f in ["standard_normal", "neals_funnel", "correlated_gaussian",
                                       "gaussian_mixture"] + NEW_FAMILIES for d in (10, 50)]
                     + [("rosenbrock", 10), ("rosenbrock", 50), ("multimodal_funnel_2d", 2),
                        ("concentric_l1_balls", 3), ("nested_l1_balls", 2)])


@pytest.mark.parametrize("multinomial", [False, True])
@pytest.mark.parametrize("family,dim", WARP_FAMILY_CASES)
def test_dense_window_order_on_every_family(dev, family, dim, multinomial):
    """4b and 4a+4b against their plain versions on each family without
    data (D 10 and 50; the 2- and 3-D families at theirs), 2,048
    chains: the exact-gradient families split or drift at most one chain
    each (an energy, summed in another order than PyTorch's, within an ulp
    of a slice or reservoir edge) and keep the other chains' positions bit
    for bit; the others, whose transcendentals differ
    from PyTorch's in the last ulp, split at most 2 chains and drift as
    test_new_families_in_kernel_4 and test_nuts_window_kernel_matches_plain
    allow (the funnel's neck, up to 5%)."""
    if family in RAHMC_STEP:
        info, q, lp, grad, g = _rahmc_inputs(dev, family, dim, 2048, dim + 11)
        step = RAHMC_STEP[family]
    else:
        info, q, lp, grad, g = _family_inputs(dev, family, dim, 2048, dim + 11)
        step = FAMILY_STEP.get(family, 0.1)
    exact = family in EXACT_GRAD_FAMILIES
    drift = 0.05 * 2048 if family == "neals_funnel" else FAMILY_DRIFT.get(family, (0, 0, 2))[2]
    _dense_window_check(info, q, lp, grad, g, step, multinomial, f"{family} D={dim}",
                        max_split=1 if exact else 2, max_drift=1 if exact else drift)


@pytest.mark.parametrize("multinomial", [False, True])
@pytest.mark.parametrize("dim,n", [(1, 1), (2, 7), (7, 9), (31, 31), (32, 33), (33, 100),
                                   (50, 257), (64, 1000), (65, 8191), (100, 33), (127, 9),
                                   (128, 8191)])
def test_dense_window_order_at_register_edges_and_ragged_counts(dev, dim, n, multinomial):
    """4b and 4a+4b on the correlated Gaussian at D from 1 to 128 (both
    sides of K's steps of 32 coordinates and of the products' steps of 4
    terms) and ragged chain counts (the last block of 8 warps partly
    used): at most one chain split or drifted (as on every family), the
    positions bit for bit."""
    info, q, lp, grad, g = _inputs(dev, "correlated_gaussian", dim, n, dim * 1000 + n)
    _dense_window_check(info, q, lp, grad, g, 0.1, multinomial, f"D={dim} C={n}",
                        max_split=1, max_drift=1)


# Kernel 3's tiled 3a (csrc/fused_rwmh.cu:rwmh_tiled_kernel): the
# hierarchical posterior's log-density block-tiled over X's row tiles in
# the lane-group kernel's layout and order (and
# test_hierarchical_rwmh_kernel_matches_plain). Held to the plain version
# here (expf and log1pf against PyTorch's exp and log1p: the lp within
# 1e-4); experiments/torch_tiled_nuts_timing.py holds it bit for bit to the
# lane-group kernel it replaced.
def _tiled_rwmh_check(info, q, lp, g, transitions=8, n_hist=37):
    n, dim = q.shape
    scale = fr.rwmh_scale(0.3 / dim ** 0.5, q.device)
    noise = torch.randn((transitions, n, dim), generator=g, device=q.device)
    u = torch.rand((transitions, n), generator=g, device=q.device).clamp_min(2.0 ** -25)
    key = torch.tensor([7, -8], dtype=torch.int32, device=q.device)
    n_hist = min(n_hist, n)
    for rand in (dict(noise=noise, u=u), dict(key=key, call=3)):
        before = fr.rwmh_multistep_kernel.variant_launches["rwmh+data"]
        kern = fr.rwmh_multistep_kernel(info, transitions, q, lp, scale, n_hist, **rand)
        assert fr.rwmh_multistep_kernel.variant_launches["rwmh+data"] == before + 1
        plain = fr.rwmh_multistep_plain(info, transitions, q, lp, scale, n_hist, **rand)
        assert torch.equal(kern[2], plain[2])
        for a, b in zip(kern[:2] + kern[3:], plain[:2] + plain[3:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert 0.01 < float(plain[2].float().mean()) < 1.0


@pytest.mark.parametrize("n", [1, 7, 31, 33, 8191])
def test_tiled_rwmh_at_ragged_chain_counts(dev, n):
    """The last block's warps past n_chains run a clamped chain, meet every
    barrier and store nothing (n 1 and 33: one chain past the full
    blocks)."""
    info, q, lp, _, g = _hier(dev, 100, 256, n, n)
    _tiled_rwmh_check(info, q, lp, g, n_hist=5)


def test_tiled_rwmh_geometry_agrees_with_the_kernel(dev):
    """The wrapper's tile_geometry against csrc/fused_rwmh.cu's, through
    the library's rwmh_tile_geometry, for every D."""
    import ctypes
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    chains, rows = ctypes.c_int(), ctypes.c_int()
    for dim in range(1, ft.MAX_DIM + 1):
        geo = fr.tile_geometry(100, dim, 256)
        nbytes = lib.rwmh_tile_geometry(dim, ctypes.byref(chains), ctypes.byref(rows))
        assert (nbytes, chains.value, rows.value) == (geo.smem_bytes, geo.chains,
                                                      geo.row_tile), dim


# Kernel 4's warp window at small D and its multinomial scheme, redesigned
# for Hopper (csrc/targets.cuh: the L1 shells spread over the warp's lanes;
# csrc/nuts_window.cuh: the termination test's and the multinomial checks'
# dot products together, each odd leaf's first check from registers):
# against the plain window, injected draws and Philox, from a state one
# plain window in, on families whose kernels round the leapfrog as the
# plain version does (csrc/targets.cuh:ROUNDED_LEAPFROG). No chain may
# drift in flight; with injected draws every chain that agrees keeps its
# positions, momenta, gradients, reservoir and checkpoint stacks bit for
# bit (with Philox the normals' logf, sinf and cosf may differ from
# PyTorch's in the last ulp).
L1_RADII = (4.0, 8.0, 16.0, 24.0, 32.0, 40.0, 48.0, 56.0)


def _l1_target(family, n_shells, dim):
    from mcmc_tpu_torch.targets import rahmc_paper
    if family == "concentric_l1_balls":
        return rahmc_paper.concentric_l1_balls(dim=dim, radii=L1_RADII[:n_shells])
    return rahmc_paper.nested_l1_balls(dim=dim, n_inner=n_shells - 1)


def _warp_window_bits(t, q, g, step, multinomial, label, max_split=0, max_drift=0,
                      exact=True):
    """The diagonal warp window (4 or 4a, 16 iterations x W = 4, depth 10)
    against its plain version as the comment above says (bit for bit when
    `exact`); one launch of the variant a call."""
    n, dim = q.shape
    lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
    info = t.value_and_grad_fn.kernel_info
    inv_mass = torch.rand(dim, generator=g, device=q.device) + 0.5
    args = (info, 16, 4, 10)
    scalars = fn.nuts_scalars(step, 1000.0, q.device)
    key = torch.tensor([5, -6], dtype=torch.int32, device=q.device)
    start = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    warm = fn.nuts_window_plain(*args, start, scalars, inv_mass, key=key, call=0)
    n_slice = 64 if multinomial else 16
    draws = (torch.randn((16, n, dim), generator=g, device=q.device),
             torch.rand((16, n), generator=g, device=q.device) < 0.5,
             torch.rand((16, n), generator=g, device=q.device) < 0.5,
             torch.rand((16, n), generator=g, device=q.device),
             torch.rand((n_slice, n), generator=g, device=q.device).clamp_min(2.0 ** -25),
             torch.rand((16, n), generator=g, device=q.device))
    name = fn.VARIANTS[(multinomial, False)]

    def clone():
        return tn._PState(*(None if x is None else x.clone() for x in warm))
    for mode, rand in (("injected", dict(draws=draws)), ("philox", dict(key=key, call=4))):
        before = fn.nuts_window_kernel.variant_launches[name]
        kern = fn.nuts_window_kernel(*args, clone(), scalars, inv_mass, **rand)
        assert fn.nuts_window_kernel.variant_launches[name] == before + 1
        plain = fn.nuts_window_plain(*args, clone(), scalars, inv_mass, **rand)
        same, emitted, in_flight, err = fn.window_agreement(kern, plain)
        kept = same & emitted & in_flight
        split, drifted = int((~(same & emitted)).sum()), int((same & emitted & ~in_flight).sum())
        print(f"READING {name} {label} {mode}: split {split}, drifted {drifted} of {n}, "
              f"max |err| {err:.3g}, {int((kern.n_exec - warm.n_exec).sum())} leapfrogs")
        assert split <= max_split and drifted <= max_drift, (split, drifted, err)
        assert int((kern.transitions - warm.transitions).sum()) > 0
        if exact and mode == "injected":
            for field in POSITION_FIELDS:
                a, b = getattr(kern, field), getattr(plain, field)
                if a is not None:
                    _assert_bits(a[kept], b[kept], f"{label} {mode} {field}")


@pytest.mark.parametrize("dim", [1, 2, 3, 10, 32])
@pytest.mark.parametrize("n_shells", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("family", ["concentric_l1_balls", "nested_l1_balls"])
def test_l1_shells_window_bit_for_bit(dev, family, n_shells, dim):
    """Kernel 4 on the L1 families at 1-8 shells (every mask of the lanes'
    shells; 8 is MAX_SHELLS) and D 1-32 (K = 1, where [6h] runs them), at
    [6h]'s 1,024 chains: no chain split or drifted, the agreeing chains bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(100 * n_shells + dim)
    t = _l1_target(family, n_shells, dim)
    q = t.init_sampler(g, 1024).float().contiguous()
    _warp_window_bits(t, q, g, 0.12, False, f"{family} {n_shells} shells D={dim}")


@pytest.mark.parametrize("multinomial", [False, True])
def test_bimodal_funnel_window_bit_for_bit(dev, multinomial):
    """Kernel 4 and 4a on the bimodal funnel at [6h]'s 1,024 x 2: no chain
    split or drifted, the agreeing chains bit for bit."""
    g = torch.Generator(device=dev).manual_seed(17)
    t = get_target("multimodal_funnel_2d", dim=2)
    q = t.init_sampler(g, 1024).float().contiguous()
    _warp_window_bits(t, q, g, 0.23, multinomial, "multimodal_funnel_2d")


@pytest.mark.parametrize("n", [1, 7, 33, 8191, 65536])
def test_multinomial_window_bit_for_bit(dev, n):
    """4a at the NUTS-multinomial row's 65,536 x 50 and at ragged chain
    counts (a block of 4 warps partly used), on the 50-D Rosenbrock, a
    family whose kernels round the leapfrog as its plain version does
    (csrc/targets.cuh:ROUNDED_LEAPFROG; the funnel's FMA-contracted
    leapfrog differs from it in the last ulp): the odd leaves' checks from
    registers and prefetched stack rows change no bit. At most one chain in
    1,000 split (an energy summed in another order than PyTorch's, within an
    ulp of a slice or reservoir edge: chip_smoke.py's SPLIT_MAX), none
    drifted."""
    g = torch.Generator(device=dev).manual_seed(n)
    t = get_target("rosenbrock", dim=50)
    q = (1.0 + 0.05 * torch.randn((n, 50), generator=g, device=dev)).contiguous()
    _warp_window_bits(t, q, g, 0.02, True, f"rosenbrock C={n}", max_split=n // 1000)


def test_multinomial_funnel_row_window(dev):
    """4a on the NUTS-multinomial row's 65,536 x 50 funnel, whose leapfrog
    nvcc contracts to FMA (so no bit-for-bit hold): split and drifted
    chains within [3c]'s bounds for it (at most 1 in 1,000 split, 5% of the
    trajectories in flight drifted: the neck amplifies an ulp), and the
    agreeing chains' emitted state within window_agreement's 1e-4."""
    n = 65536
    g = torch.Generator(device=dev).manual_seed(50)
    t = get_target("neals_funnel", dim=50)
    q = (torch.randn((n, 50), generator=g, device=dev) * 0.5).contiguous()
    _warp_window_bits(t, q, g, 0.2, True, "neals_funnel", max_split=n // 1000,
                      max_drift=n // 20, exact=False)


# Kernel 1's and 1b's lane groups (csrc/trajectory.cuh:step_lanes): D at
# every group and register boundary; chain counts that leave a warp partly
# used, below the lane groups' MIN_GROUP_WARPS (warp per chain) and above it
# (8,191: 16 lanes at K = 1; 16,385: 4 lanes at K = 1, 8 at K = 2, 16 at
# K >= 3); every schedule, with L 0, 1 and 64 among them.
GROUP_FAMILIES = ["standard_normal", "neals_funnel", "gaussian_mixture", "correlated_gaussian"]
GROUP_DIMS = [1, 2, 4, 8, 9, 16, 17, 32, 33, 50, 64, 65, 128]
GROUP_CHAINS = [1, 3, 7, 33, 8191, 16385]
GROUP_SCHEDULES = [(None, 64), ("constant", 1), ("tanh", 0), ("sigmoid", 16), ("linear", 3),
                   ("sine", 64)]


@pytest.mark.parametrize("n", GROUP_CHAINS)
@pytest.mark.parametrize("dim", GROUP_DIMS)
@pytest.mark.parametrize("family", GROUP_FAMILIES)
def test_lane_group_kernel_1_matches_plain(dev, family, dim, n):
    """Kernel 1 against its plain version under every schedule, injected
    and Philox: accepts equal away from the MH borderline, states within
    1e-4."""
    info, q, lp, grad, g = _inputs(dev, family, dim, n, 31 * dim + n)
    inv_mass = torch.rand(dim, generator=g, device=dev) + 0.5
    for schedule, steps in GROUP_SCHEDULES:
        eps = 0.01 if steps > 16 else 0.05
        args = (info, steps, ft.SCHEDULE_IDS[schedule], q, lp, grad,
                ft.kernel_scalars(eps, 0.7, 3.0, dev), inv_mass)
        for rand, log_u in _rand(dev, g, n, dim):
            _assert_close(ft.grahmc_step_kernel(*args, **rand),
                          ft.grahmc_step_plain(*args, **rand), log_u)


@pytest.mark.parametrize("dim", GROUP_DIMS)
@pytest.mark.parametrize("family", GROUP_FAMILIES)
def test_lane_group_chains_do_not_depend_on_the_count(dev, family, dim):
    """A chain's outputs do not depend on how many chains a launch holds
    (its Philox counter is its row), nor so on the lanes the count picks:
    the rows of each count, from a warp per chain to the fewest lanes and
    partly used warps, equal the first rows of 32,768 chains bit for bit.
    So every layout sums in the warp-per-chain order, and the clamped
    groups of a partly used warp store nothing."""
    info, q, lp, grad, g = _inputs(dev, family, dim, 32768, 7 * dim)
    sched = ft.SCHEDULE_IDS["tanh"]
    scalars = ft.kernel_scalars(0.05, 0.7, 3.0, dev)
    inv_mass = torch.rand(dim, generator=g, device=dev) + 0.5
    (inj, _), (phil, _) = _rand(dev, g, 32768, dim)
    full = {mode: ft.grahmc_step_kernel(info, 16, sched, q, lp, grad, scalars, inv_mass, **rand)
            for mode, rand in (("injected", inj), ("philox", phil))}
    for n in [1, 3, 7, 33, 2049, 4097, 8191, 8193, 16383, 16385]:
        cut = {"injected": dict(p0=inj["p0"][:n].contiguous(), u=inj["u"][:n].contiguous()),
               "philox": phil}
        for mode, rand in cut.items():
            part = ft.grahmc_step_kernel(info, 16, sched, q[:n].contiguous(),
                                         lp[:n].contiguous(), grad[:n].contiguous(), scalars,
                                         inv_mass, **rand)
            for k, (a, b) in enumerate(zip(part, full[mode])):
                if a.dtype == torch.float32:
                    _assert_bits(a, b[:n], f"{family} D={dim} C={n} {mode} output {k}")
                else:
                    assert torch.equal(a, b[:n])


@pytest.mark.parametrize("rungs,chains", [(3, 333), (3, 7), (3, 5461), (2, 8193), (6, 8192),
                                          (1, 33)])
@pytest.mark.parametrize("dim", [1, 9, 10, 33, 50, 128])
@pytest.mark.parametrize("family", GROUP_FAMILIES)
def test_lane_group_scaled_kernel_matches_plain(dev, family, dim, rungs, chains):
    """1b against its plain version under the tempered row's tanh schedule
    and NO_FRICTION, injected and Philox, with rung_chains no multiple of
    the chains a warp holds where the count takes lane groups (a warp's
    groups in two rungs)."""
    n = rungs * chains
    info, q, lp, grad, g = _inputs(dev, family, dim, n, 13 * dim + n)
    invm = torch.rand(dim, generator=g, device=dev) + 0.5
    betas = torch.linspace(1.0, 0.05, rungs, device=dev)
    table = ft.rung_table(0.05 / torch.sqrt(betas), 0.1, 5.0, betas, dev)
    beta_row = betas.repeat_interleave(chains)
    slp, sgrad = (beta_row * lp).contiguous(), (beta_row[:, None] * grad).contiguous()
    for schedule in ("tanh", None):
        sargs = (info, 16, ft.SCHEDULE_IDS[schedule], q, slp, sgrad, table, invm)
        for rand, log_u in _rand(dev, g, n, dim):
            _assert_close(ft.grahmc_scaled_kernel(*sargs, **rand),
                          ft.grahmc_scaled_plain(*sargs, **rand), log_u)


# 1c's lane groups: the chain counts where its diagonal launch on the
# grouped families takes them (4 lanes a chain at D = 10, 8 at D = 50;
# 16,385 chains leave the last warp one chain), as test_scaled_and_bridged_
# kernels_match_plain holds it at 1,200 chains.
BRIDGED_GROUP_CHAINS = [16385, 65536]


@pytest.mark.parametrize("n", BRIDGED_GROUP_CHAINS)
@pytest.mark.parametrize("dim", [10, 50])
@pytest.mark.parametrize("family", GROUP_FAMILIES)
def test_lane_group_bridged_kernel_matches_plain(dev, family, dim, n):
    """1c in lane groups (beta 0.05, 0.5, 1; base N(0.5, 2^2 I), no
    friction, L = 8) against its plain version, injected and Philox:
    accepts equal away from the MH borderline, states within 1e-4."""
    info, q, lp, grad, g = _inputs(dev, family, dim, n, 11 * dim + n)
    invm = torch.rand(dim, generator=g, device=dev) + 0.5
    eps = 0.02 if family == "neals_funnel" else 0.05
    base = ft.bridge_base(0.5, 2.0, dim, dev)
    for beta in (0.05, 0.5, 1.0):
        mixture = ft.bridged_vag(ft.device_vag(info), torch.tensor(beta, device=dev),
                                 torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                 base.mean, base.inv_scale)
        blp, bgrad = mixture(q)
        bargs = (info, 8, 0, q, blp.contiguous(), bgrad.contiguous(),
                 ft.bridge_scalars(eps, 0.0, 1.0, beta, base.log_norm, dev), base.mean,
                 base.inv_scale, invm)
        for rand, log_u in _rand(dev, g, n, dim):
            before = ft.grahmc_bridged_kernel.variant_launches["diagonal"]
            kern = ft.grahmc_bridged_kernel(*bargs, **rand)
            assert ft.grahmc_bridged_kernel.variant_launches["diagonal"] == before + 1
            _assert_close(kern, ft.grahmc_bridged_plain(*bargs, **rand), log_u)


@pytest.mark.parametrize("n", BRIDGED_GROUP_CHAINS)
@pytest.mark.parametrize("dim", [10, 50])
@pytest.mark.parametrize("family", GROUP_FAMILIES)
def test_lane_group_bridged_kernel_at_beta_one_equals_kernel_1(dev, family, dim, n):
    """At beta = 1, 1c in lane groups (its lp at a trajectory's last
    substep alone) gives kernel 1's results, tanh friction, injected and
    Philox: equal as torch.equal holds test_variants_at_beta_one_equal_
    kernel_1_bit_for_bit's (NaN equal to NaN). Bit for bit but for the sign
    of an exact zero: the bridge adds -(1 - beta) z (1/S), +0 or -0 at
    beta = 1, to kernel 1's gradient, so a zero entry may change sign (one
    of the correlated Gaussian's 655,360 at D = 10, 65,536 chains). On the
    funnel at K >= 2 registers a warp lane 1c keeps its warp kernel's
    rounding of the log-density's sum_sq inv_var + d_rest x0, which nvcc
    fused otherwise in kernel 1 (fused_trajectory_bridged.cu:
    Bridged::log_density): there lp, delta H and the proposal's lp differ
    in their last bits, and are held within 1e-5 + 1e-6 |lp|."""
    info, q, lp, grad, g = _inputs(dev, family, dim, n, 13 * dim + n)
    ones = torch.ones(dim, device=dev)
    base = ft.bridge_base(0.0, 6.0, dim, dev)
    eps = 0.05 if family == "neals_funnel" else 0.3
    sched = ft.SCHEDULE_IDS["tanh"]
    lp_rounding = family == "neals_funnel" and dim > 32
    for rand, _ in _rand(dev, g, n, dim):
        plain = ft.grahmc_step_kernel(info, 16, sched, q, lp, grad,
                                      ft.kernel_scalars(eps, 0.1, 5.0, dev), ones, **rand)
        bridged = ft.grahmc_bridged_kernel(
            info, 16, sched, q, lp, grad,
            ft.bridge_scalars(eps, 0.1, 5.0, 1.0, base.log_norm, dev), base.mean,
            base.inv_scale, ones, **rand)
        for k, (a, b) in enumerate(zip(bridged, plain)):
            if lp_rounding and k in (1, 4, 6):    # lp, delta H, the proposal's lp
                scale = plain[6].abs() if k == 4 else b.abs()
                assert bool(((a - b).abs() <= 1e-5 + 1e-6 * scale).all()), (
                    f"{family} D={dim} C={n} output {k}")
                continue
            same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b
            assert bool(same.all()), f"{family} D={dim} C={n} output {k}"


# Kernel 3 with the accept draw in the lane group's spare lane (csrc/
# fused_rwmh.cu: where ceil(D / 4) < G the group's last lane draws block
# ACCEPT_DRAW and shuffles its first Box-Muller logarithm, log u, to the
# group; where D fills the group every lane draws the accept block after
# its own): against the plain version under chip_smoke.py's rule for kernel
# 3 (each chain's accept sequence equal on all but SPLIT_MAX of the chains,
# the agreeing chains' state and history within 1e-4), and a chain's
# outputs bit for bit the same at every chain count.
SPLIT_MAX = 1e-3               # chip_smoke.py's: the share of chains that may split
RWMH_GROUP_DIMS = [1, 2, 3, 4, 5, 8, 10, 13, 16, 20, 50, 100, 128]


def _rwmh_inputs(dev, dim, n, seed, transitions=8):
    info, q, _, _, g = _inputs(dev, "standard_normal", dim, n, seed)
    lp = pt.device_lp(info)(q).contiguous()
    noise = torch.randn((transitions, n, dim), generator=g, device=dev)
    u = torch.rand((transitions, n), generator=g, device=dev).clamp_min(2.0 ** -25)
    key = torch.tensor([21, -22], dtype=torch.int32, device=dev)
    return info, q, lp, fr.rwmh_scale(1.6 / dim ** 0.5, dev), (dict(noise=noise, u=u),
                                                              dict(key=key, call=4))


@pytest.mark.parametrize("n", [1, 7, 1024, 4099])
@pytest.mark.parametrize("dim", RWMH_GROUP_DIMS)
def test_rwmh_spare_lane_kernel_matches_plain(dev, dim, n):
    """Kernel 3 at D with a spare lane (10, 20, 50, 100) and without (1-5,
    8, 13, 16, 128), injected and Philox, against its plain version."""
    info, q, lp, scale, rands = _rwmh_inputs(dev, dim, n, 31 * dim + n)
    n_hist = min(n, 37)
    for rand in rands:
        kern = fr.rwmh_multistep_kernel(info, 8, q, lp, scale, n_hist, **rand)
        plain = fr.rwmh_multistep_plain(info, 8, q, lp, scale, n_hist, **rand)
        agree = (kern[2] == plain[2]).all(dim=0)
        assert n - int(agree.sum()) <= SPLIT_MAX * n, f"D={dim} C={n}: chains split"
        hist = agree[:n_hist]
        for a, b in ((kern[0][agree], plain[0][agree]), (kern[1][agree], plain[1][agree]),
                     (kern[3][:, hist], plain[3][:, hist]), (kern[4][:, hist], plain[4][:, hist])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        if n >= 1024:
            assert 0.02 < float(plain[2].float().mean()) < 0.98


@pytest.mark.parametrize("dim", RWMH_GROUP_DIMS)
def test_rwmh_chains_do_not_depend_on_the_count(dev, dim):
    """A chain's kernel-3 outputs, its accept draw from the spare lane or
    its own second block, are the same bits at every chain count (its
    Philox counter is its row): partly used warps' clamped chains store
    nothing and draw nothing into another chain."""
    info, q, lp, scale, (inj, phil) = _rwmh_inputs(dev, dim, 4099, 5 * dim)
    full = {mode: fr.rwmh_multistep_kernel(info, 8, q, lp, scale, 40, **rand)
            for mode, rand in (("injected", inj), ("philox", phil))}
    for n in [1, 3, 7, 33, 1024, 4097]:
        cut = {"injected": dict(noise=inj["noise"][:, :n].contiguous(),
                                u=inj["u"][:, :n].contiguous()), "philox": phil}
        for mode, rand in cut.items():
            part = fr.rwmh_multistep_kernel(info, 8, q[:n].contiguous(), lp[:n].contiguous(),
                                            scale, min(n, 40), **rand)
            for k, (a, b) in enumerate(zip(part, full[mode])):
                b = b[:n] if k < 2 else b[:, :n]
                if a.dtype == torch.float32:
                    _assert_bits(a, b, f"D={dim} C={n} {mode} output {k}")
                else:
                    assert torch.equal(a, b)


# Kernel 2's data-carrying 2b, block-tiled (csrc/tiled_step.cuh:
# grahmc_tiled_multistep_kernel: HIER_TILE_CHAINS chains a block through 1d's
# evaluator, T transitions in lockstep): against its plain version at config
# 5's shape and at ragged chain counts, both metrics, T 1 and 8, and a
# chain's outputs bit for bit the same at every count. Each of the T
# transitions is held to one plain transition from the kernel's own state
# before it (its history; the gradient the potential's there) with that
# transition's draws, as kernel 1 is held (_assert_close): over 8
# transitions the diagonal leapfrog, FMA-contracted in the kernel and not in
# the plain version, carries a few chains in 4,096 more than 1e-4 apart
# from this wide state, which a comparison of the whole run would count
# against the kernel.
@pytest.mark.parametrize("transitions", [1, 8])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("n", [1, 31, 33, 4096, 4099])
def test_tiled_multistep_matches_plain(dev, n, dense, transitions):
    info, q, lp, grad, g = _hier(dev, 100, 256, n, n + 3 * transitions)
    invm, l_inv = _dense_metric(dev, 100, g) if dense else (
        torch.rand(100, generator=g, device=dev) * 0.5 + 0.25, None)
    tanh = ft.SCHEDULE_IDS["tanh"]
    scalars = ft.kernel_scalars(0.1 if dense else 0.2, 0.5, 0.5, dev)
    name = "dense+data" if dense else "diagonal+data"
    p0 = torch.randn((transitions, n, 100), generator=g, device=dev)
    if dense:
        p0 = ft.unwhiten(p0.reshape(-1, 100), invm, l_inv).reshape(transitions, n, 100)
    u = torch.rand((transitions, n), generator=g, device=dev).clamp_min(2.0 ** -25)
    key = torch.tensor([9, 10], dtype=torch.int32, device=dev)
    vag = ft.device_vag(info)
    for rand in (dict(p0=p0.contiguous(), u=u), dict(key=key, call=2)):
        before = ft.grahmc_multistep_kernel.variant_launches[name]
        kern = ft.grahmc_multistep_kernel(info, 8, tanh, transitions, q, lp, grad, scalars,
                                          invm, l_inv=l_inv, **rand)
        assert ft.grahmc_multistep_kernel.variant_launches[name] == before + 1
        q_t, lp_t, grad_t = q, lp, grad
        for t in range(transitions):
            p0_t, u_t = ft._randoms(rand.get("key"), 2, t, None if "key" in rand else p0[t],
                                    None if "key" in rand else u[t], invm, l_inv, n, 100, dev)
            plain = ft.grahmc_step_plain(info, 8, tanh, q_t, lp_t, grad_t, scalars, invm,
                                         p0=p0_t.contiguous(), u=u_t.contiguous(), l_inv=l_inv)
            border = (torch.log(u_t) - torch.clamp(-plain[4], max=0.0)).abs() < 1e-4
            assert not bool(((kern[3][t] != plain[3]) & ~border).any()), f"t={t}"
            same = kern[3][t] == plain[3]
            for a, b in ((kern[5][t], plain[0]), (kern[6][t], plain[1])):
                torch.testing.assert_close(a[same], b[same], rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(kern[4][t][same], plain[4][same], rtol=2e-3, atol=2e-3)
            q_t, lp_t = kern[5][t].contiguous(), kern[6][t].contiguous()
            grad_t = vag(q_t)[1].contiguous()
        assert torch.equal(kern[0], kern[5][-1]) and torch.equal(kern[1], kern[6][-1])
        # tau's gradient, shrink - (D - 1) / 2 - tau, cancels: the final
        # gradient is held to the potential's at the kernel's own q, as
        # _tiled_check holds 1d's
        torch.testing.assert_close(kern[2], grad_t, rtol=1e-4, atol=1e-4)
    if n >= 4096:
        assert 0.05 < float(kern[3].float().mean()) < 0.99


@pytest.mark.parametrize("dense", [False, True])
def test_tiled_multistep_chains_do_not_depend_on_the_count(dev, dense):
    """The tiled 2b's rows at 1, 31, 32, 33 and 4,096 chains (a ragged last
    block whose warps past n_chains run zero rows) equal the first rows of
    4,099 chains bit for bit, injected and Philox, T = 3."""
    info, q, lp, grad, g = _hier(dev, 100, 256, 4099, 71)
    invm, l_inv = _dense_metric(dev, 100, g) if dense else (
        torch.rand(100, generator=g, device=dev) * 0.5 + 0.25, None)
    scalars = ft.kernel_scalars(0.1 if dense else 0.2, 0.5, 0.5, dev)
    p0 = torch.randn((3, 4099, 100), generator=g, device=dev)
    if dense:
        p0 = ft.unwhiten(p0.reshape(-1, 100), invm, l_inv).reshape(3, 4099, 100)
    inj = dict(p0=p0.contiguous(),
               u=torch.rand((3, 4099), generator=g, device=dev).clamp_min(2.0 ** -25))
    phil = dict(key=torch.tensor([5, 6], dtype=torch.int32, device=dev), call=1)

    def run(n, rand):
        return ft.grahmc_multistep_kernel(info, 8, ft.SCHEDULE_IDS["tanh"], 3, q[:n].contiguous(),
                                          lp[:n].contiguous(), grad[:n].contiguous(), scalars,
                                          invm, l_inv=l_inv, **rand)
    full = {"injected": run(4099, inj), "philox": run(4099, phil)}
    for n in [1, 31, 32, 33, 4096]:
        cut = {"injected": dict(p0=inj["p0"][:, :n].contiguous(), u=inj["u"][:, :n].contiguous()),
               "philox": phil}
        for mode, rand in cut.items():
            for k, (a, b) in enumerate(zip(run(n, rand), full[mode])):
                b = b[:n] if k < 3 else b[:, :n]
                if a.dtype == torch.float32:
                    _assert_bits(a, b, f"dense={dense} C={n} {mode} output {k}")
                else:
                    assert torch.equal(a, b)


# Kernel 2 and 2a against their plain version: every family at every D of
# K2_DIMS (the 2- and 3-D families at theirs) and K2_CHAINS chains, each
# case one (schedule, L, T) of K2_RUNS in turn, so a family meets every
# schedule, L 0, 1, 16 and 64 and T 1, 2 and 8; injected and Philox draws,
# both metrics. At 4,099 chains and D >= 65 the grouped families' diagonal
# launch takes lane groups of 16 (csrc/trajectory.cuh:step_lanes).
K2_DIMS = [1, 2, 4, 9, 10, 16, 17, 32, 33, 50, 64, 65, 128]
K2_CHAINS = [1, 3, 33, 1024, 4099]
K2_RUNS = [(None, 64, 2), ("constant", 16, 8), ("tanh", 1, 1), ("sigmoid", 0, 2),
           ("linear", 16, 1), ("sine", 64, 1), ("tanh", 16, 2), ("constant", 1, 8)]
K2_TARGETS = {f: K2_DIMS for f in ["standard_normal", "neals_funnel", "correlated_gaussian",
                                   "gaussian_mixture"] + NEW_FAMILIES}
K2_TARGETS.update({"rosenbrock": K2_DIMS[1:], "multimodal_funnel_2d": [2],
                   "concentric_l1_2d": [2], "concentric_l1_3d": [3], "nested_l1_2d": [2],
                   "nested_l1_3d": [3]})
# Chains a transition that may drift past _assert_close's 1e-4 (accepts
# equal, the state, its gradient or delta H apart), each with q within
# K2_DRIFT_CEILING (absolute and relative) of the plain version's: the
# family's FAMILY_DRIFT, and on the funnel 4 at its neck, where the diagonal
# leapfrog's FMA rounding (targets.cuh:ROUNDED_LEAPFROG) grows (on an H100
# one chain of 4,099 at D = 128 drifted 2e-4 in q). The funnel's chains
# that fall into the neck diverge in both versions with delta H <= -1000,
# which both accept: up to 5% of them (at least 2), as the kernel-4 tests
# allow the neck (the plain version alone diverges on up to 1.7% of a
# case's chains a transition; K2_DIVERGED).
K2_DRIFT = {"neals_funnel": 4}
K2_DRIFT_CEILING = 1e-2
K2_DIVERGED = {"neals_funnel": 0.05}


def _k2_inputs(dev, family, dim, n, seed):
    """(info, q, lp, grad, generator): log-gamma inside its support,
    Rosenbrock near its mode, the others from their init samplers (the
    funnel's reaches its neck) or N(0, 0.25 I)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = get_target(family, dim=dim)
    if family == "log_gamma":
        q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.5
    elif family == "rosenbrock":
        q = 1.0 + 0.05 * torch.randn((n, dim), generator=g, device=dev)
    elif t.init_sampler is not None:
        q = t.init_sampler(g, n)
    else:
        q = torch.randn((n, dim), generator=g, device=dev) * 0.5
    q = q.float().contiguous()
    lp, grad = t.value_and_grad_fn(q)
    return t.value_and_grad_fn.kernel_info, q, lp.float().contiguous(), grad.float().contiguous(), g


def _multistep_check(info, steps, sched, transitions, q, lp, grad, scalars, invm, l_inv, rand,
                     max_drift=0, max_diverged=0):
    """Kernel 2 against its plain version transition by transition: each
    transition's plain step starts from the kernel's state after the one
    before (the gradient there from the eager value_and_grad), so rounding
    does not carry from one transition to the next; _assert_close on each
    transition's accepts, delta H and new state (q and lp from the
    history), and the final outputs as the history's last row. A trajectory
    that diverged in both versions (|delta H| >= 1000, its energy rounding
    amplified, as _assert_close_or_drift counts them) has the same accept
    in both: rejected, it keeps its state, the one before; at most
    `max_diverged` a transition diverge and are accepted by both
    (K2_DIVERGED). Of the others at most
    `max_drift` a transition may drift (K2_DRIFT), each with q within
    K2_DRIFT_CEILING, and _assert_close holds the rest."""
    n, dim = q.shape
    variant = "dense" if invm.ndim == 2 else "diagonal"
    before = ft.grahmc_multistep_kernel.variant_launches[variant]
    kern = ft.grahmc_multistep_kernel(info, steps, sched, transitions, q, lp, grad, scalars,
                                      invm, l_inv=l_inv, **rand)
    assert ft.grahmc_multistep_kernel.variant_launches[variant] == before + q.is_cuda
    vag = ft.device_vag(info)
    q_t, lp_t, grad_t = q, lp, grad
    for t in range(transitions):
        p0_t, u_t = ft._randoms(rand.get("key"), rand.get("call", 0), t,
                                None if "key" in rand else rand["p0"][t],
                                None if "key" in rand else rand["u"][t], invm, l_inv, n, dim,
                                q.device)
        plain = ft.grahmc_step_plain(info, steps, sched, q_t, lp_t, grad_t, scalars, invm,
                                     p0=p0_t.contiguous(), u=u_t.contiguous(), l_inv=l_inv)
        q_t, lp_t = kern[5][t].contiguous(), kern[6][t].contiguous()
        grad_t = vag(q_t)[1].float().contiguous()
        wild = (kern[4][t].abs() >= 1000.0) & (plain[4].abs() >= 1000.0)
        split = wild & (kern[3][t] != plain[3])
        print(f"READING diverged in both: {int(wild.sum())} of {n} chains, accepted by one "
              f"version alone: {int(split.sum())}")
        assert not bool(split.any()), int(split.sum())
        held = wild & ~kern[3][t]
        assert int((wild & ~held).sum()) <= max_diverged, int((wild & ~held).sum())
        torch.testing.assert_close(q_t[held], plain[0][held])
        close = (((q_t - plain[0]).abs() <= 1e-4 + 1e-4 * plain[0].abs()).all(dim=1)
                 & ((grad_t - plain[2]).abs() <= 1e-4 + 1e-4 * plain[2].abs()).all(dim=1)
                 & ((lp_t - plain[1]).abs() <= 1e-4 + 1e-4 * plain[1].abs())
                 & ((kern[4][t] - plain[4]).abs() <= 2e-3 + 2e-3 * plain[4].abs()))
        drifted = ~wild & (kern[3][t] == plain[3]) & ~close
        assert int(drifted.sum()) <= max_drift, int(drifted.sum())
        far = (q_t - plain[0]).abs() > K2_DRIFT_CEILING * (1.0 + plain[0].abs())
        assert not bool((drifted[:, None] & far).any())
        keep = ~wild & ~drifted
        _assert_close(tuple(x[keep] for x in (q_t, lp_t, grad_t, kern[3][t], kern[4][t])),
                      tuple(x[keep] for x in plain[:5]), torch.log(u_t)[keep])
    assert torch.equal(kern[0], kern[5][-1]) and torch.equal(kern[1], kern[6][-1])
    torch.testing.assert_close(kern[2], grad_t, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("family", sorted(K2_TARGETS))
def test_kernel_2_matches_plain(dev, family, dense):
    i = 0
    for dim in K2_TARGETS[family]:
        for n in K2_CHAINS:
            info, q, lp, grad, g = _k2_inputs(dev, family, dim, n, 97 * dim + n + dense)
            invm, l_inv = _dense_metric(dev, dim, g) if dense else (
                torch.rand(dim, generator=g, device=dev) + 0.5, None)
            schedule, steps, transitions = K2_RUNS[i % len(K2_RUNS)]
            i += 1
            eps = (0.002 if steps > 16 else 0.01) if family == "rosenbrock" else (
                0.01 if steps > 16 else 0.05)
            scalars = ft.kernel_scalars(eps, 0.7, 3.0, dev)
            z = torch.randn((transitions, n, dim), generator=g, device=dev)
            p0 = z if l_inv is None else ft.unwhiten(z.reshape(-1, dim), invm, l_inv).reshape(
                transitions, n, dim)
            u = torch.rand((transitions, n), generator=g, device=dev).clamp_min(2.0 ** -25)
            key = torch.tensor([11, -12], dtype=torch.int32, device=dev)
            for rand in (dict(p0=p0.contiguous(), u=u), dict(key=key, call=3)):
                _multistep_check(info, steps, ft.SCHEDULE_IDS[schedule], transitions, q, lp,
                                 grad, scalars, invm, l_inv, rand,
                                 K2_DRIFT.get(family, FAMILY_DRIFT.get(family, (0,))[0]),
                                 max(2, math.ceil(K2_DIVERGED[family] * n))
                                 if family in K2_DIVERGED else 0)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("dim", [2, 10, 33, 50, 128])
@pytest.mark.parametrize("family", GROUP_FAMILIES + ["student_t", "rosenbrock"])
def test_kernel_2_chains_do_not_depend_on_the_count(dev, family, dim, dense):
    """A chain's rows of kernel 2 and 2a do not depend on how many chains a
    launch holds, nor so on the lanes and the block size the count picks
    (csrc/trajectory.cuh:spread_warps, step_lanes): at 1, 3, 33, 1,024,
    4,099 and 8,193 chains, from blocks of 2 warps to lane groups of 4 to
    16 and partly used warps, they equal the first rows of 16,385 chains
    bit for bit, injected and Philox, T = 3."""
    n_full = 16385
    info, q, lp, grad, g = _k2_inputs(dev, family, dim, n_full, 5 * dim + dense)
    invm, l_inv = _dense_metric(dev, dim, g) if dense else (
        torch.rand(dim, generator=g, device=dev) + 0.5, None)
    scalars = ft.kernel_scalars(0.002 if family == "rosenbrock" else 0.05, 0.7, 3.0, dev)
    z = torch.randn((3, n_full, dim), generator=g, device=dev)
    p0 = z if l_inv is None else ft.unwhiten(z.reshape(-1, dim), invm, l_inv).reshape(
        3, n_full, dim)
    inj = dict(p0=p0.contiguous(),
               u=torch.rand((3, n_full), generator=g, device=dev).clamp_min(2.0 ** -25))
    phil = dict(key=torch.tensor([5, 6], dtype=torch.int32, device=dev), call=1)

    def run(n, rand):
        return ft.grahmc_multistep_kernel(info, 16, ft.SCHEDULE_IDS["tanh"], 3,
                                          q[:n].contiguous(), lp[:n].contiguous(),
                                          grad[:n].contiguous(), scalars, invm, l_inv=l_inv,
                                          **rand)
    full = {"injected": run(n_full, inj), "philox": run(n_full, phil)}
    for n in [1, 3, 33, 1024, 4099, 8193]:
        cut = {"injected": dict(p0=inj["p0"][:, :n].contiguous(), u=inj["u"][:, :n].contiguous()),
               "philox": phil}
        for mode, rand in cut.items():
            for k, (a, b) in enumerate(zip(run(n, rand), full[mode])):
                b = b[:n] if k < 3 else b[:, :n]
                if a.dtype == torch.float32:
                    _assert_bits(a, b, f"{family} D={dim} dense={dense} C={n} {mode} output {k}")
                else:
                    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The runner's diagnostics and mid-sampling resume on the card
# --------------------------------------------------------------------------

def _ar_history(shape, dtype, device):
    """An AR(0.7) history of `shape`, rounded to tenths (ties), made from a
    seed on `device`."""
    S, C, D = shape
    g = torch.Generator(device=device).manual_seed(S + C)
    x = torch.empty(shape, dtype=dtype, device=device)
    x[0] = torch.randn((C, D), generator=g, dtype=dtype, device=device)
    for s in range(1, S):
        x[s] = 0.7 * x[s - 1] + torch.randn((C, D), generator=g, dtype=dtype, device=device)
    return torch.round(x * 10) / 10


def _assert_diagnostics_close(card, cpu, rtol, atol=0.0):
    import numpy as np
    for k, v in cpu.items():
        if k == "summary":
            for kk, vv in v.items():
                np.testing.assert_allclose(card[k][kk], vv, rtol=rtol, atol=atol, err_msg=kk)
        else:
            np.testing.assert_allclose(card[k], v, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("shape", [(200, 16, 5), (201, 1024, 3), (10000, 64, 2)])
def test_compute_diagnostics_on_the_card_matches_the_cpu(dev, shape, chunked, monkeypatch):
    """compute_diagnostics of one float64 history on the card and on the
    CPU, in one pass and (with the size threshold at 1 byte) through the
    chain-chunked estimators: cuFFT and pocketfft differ in the last bits,
    so rtol 1e-9."""
    from mcmc_tpu_torch import diagnostics as T
    if chunked:
        monkeypatch.setattr(T, "_CHUNKED_THRESHOLD_BYTES", 1)
    x = _ar_history(shape, torch.float64, "cpu")
    _assert_diagnostics_close(T.compute_diagnostics(x.to(dev)), T.compute_diagnostics(x),
                              rtol=1e-9)


def test_compute_diagnostics_of_the_runners_history_on_the_card(dev, monkeypatch):
    """The runner's history at the canonical cell's size (10,000 draws x
    1,024 chains x 10, float32 as the card's positions: 0.41 GB, past the
    threshold) goes through the chain-chunked estimators on the card and
    agrees with the CPU's on the same values. Tolerance rtol 1e-3 with
    atol 1e-5: float32 sums over 10M draws differ in the order of 1e-7 of
    their scale between the two devices, and where a Geyer pair sits that
    close to 0 one device may keep it and the other stop, moving tau by
    one pair of ~1e-4 (the AR(0.7) autocorrelation at the cut) in 5.7."""
    from mcmc_tpu_torch import diagnostics as T
    seen = []
    real = T.compute_diagnostics_chunked

    def spy(samples, chain_chunk, dim_chunk):
        seen.append((samples.device.type, chain_chunk, dim_chunk))
        return real(samples, chain_chunk, dim_chunk)
    monkeypatch.setattr(T, "compute_diagnostics_chunked", spy)
    x = _ar_history((10000, 1024, 10), torch.float32, dev)
    card = T.compute_diagnostics(x)
    cpu = T.compute_diagnostics(x.cpu())
    assert [d for d, _, _ in seen] == ["cuda", "cpu"], seen
    _assert_diagnostics_close(card, cpu, rtol=1e-3, atol=1e-5)


def test_w2_tracker_without_a_generator_runs_on_the_card(dev, monkeypatch):
    """A tracker built without a generator, given CUDA samples, draws its
    reference and directions on the card, from a generator seeded
    DEFAULT_REFERENCE_SEED there, and projects and sorts there; the samples
    never go to the host. A CPU tracker given the same reference and
    directions gives the same W2 to rtol 1e-10 (float64 products)."""
    from mcmc_tpu_torch.diagnostics import wasserstein as W
    from mcmc_tpu_torch.targets import get_reference_sampler
    devices = []
    real = W._sorted_projections

    def spy(samples, directions):
        devices.append((samples.device.type, directions.device.type))
        return real(samples, directions)
    monkeypatch.setattr(W, "_sorted_projections", spy)
    tr = W.ConvergenceW2Tracker("standard_normal", 10)
    s = torch.randn((500, 64, 10), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    w2 = tr.w2(s)
    assert devices == [("cuda", "cuda")] * 2, devices
    assert tr.generator.device.type == "cuda" and tr._ref_sorted.device.type == "cuda"
    assert 0.0 < w2 < 0.05
    g = torch.Generator(device=dev).manual_seed(W.DEFAULT_REFERENCE_SEED)
    ref = get_reference_sampler("standard_normal", 10)(g, 50000)
    dirs = W.unit_directions(g, 500, 10)
    given = W.ConvergenceW2Tracker("standard_normal", 10, reference=ref, directions=dirs)
    assert given.w2(s) == w2
    on_cpu = W.ConvergenceW2Tracker("standard_normal", 10, reference=ref.cpu(),
                                    directions=dirs.cpu())
    assert abs(on_cpu.w2(s.cpu()) - w2) <= 1e-10 * w2


def test_resumed_fused_grahmc_run_equals_the_uninterrupted_one(dev, tmp_path, monkeypatch):
    """The runner's tracked GRAHMC row through kernels 1 (warmup) and 2
    (sampling) on the card, preempted after two checkpoints and resumed:
    the same trace, row and draws, bit for bit."""
    import hashlib

    from mcmc_tpu_torch.benchmark import runner as R
    from mcmc_tpu_torch.utils.checkpoint import SamplingCheckpoint

    t = get_target("neals_funnel_noncentered", dim=6)
    kw = dict(n_chains=256, num_warmup=300, num_samples=400, schedule_type="tanh", num_steps=8,
              track_convergence=True, mesh_devices="off")
    assert R._resolve_backend("grahmc", t, dev) == "fused"
    histories = []
    real_diag = R.compute_diagnostics

    def hashing_diag(samples):
        histories.append(hashlib.sha256(samples.contiguous().cpu().numpy().tobytes()).hexdigest())
        return real_diag(samples)
    monkeypatch.setattr(R, "compute_diagnostics", hashing_diag)
    launches = ft.grahmc_multistep_kernel.launches
    ra = R.run_single_benchmark_with_L("grahmc", t, "neals_funnel_noncentered",
                                       R.make_generator(3, dev),
                                       warmup_cache_dir=str(tmp_path / "a"), **kw)
    assert ra.get("error") is None
    assert ft.grahmc_multistep_kernel.launches > launches
    full = histories[-1]                     # Phase 3's history

    calls = {"n": 0}
    real_save = SamplingCheckpoint.save

    def killing_save(self, *args, **kwargs):
        if calls["n"] >= 2:
            raise RuntimeError("simulated preemption")
        calls["n"] += 1
        return real_save(self, *args, **kwargs)
    monkeypatch.setattr(SamplingCheckpoint, "save", killing_save)
    killed = R.run_single_benchmark_with_L("grahmc", t, "neals_funnel_noncentered",
                                           R.make_generator(3, dev),
                                           warmup_cache_dir=str(tmp_path / "b"), **kw)
    assert "simulated preemption" in str(killed.get("error"))
    monkeypatch.setattr(SamplingCheckpoint, "save", real_save)
    rb = R.run_single_benchmark_with_L("grahmc", t, "neals_funnel_noncentered",
                                       R.make_generator(3, dev),
                                       warmup_cache_dir=str(tmp_path / "b"), **kw)
    assert rb.get("error") is None and rb["warmup_restored"] is True
    assert histories[-1] == full
    assert rb["convergence_trace"] == ra["convergence_trace"]
    for field in ("accept_rate", "rhat_max", "ess_bulk_min", "ess_tail_min", "z_score_max",
                  "sliced_w2", "sliced_w2_transformed", "step_size", "gamma"):
        assert rb[field] == ra[field], field


# ----------------------------------------------------------------------------
# The chain mesh: two gloo ranks sharing cuda:0 (mcmc_tpu_torch.parallel)
# ----------------------------------------------------------------------------

MESH_CHAINS = 8192       # 4,096 a rank


def _card_mesh_cases(mesh):
    """Each sharded run on this rank against a 1-rank run over its chains
    (bit for bit), with the kernels' launch counts of the mesh runs."""
    from mcmc_tpu_torch import parallel as P
    from mcmc_tpu_torch.parallel import fused_sharded as fs
    from mcmc_tpu_torch.samplers import smc as ts
    r, dev = mesh.rank, mesh.device
    t = get_target("neals_funnel", dim=10)
    init = t.init_sampler(torch.Generator(device=dev).manual_seed(0), MESH_CHAINS,
                          dtype=torch.float32)
    local = MESH_CHAINS // mesh.size
    block = slice(r * local, (r + 1) * local)
    solo = P.solo_mesh(dev, fold_index=r)

    def G(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    out, launches = {}, {}

    def both(name, run):
        """The mesh run (its launches counted) and the 1-rank run over this
        rank's chains: are the samples and final positions equal?"""
        for module in (ft, fn):
            module.reset_launches()
        a = run(init, mesh)
        launches[name] = dict(ft.grahmc_step_kernel.variant_launches,
                              multistep=ft.grahmc_multistep_kernel.launches,
                              scaled=ft.grahmc_scaled_kernel.launches,
                              **{f"nuts{k}": v for k, v in
                                 fn.nuts_window_kernel.variant_launches.items()})
        b = run(init[block], solo)
        out[name] = [bool(torch.equal(a.samples[:, block], b.samples)),
                     bool(torch.equal(a.final_state.position[block], b.final_state.position))]

    both("grahmc", lambda x, m: fs.grahmc_run_sharded(
        G(1), t, x, m, 0.05, 16, 1.0, 0.5, 20, collect_chains_per_device=local))
    for name, extra in (("nuts", {}), ("nuts_multinomial", {"proposal_scheme": "multinomial"}),
                        ("nuts_dense", {"inv_mass_matrix": torch.eye(10, device=dev) * 1.5})):
        both(name, lambda x, m, extra=extra: fs.nuts_persistent_run_sharded(
            G(2), t, x, m, 0.2, 4, steps_per_sample=16, collect_chains_per_device=local,
            **extra))
    both("tempered", lambda x, m: fs.tempered_run_sharded(
        G(3), t, x, m, 0.05, 8, 8, betas=torch.tensor([1.0, 0.4, 0.1], device=dev)))
    for module in (ft, fn):
        module.reset_launches()
    s = fs.smc_run_sharded(G(4), t.log_prob_fn, mesh, MESH_CHAINS, 10, 0.2, 8,
                           betas=torch.linspace(0.2, 1.0, 6), move_steps=2, base_scale=2.0,
                           value_and_grad_fn=t.value_and_grad_fn)
    launches["smc"] = {"bridged": ft.grahmc_bridged_kernel.launches}
    u = ts.smc_run(G(4), t.log_prob_fn, MESH_CHAINS, 10, 0.2, 8,
                   betas=torch.linspace(0.2, 1.0, 6), move_steps=2, base_scale=2.0,
                   value_and_grad_fn=t.value_and_grad_fn)
    out["smc"] = {"stages": (s.info["n_stages"], u.info["n_stages"]),
                  "log_z": (float(s.log_Z), float(u.log_Z)),
                  "finite": bool(torch.isfinite(s.particles).all())}
    out["launches"] = launches
    out["device"] = str(dev)
    return out


@pytest.fixture(scope="module")
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mcmc_tpu_torch.parallel.launch import run_ranks
    return run_ranks(f"{__file__}:_card_mesh_cases", 2, device="cuda", backend="gloo",
                     timeout=300)


@pytest.mark.parametrize("name", ["grahmc", "nuts", "nuts_multinomial", "nuts_dense",
                                  "tempered"])
@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_rank_on_card_equals_a_one_rank_run(card_mesh, name, rank):
    assert all(card_mesh[rank][name]), card_mesh[rank][name]
    assert card_mesh[rank]["device"] == "cuda:0"


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_runs_launch_their_kernels_on_card(card_mesh, rank):
    got = card_mesh[rank]["launches"]
    # 4,096 chains a rank: kernel 2 at T = 4 over the 20 draws, as the
    # single-device run takes it
    assert got["grahmc"]["multistep"] == 20 // 4 and got["grahmc"]["diagonal"] == 0
    assert got["nuts"]["nutsendpoint"] > 0 and got["nuts_multinomial"]["nutsmultinomial"] > 0
    assert got["nuts_dense"]["nutsdense"] > 0
    assert got["tempered"]["scaled"] == 8
    assert got["smc"]["bridged"] == 6 * 2


def test_mesh_smc_on_card_takes_the_unsharded_stages(card_mesh):
    for res in card_mesh:
        s = res["smc"]
        assert s["stages"][0] == s["stages"][1] == 6 and s["finite"]
        assert abs(s["log_z"][0] - s["log_z"][1]) < 0.5


def test_nccl_refuses_two_ranks_on_one_card(dev):
    if torch.cuda.device_count() > 1:
        pytest.skip("the card is not shared on a host with more than one")
    from mcmc_tpu_torch.parallel.launch import run_ranks
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one GPU"):
        run_ranks(f"{__file__}:_card_mesh_cases", 2, device="cuda", backend="nccl",
                  timeout=120)


# ----------------------------------------------------------------------------
# The tune-and-sample CLI (tuning/core.py), the profiler and compat on the card
# ----------------------------------------------------------------------------

CLI_WARMUP_TRANSITIONS = 2700 + 7 * (1000 + 150)     # the windowed warmup and its gamma tune


def _cli_launches():
    return (ft.grahmc_step_kernel.launches, ft.grahmc_multistep_kernel.launches,
            fr.rwmh_multistep_kernel.launches)


@pytest.mark.parametrize("sampler", ["grahmc", "hmc"])
def test_tune_cli_grid_launches_kernels_1_and_2(dev, sampler):
    """The GRAHMC grid's warmup and gamma tune run kernel 1 (HMC's warmup
    stays eager) and both samplers' batches kernel 2 at T 8."""
    from mcmc_tpu_torch.tuning import core
    t = get_target("neals_funnel", dim=10)
    before = _cli_launches()
    run = core.tune_and_sample_grahmc_grid if sampler == "grahmc" else core.tune_and_sample_hmc_grid
    r = run(torch.Generator(device=dev).manual_seed(0), t, n_chains=256, target_ess=10 ** 9,
            batch_size=64, max_samples=128, warmup_steps=500, num_steps_grid=[8])
    grew = [a - b for a, b in zip(_cli_launches(), before)]
    assert grew == [CLI_WARMUP_TRANSITIONS if sampler == "grahmc" else 0, 128 // 8, 0]
    assert r["best_config"]["num_steps"] == 8 and r["best_config"]["total_samples"] == 128
    assert math.isfinite(r["best_config"]["ess_bulk_min"])


def test_tune_cli_rwmh_launches_kernel_3(dev):
    """The RWMH tuner's DA iterations (4 transitions a call) and the
    batches (32 a call) run kernel 3."""
    from mcmc_tpu_torch.tuning import core
    t = get_target("standard_normal", dim=10)
    before = _cli_launches()
    r = core.tune_and_sample_rwmh(torch.Generator(device=dev).manual_seed(1), t, n_chains=512,
                                  target_ess=10 ** 9, batch_size=256, max_samples=512,
                                  warmup_steps=100)
    grew = [a - b for a, b in zip(_cli_launches(), before)]
    assert grew == [0, 0, len(r["history"]["scale_history"]) * 25 + 2 * 256 // 32]
    assert r["samples"].device.type == "cuda" and r["samples"].dtype == torch.float32
    assert bool(torch.isfinite(r["samples"]).all()) and 0.05 < r["mean_acceptance"] < 0.6


def test_tune_cli_main_runs_on_the_card_by_default(dev):
    from mcmc_tpu_torch.tuning import core
    r = core.main(["--sampler", "rwmh", "--dim", "4", "--chains", "64", "--warmup-steps", "50",
                   "--batch-size", "64", "--max-samples", "64"])
    assert r["samples"].device.type == "cuda" and r["total_samples"] == 64


def test_device_trace_names_the_multistep_kernel(dev, tmp_path):
    from mcmc_tpu_torch.utils import device_trace, force_completion
    t = get_target("neals_funnel", dim=10)
    g = torch.Generator(device=dev).manual_seed(2)
    init = t.init_sampler(g, 256, dtype=torch.float32)
    with device_trace(str(tmp_path)) as prof:
        res = tg.grahmc_run(g, t.log_prob_fn, init, 0.1, 8, 0.5, 1.0, 16,
                            value_and_grad_fn=t.value_and_grad_fn, backend="fused")
        assert force_completion(res) is res
    (trace,) = list(tmp_path.glob("*.pt.trace.json"))
    assert "grahmc_multistep_kernel" in trace.read_text()
    assert any("grahmc_multistep_kernel" in e.key for e in prof.key_averages())


def test_compat_rahmc_run_equals_grahmc_run_on_the_card(dev):
    from mcmc_tpu_torch import compat
    t = get_target("neals_funnel", dim=10)
    init = t.init_sampler(torch.Generator(device=dev).manual_seed(3), 1024, dtype=torch.float32)
    kw = dict(step_size=0.1, num_steps=8, gamma=0.5, steepness=1.0, num_samples=10)
    a = compat.rahmc_run(torch.Generator(device=dev).manual_seed(4), t.log_prob_fn, init, **kw)
    b = tg.grahmc_run(torch.Generator(device=dev).manual_seed(4), t.log_prob_fn, init, **kw)
    for x, y in zip(a, (b.samples, b.log_probs, b.accept_rate)):
        assert torch.equal(x, y)
    assert torch.equal(a[3].position, b.final_state.position)
