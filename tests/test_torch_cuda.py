"""The hand-written CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it runs on a GPU host without the JAX package's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
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
