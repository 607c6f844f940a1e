"""The mcmc_tpu_torch main-path slice as a whole, on the CPU: state carried
across from the JAX package, stationarity of both backends, the DA-tuned
fused run, and the import boundary (the port never imports jax)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.samplers import base as jbase  # noqa: E402
from mcmc_tpu.samplers import grahmc as jg  # noqa: E402
from mcmc_tpu.samplers import trajectory as jtraj  # noqa: E402
from mcmc_tpu.targets import neals_funnel as j_funnel  # noqa: E402
from mcmc_tpu_torch import interop  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers.base import init_chain_state  # noqa: E402
from mcmc_tpu_torch.targets import standard_normal  # noqa: E402
from mcmc_tpu_torch.tuning import dual_averaging as t_da  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_funnel_state(dim=10, chains=64, seed=0):
    jt = j_funnel(dim)
    q = jt.init_sampler(random.PRNGKey(seed), chains) * 0.5
    return jt, jbase.init_chain_state(q, jt.log_prob_fn, jt.value_and_grad_fn)


def _carry(jstate, device="cpu"):
    return interop.chain_state_from_numpy(*(np.asarray(f) for f in jstate),
                                          device=device)


def test_state_carried_across_gives_the_same_transition():
    """A JAX funnel ChainState (D=10, C=64) moved through interop, and one
    transition on the JAX step's own draws: the same result on both sides."""
    jt, jstate = _jax_funnel_state()
    tt = interop.target_from_tag(jt.value_and_grad_fn.pallas_info)
    tstate = _carry(jstate)
    assert tstate.position.dtype == torch.float64
    assert tstate.accept_count.dtype == torch.int32
    lp_t, g_t = tt.value_and_grad_fn(tstate.position)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(jstate.log_prob), rtol=1e-13)

    inv_mass = np.linspace(0.8, 1.2, 10)
    key = random.PRNGKey(5)
    _, jnew, (jacc, _, _, jdh) = jg.grahmc_step(
        key, jstate, jt.value_and_grad_fn, 0.15, 8, 1.0, 1.0,
        jnp.asarray(inv_mass), jg.constant_schedule)
    _, k_mom, k_acc = random.split(key, 3)
    p0 = jtraj.sample_momentum(k_mom, (64, 10), jnp.asarray(inv_mass), jnp.float64)
    u = random.uniform(k_acc, (64,), dtype=jnp.float64)
    tnew, (tacc, _, _, tdh) = tg.grahmc_transition(
        tstate, torch.from_numpy(np.array(p0)), torch.from_numpy(np.array(u)),
        tt.value_and_grad_fn, 0.15, 8, 1.0, 1.0,
        torch.from_numpy(inv_mass), tg.constant_schedule)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for ours, theirs in zip(tnew, jnew):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), rtol=1e-10, atol=1e-10)

    # the same carried state through the fused path (float32, injected draws)
    q32 = np.asarray(jstate.position, np.float32)
    lp32 = np.asarray(jstate.log_prob, np.float32)
    g32 = np.asarray(jstate.grad_log_prob, np.float32)
    p32, u32 = np.asarray(p0, np.float32), np.asarray(u, np.float32)
    run_j = jft.make_debug_trajectory(jt.value_and_grad_fn, 8, jg.constant_schedule,
                                      64, 10, layout="transposed")
    outs_j = run_j(*(jnp.asarray(a) for a in (q32, lp32, g32, p32, u32)), 0.15,
                   1.0, 1.0, jnp.asarray(inv_mass, jnp.float32))
    run_t = ft.make_debug_trajectory(tt.value_and_grad_fn, 8, tg.constant_schedule,
                                     64, 10)
    outs_t = run_t(*(torch.from_numpy(a) for a in (q32, lp32, g32, p32, u32)),
                   0.15, 1.0, 1.0, torch.from_numpy(inv_mass.astype(np.float32)))
    np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3]))
    np.testing.assert_allclose(outs_t[0].numpy(), np.asarray(outs_j[0]), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(outs_t[4].numpy(), np.asarray(outs_j[4]), rtol=2e-3,
                               atol=2e-3)


def test_target_from_tag_rejects_unported_and_bad_params():
    with pytest.raises(ValueError):
        interop.target_from_tag({"family": "no_such_family", "dim": 5,
                                 "params": {"scale": 0.1}})
    with pytest.raises(ValueError):
        interop.target_from_tag({"family": "neals_funnel", "dim": 5,
                                 "params": {"scale": 2.0}})


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("schedule,num_steps",
                         [("tanh", 8), ("sine", 8), ("linear", 8), ("constant", 7)])
def test_kernel_invariance_aggressive(backend, schedule, num_steps):
    """tests/test_samplers.py::test_grahmc_kernel_invariance_aggressive on the
    port: 32k chains from exact N(0, I_3) draws keep variance 1 through 60
    transitions at eps 0.5, gamma 0.5 (the t = i*eps friction grid gives
    var ~4.3 here)."""
    t = standard_normal(3)
    q0 = torch.randn((32768, 3), generator=torch.Generator().manual_seed(0))
    res = tg.grahmc_run(torch.Generator().manual_seed(1), t.log_prob_fn, q0,
                        step_size=0.5, num_steps=num_steps, gamma=0.5,
                        steepness=5.0, num_samples=60, burn_in=0,
                        collect_chains=1,
                        friction_schedule=tg.get_friction_schedule(schedule),
                        value_and_grad_fn=t.value_and_grad_fn, backend=backend)
    var = res.final_state.position.var(dim=0).numpy()
    np.testing.assert_allclose(var, 1.0, atol=0.06)
    assert float(res.accept_rate.mean()) > 0.5


def test_dual_averaging_tune_then_fused_run_on_funnel():
    """bench.py's main path at a small size: DA-tune the step through the
    fused step (kernel 1's plain version here), then grahmc_run(backend=
    "fused") from the tuned state (kernel 2's plain version at 256 chains)."""
    from mcmc_tpu_torch.targets import neals_funnel
    t = neals_funnel(10)
    init = torch.randn((256, 10), generator=torch.Generator().manual_seed(11)) * 0.5
    state = init_chain_state(init, t.log_prob_fn, t.value_and_grad_fn)
    fused = ft.make_fused_grahmc_step(t.value_and_grad_fn, 16, tg.constant_schedule)
    stream = ft.PhiloxStream.from_generator(torch.Generator().manual_seed(12), "cpu")
    da = t_da.da_init(0.1, device="cpu")
    ones = torch.ones(10)
    for _ in range(30):
        eps = t_da.da_step_size(da)
        accs = []
        for _ in range(10):
            state, (acc, *_rest) = fused(stream, state, eps, 1.0, 1.0, ones)
            accs.append(acc)
        da = t_da.da_update(da, torch.stack(accs).float().mean(), 0.65)
    step = float(t_da.da_final_step_size(da))
    assert 0.01 < step < 1.0

    res = tg.grahmc_run(torch.Generator().manual_seed(13), t.log_prob_fn,
                        state.position, step_size=step, num_steps=16, gamma=1.0,
                        steepness=1.0, num_samples=96, burn_in=0,
                        friction_schedule=tg.constant_schedule,
                        value_and_grad_fn=t.value_and_grad_fn,
                        collect_chains=64, backend="fused")
    assert res.samples.shape == (96, 64, 10)
    assert res.log_probs.shape == (96, 64)
    assert res.accept_rate.shape == (256,)
    assert res.final_state.position.shape == (256, 10)
    assert bool(torch.isfinite(res.samples).all())
    assert abs(float(res.accept_rate.mean()) - 0.65) < 0.1


def test_entry_points_default_to_the_card():
    """dual averaging's state and interop's state builders run on the card
    unless the caller names another device (the CPU tests pass "cpu")."""
    import inspect
    from mcmc_tpu_torch.samplers import gaussian_base, geometric_ladder
    from mcmc_tpu_torch.tuning.welford import welford_init
    for fn in (t_da.da_init, interop.chain_state_from_numpy, geometric_ladder, gaussian_base,
               interop.da_state_from_numpy, interop.nuts_state_from_numpy,
               interop.welford_state_from_numpy, interop.dense_moment_state_from_numpy,
               interop.metric_from_numpy, welford_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    from mcmc_tpu_torch.tuning import core
    assert core.build_parser().parse_args(["--sampler", "rwmh"]).device == "cuda"


def test_the_card_side_modules_never_import_matplotlib():
    """The card's host has no matplotlib: the CLI, compat, the profiler and
    chip_smoke import it nowhere (tuning.plots only under --plot)."""
    code = (
        "import sys\n"
        "import mcmc_tpu_torch.tuning, mcmc_tpu_torch.tuning.core, mcmc_tpu_torch.compat\n"
        "import mcmc_tpu_torch.utils.profiling, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'matplotlib' or m.startswith('matplotlib.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_top_level_exports_equal_the_jax_packages():
    import mcmc_tpu
    import mcmc_tpu_torch
    assert sorted(mcmc_tpu_torch.__all__) == sorted(mcmc_tpu.__all__)
    from mcmc_tpu_torch import targets
    assert mcmc_tpu_torch.get_reference_sampler is targets.get_reference_sampler
    assert mcmc_tpu_torch.has_reference_sampler is targets.has_reference_sampler


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import mcmc_tpu_torch, mcmc_tpu_torch.interop, mcmc_tpu_torch.samplers\n"
        "import mcmc_tpu_torch.ops.fused_trajectory, mcmc_tpu_torch.ops._cuda\n"
        "import mcmc_tpu_torch.ops.fused_rwmh, mcmc_tpu_torch.ops.fused_nuts\n"
        "import mcmc_tpu_torch.ops.padded_targets, mcmc_tpu_torch.targets\n"
        "import mcmc_tpu_torch.samplers.rwmh, mcmc_tpu_torch.samplers.nuts_persistent\n"
        "import mcmc_tpu_torch.samplers.trajectory\n"
        "import mcmc_tpu_torch.diagnostics, mcmc_tpu_torch.tuning, chip_smoke\n"
        "import mcmc_tpu_torch.tuning.welford, mcmc_tpu_torch.tuning.adaptation\n"
        "import mcmc_tpu_torch.tuning.sequential, mcmc_tpu_torch.tuning.ladder\n"
        "import mcmc_tpu_torch.samplers.tempered, mcmc_tpu_torch.samplers.smc\n"
        "import mcmc_tpu_torch.targets.hierarchical\n"
        "import mcmc_tpu_torch.compat, mcmc_tpu_torch.utils.profiling\n"
        "import mcmc_tpu_torch.tuning.core, mcmc_tpu_torch.tuning.plots\n"
        "import mcmc_tpu_torch.animations\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'mcmc_tpu')\n"
        "             or m.startswith(('jax.', 'mcmc_tpu.')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
