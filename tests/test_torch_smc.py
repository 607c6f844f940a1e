"""Port parity for annealed SMC: kernel 1c's plain version against the JAX
package's bridged Pallas kernel (interpret mode, injected draws), the
pieces (gaussian_base, systematic_resample fed the JAX uniform, the weight
reductions, weighted_moments) against the JAX package's, and smc_run
(eager and fused moves) against the JAX package's log-Z gates, mixture
transport, schedule and info contracts.

The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrappers take their plain versions because the
tensors lie on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax import random  # noqa: E402

from mcmc_tpu.ops import fused_trajectory as jft  # noqa: E402
from mcmc_tpu.samplers import smc as jsmc  # noqa: E402
from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu_torch.ops import fused_trajectory as ft  # noqa: E402
from mcmc_tpu_torch.samplers import grahmc as tg  # noqa: E402
from mcmc_tpu_torch.samplers import smc as ts  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_get_target  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _smc(target, generator_seed=0, **kw):
    return ts.smc_run(torch.Generator().manual_seed(generator_seed), target.log_prob_fn,
                      value_and_grad_fn=target.value_and_grad_fn, dtype=torch.float64, **kw)


# (family, dim, friction schedule, dense metric, beta): the 6-D mixture
# under both metrics (ids "beta-dense"), and kernel 1c's lane-group families
# (csrc/trajectory.cuh:GROUPED_FAMILY) at D 10 and 33 without friction and
# under tanh
GROUPED = ("standard_normal", "neals_funnel", "gaussian_mixture", "correlated_gaussian")
BRIDGE_CASES = (
    [pytest.param("gaussian_mixture", 6, None, dense, beta, id=f"{beta}-{dense}")
     for beta in (0.05, 0.5, 1.0, 0.0) for dense in (False, True)]
    + [pytest.param(f, d, sched, False, beta, id=f"{f}-D{d}-{sched or 'no_friction'}-{beta}")
       for f in GROUPED for d in (10, 33) for sched in (None, "tanh")
       for beta in (0.0, 0.05, 0.5, 1.0)])


@pytest.mark.parametrize("family, dim, schedule, dense, beta", BRIDGE_CASES)
def test_bridged_plain_matches_jax_bridge_kernel(family, dim, schedule, dense, beta):
    """Kernel 1c's plain version == the JAX package's bridged kernel
    (make_debug_trajectory(bridge=...), interpret mode) on the target's
    bridge to N(0.5, 2^2 I), 16 chains, L = 8, injected draws: accepts
    equal, q, lp and grad within 2e-4, delta H within 2e-3
    (tests/test_pallas_ops.py:146-190)."""
    from mcmc_tpu.samplers import grahmc as jg
    n, L = 16, 8
    eps = 0.1 if family == "neals_funnel" else 0.3
    gamma, steep = (0.5, 5.0) if schedule else (0.0, 1.0)
    rng = np.random.default_rng(7 + dim)
    q = (rng.standard_normal((n, dim)) * (0.8 if family == "neals_funnel" else 1.5)).astype(
        np.float32)
    p0 = rng.standard_normal((n, dim)).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    a = rng.standard_normal((dim, dim))
    invm = ((a @ a.T / dim + 0.5 * np.eye(dim)) if dense else np.ones(dim)).astype(np.float32)
    jt = j_get_target(family, dim=dim)
    _, _, base_vag = jsmc.gaussian_base(dim, 0.5, 2.0)
    lt, gt = jt.value_and_grad_fn(jnp.asarray(q))
    lb, gb = base_vag(jnp.asarray(q))
    lp = np.asarray(beta * lt.astype(jnp.float32) + (1 - beta) * lb, np.float32)
    grad = np.asarray(beta * gt.astype(jnp.float32) + (1 - beta) * gb, np.float32)
    run_j = jft.make_debug_trajectory(jt.value_and_grad_fn, L,
                                      getattr(jg, f"{schedule}_schedule", None), n, dim)
    outs_j = run_j(*(jnp.asarray(x) for x in (q, lp, grad, p0, u)), eps, gamma, steep,
                   jnp.asarray(invm), bridge=(beta, 0.5, 2.0))
    tt = t_get_target(family, dim=dim)
    run_t = ft.make_debug_trajectory(tt.value_and_grad_fn, L,
                                     getattr(tg, f"{schedule}_schedule", None), n, dim)
    outs_t = run_t(*(_t(x) for x in (q, lp, grad, p0, u)), eps, gamma, steep, _t(invm),
                   bridge=(beta, 0.5, 2.0))
    np.testing.assert_array_equal(outs_t[3].numpy(), np.asarray(outs_j[3]))
    for ours, theirs in zip(outs_t[:3], outs_j[:3]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs_t[4].numpy(), np.asarray(outs_j[4]), rtol=2e-3, atol=2e-3)


def test_bridge_base_and_scalars():
    """The base's rows and log-normalizer (double, rounded once); a
    non-positive scale raises."""
    base = ft.bridge_base([0.0, 1.0, 2.0], torch.tensor([1.0, 2.0, 4.0]), 3, "cpu")
    assert base.mean.dtype == torch.float32 and base.inv_scale.dtype == torch.float32
    np.testing.assert_array_equal(base.inv_scale.numpy(), [1.0, 0.5, 0.25])
    assert base.log_norm == pytest.approx(-np.log(8.0) - 1.5 * np.log(2 * np.pi), abs=1e-14)
    s = ft.bridge_scalars(torch.tensor(0.4), 0.1, 5.0, torch.tensor(0.25), base.log_norm, "cpu")
    np.testing.assert_array_equal(s.numpy(), np.float32([0.4, 0.1, 5.0, 0.25, base.log_norm]))
    with pytest.raises(ValueError, match="strictly positive"):
        ft.bridge_base(None, [1.0, 0.0, 1.0], 3, "cpu")


def test_gaussian_base_matches_jax():
    """Log-prob and gradient of the base equal the JAX package's on the same
    float64 inputs; the sampler's moments; a non-positive scale raises."""
    sampler, lp, vag = ts.gaussian_base(3, mean=1.5, scale=2.0, device="cpu")
    _, jlp, jvag = jsmc.gaussian_base(3, mean=1.5, scale=2.0)
    x = np.random.default_rng(0).standard_normal((16, 3)) * 3.0
    v, g = vag(_t(x))
    jv, jg = jvag(jnp.asarray(x))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12)
    np.testing.assert_allclose(lp(_t(x)).numpy(), np.asarray(jlp(jnp.asarray(x))), rtol=1e-12)
    draws = sampler(torch.Generator().manual_seed(0), 40000)
    assert draws.dtype == torch.float32
    np.testing.assert_allclose(draws.mean(0).numpy(), 1.5, atol=0.05)
    np.testing.assert_allclose(draws.std(0).numpy(), 2.0, rtol=0.02)
    with pytest.raises(ValueError, match="strictly positive"):
        ts.gaussian_base(2, scale=[1.0, -1.0], device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_matches_jax_on_its_uniform(seed, dtype):
    """Fed the JAX package's own uniform (random.uniform of the same key,
    in the weights' dtype), systematic_resample gives the same indices."""
    rng = np.random.default_rng(seed)
    lw = (rng.standard_normal(257) * 2.0).astype(dtype)
    lw[::7] = -1e30
    key = random.PRNGKey(seed)
    idx_j = np.asarray(jsmc.systematic_resample(key, jnp.asarray(lw)))
    u = np.asarray(random.uniform(key, (), dtype=jnp.asarray(lw).dtype))
    idx_t = ts.systematic_resample(None, _t(lw), u=_t(u))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)


def test_systematic_resample_copy_counts_and_degenerate_weight():
    """Particle i appears floor(P w_i) or ceil(P w_i) times; all mass on one
    particle gives only that index (tests/test_smc.py)."""
    w = torch.tensor([0.5, 0.25, 0.125, 0.125], dtype=torch.float64)
    for seed in range(5):
        idx = ts.systematic_resample(torch.Generator().manual_seed(seed), torch.log(w))
        counts = np.bincount(idx.numpy(), minlength=4)
        expected = w.numpy() * 4
        assert np.all(counts >= np.floor(expected)) and np.all(counts <= np.ceil(expected))
    lw = torch.tensor([-1e30, 0.0, -1e30, -1e30], dtype=torch.float64)
    assert bool((ts.systematic_resample(torch.Generator(), lw) == 1).all())


def test_weight_reductions_and_weighted_moments_match_jax():
    rng = np.random.default_rng(3)
    lw = rng.standard_normal(500) * 3.0
    lw = lw - np.logaddexp.reduce(lw)
    x = rng.standard_normal((500, 4))
    np.testing.assert_allclose(float(ts._lse(_t(lw))), float(jsmc._lse(jnp.asarray(lw))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(ts._rel_ess(_t(lw))),
                               float(jsmc._rel_ess(jnp.asarray(lw))), rtol=1e-12)
    mean, cov = ts.weighted_moments(_t(x), _t(lw))
    jmean, jcov = jsmc.weighted_moments(jnp.asarray(x), jnp.asarray(lw))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-12, atol=1e-14)


def test_schedule_validation_and_refusals():
    """Bad schedules and arguments raise with the JAX package's messages;
    tune_trajectory refuses the fused (fixed-length) move backend."""
    t = t_get_target("standard_normal", dim=2)
    kw = dict(n_particles=64, dim=2, step_size=0.5, num_steps=4)
    for betas, match in (([0.3, 0.9], r"betas\[-1\] must be 1"),
                         ([0.5, 0.4, 1.0], "ascending"), (np.ones((2, 2)), "1-D")):
        with pytest.raises(ValueError, match=match):
            _smc(t, betas=torch.tensor(betas), **kw)
    with pytest.raises(ValueError, match="target_rel_ess"):
        _smc(t, target_rel_ess=1.5, **kw)
    with pytest.raises(ValueError, match="base_scale"):
        _smc(t, base_scale=-1.0, **kw)
    with pytest.raises(ValueError, match="n_particles"):
        _smc(t, **dict(kw, n_particles=1))
    with pytest.raises(ValueError, match="tune_trajectory"):
        _smc(t, tune_trajectory=True, move_backend="fused", **kw)


def test_resolve_move_backend():
    """"auto" is fused only for CUDA particles, a tagged target, fixed-length
    moves and a diagonal metric; "fused" refuses the rest loudly."""
    t = t_get_target("standard_normal", dim=3)
    vag = t.value_and_grad_fn
    assert ts.resolve_move_backend("auto", vag, False, None, "cpu") == "eager"
    assert ts.resolve_move_backend("auto", vag, False, None, "cuda") == "fused"
    assert ts.resolve_move_backend("auto", vag, False, torch.eye(3), "cuda") == "eager"
    assert ts.resolve_move_backend("auto", vag, True, None, "cuda") == "eager"
    assert ts.resolve_move_backend("auto", lambda x: x, False, None, "cuda") == "eager"
    assert ts.resolve_move_backend("fused", vag, False, None, "cpu") == "fused"
    with pytest.raises(ValueError):
        ts.resolve_move_backend("fused", vag, True, None, "cpu")
    with pytest.raises(TypeError):
        ts.resolve_move_backend("fused", lambda x: x, False, None, "cpu")
    with pytest.raises(ValueError):
        ts.resolve_move_backend("pallas", vag, False, None, "cpu")


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_logz_normalized_target_and_moments(backend):
    """Adaptive SMC on the normalized 5-D standard normal from a wide base:
    log Z = 0 to Monte-Carlo error, the weighted moments are the target's,
    the weights stay normalized (tests/test_smc.py)."""
    t = t_get_target("standard_normal", dim=5)
    r = _smc(t, n_particles=2048, dim=5, step_size=0.5, num_steps=8, base_scale=3.0,
             move_backend=backend)
    assert r.info["n_stages"] >= 2
    assert r.log_Z.dtype == torch.float64
    assert abs(float(r.log_Z)) < 0.12
    mean, cov = ts.weighted_moments(r.particles, r.log_weights)
    assert float(mean.abs().max()) < 0.15
    np.testing.assert_allclose(torch.diagonal(cov).numpy(), 1.0, atol=0.15)
    assert abs(float(torch.exp(r.log_weights).sum()) - 1.0) < 1e-6


def test_logz_known_constant_and_analytic_evidence():
    """logp + c reports log Z = c; -|x|^2 / (2 s^2) has log Z = D/2 log(2 pi
    s^2), from a base narrower than the target (tests/test_smc.py)."""
    t = t_get_target("standard_normal", dim=4)

    def vag(x):
        lp, g = t.value_and_grad_fn(x)
        return lp + 3.7, g
    r = ts.smc_run(torch.Generator().manual_seed(1), lambda x: vag(x)[0], 2048, 4, 0.5, 8,
                   base_scale=2.0, value_and_grad_fn=vag, dtype=torch.float64)
    assert abs(float(r.log_Z) - 3.7) < 0.05
    d, s = 4, 2.0

    def vag2(x):
        return -0.5 * torch.sum(x * x, dim=-1) / s ** 2, -x / s ** 2
    r = ts.smc_run(torch.Generator().manual_seed(2), lambda x: vag2(x)[0], 2048, d, 0.4, 8,
                   value_and_grad_fn=vag2, dtype=torch.float64)
    assert abs(float(r.log_Z) - 0.5 * d * np.log(2 * np.pi * s ** 2)) < 0.08


def test_fixed_schedule_stage_count_and_info_schema():
    """A fixed ascending schedule runs exactly len(betas) stages and records
    them; the info keys are the JAX package's, the resample count matches
    the flags, the first stage's step is the initial one, the trajectory
    length is T0 = step num_steps, and the moves' friction (GRAHMC) keeps
    the estimator (tests/test_smc.py)."""
    t = t_get_target("standard_normal", dim=3)
    betas = torch.linspace(0.2, 1.0, 5)
    for backend in ("eager", "fused"):
        r = _smc(t, n_particles=1024, dim=3, step_size=0.5, num_steps=8, betas=betas,
                 base_scale=2.0, move_backend=backend, gamma=0.5, steepness=5.0,
                 friction_schedule=tg.tanh_schedule)
        assert r.info["n_stages"] == 5
        np.testing.assert_allclose(r.info["betas"][:5].numpy(), betas.numpy(), rtol=1e-6)
        assert abs(float(r.log_Z)) < 0.15
        assert set(r.info) == {"n_stages", "n_resamples", "n_divergences", "ess",
                               "final_step_size", "n_leapfrogs", "final_trajectory_length",
                               "betas", "rel_ess", "accept", "resampled", "step_size",
                               "trajectory_length"}
        assert r.info["n_resamples"] == int(r.info["resampled"][:5].sum())
        assert float(r.info["step_size"][0]) == np.float32(0.5)
        assert r.info["n_leapfrogs"] == 5 * 3 * 8
        np.testing.assert_allclose(r.info["trajectory_length"][:5].numpy(), 4.0, rtol=1e-6)
        acc = r.info["accept"][:5].numpy()
        assert np.all((acc > 0.2) & (acc <= 1.0))
        assert r.info["betas"].shape == (200,)


def test_mixture_transport_and_evidence_fused():
    """The flagship use through kernel 1c's plain version: SMC finds both
    modes of the 10-D mixture from a wide base, splits the mass evenly,
    recovers Var x0 = 7.25, and the evidence reads 0 (tests/test_smc.py)."""
    mt = t_get_target("gaussian_mixture", dim=10)
    r = _smc(mt, n_particles=4096, dim=10, step_size=0.4, num_steps=16, base_scale=6.0,
             final_resample=True, move_backend="fused", generator_seed=4)
    assert abs(float(r.log_Z)) < 0.15
    x0 = r.particles[:, 0]
    assert 0.35 < float((x0 > 0).double().mean()) < 0.65
    assert abs(float(x0.var()) - 7.25) < 0.8
    np.testing.assert_allclose(r.log_weights.numpy(), -np.log(4096), rtol=1e-6)


def test_prefix_sum_is_the_cumsum_in_a_fixed_order():
    """smc.prefix_sum equals torch.cumsum to rounding at every length
    (powers of two and not), and systematic resampling through it still
    copies particle i floor(P w_i) or ceil(P w_i) times at 32,768 particles;
    two smc_run calls with one seed give the same log Z and particles."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 8, 257, 4096, 32769):
        x = torch.from_numpy(rng.uniform(size=n))
        torch.testing.assert_close(ts.prefix_sum(x), torch.cumsum(x, 0), rtol=1e-12, atol=1e-12)
    lw = torch.from_numpy(rng.standard_normal(32768) * 3.0)
    idx = ts.systematic_resample(torch.Generator().manual_seed(0), lw)
    w = torch.softmax(lw, 0) * 32768
    counts = torch.bincount(idx, minlength=32768).double()
    assert bool(((counts >= torch.floor(w) - 1e-9) & (counts <= torch.ceil(w) + 1e-9)).all())
    t = t_get_target("gaussian_mixture", dim=3)
    runs = [ts.smc_run(torch.Generator().manual_seed(6), t.log_prob_fn, 512, 3, 0.4, 4,
                       move_steps=1, base_scale=3.0, value_and_grad_fn=t.value_and_grad_fn,
                       final_resample=True) for _ in range(2)]
    assert torch.equal(runs[0].log_Z, runs[1].log_Z)
    assert torch.equal(runs[0].particles, runs[1].particles)


def test_chees_tuned_moves_match_jax_statistically():
    """tune_trajectory=True against the JAX package on its own test's
    problem (tests/test_smc.py:253): N(0, 4 I) in 4-D from N(0, 2^2 I), 25
    fixed stages of 4 moves, T0 = 2 x 0.3, at most 32 leapfrogs. T climbs
    toward the sigma = 2 quarter period (~3.1); the port's final T and
    realized leapfrog count land within the JAX runs' range over three keys
    widened by the larger of 25% of their mean and three of their standard
    deviations; the evidence stays exact (|log Z| < 0.15) and one seed
    repeats bit for bit."""
    dim = 4

    def lp_j(x):
        return -0.125 * jnp.sum(x * x, axis=-1) - 0.5 * dim * jnp.log(2 * jnp.pi * 4.0)

    def vag(x):
        return (-0.125 * torch.sum(x * x, dim=-1) - 0.5 * dim * np.log(2 * np.pi * 4.0),
                -0.25 * x)
    betas = np.linspace(0.05, 1.0, 25)
    kw = dict(n_particles=2048, dim=dim, step_size=0.3, num_steps=2, move_steps=4,
              tune_trajectory=True, max_leapfrogs=32, base_scale=2.0)
    jax_runs = []
    for seed in range(3):
        r = jsmc.smc_run(random.PRNGKey(seed), lp_j, betas=jnp.asarray(betas), **kw)
        jax_runs.append((float(r.info["final_trajectory_length"]),
                         int(r.info["n_leapfrogs"])))
        assert abs(float(r.log_Z)) < 0.15
    runs = [ts.smc_run(torch.Generator().manual_seed(seed), lambda x: vag(x)[0],
                       betas=torch.tensor(betas), value_and_grad_fn=vag, dtype=torch.float64,
                       **kw) for seed in (0, 0, 1)]
    assert float(runs[0].log_Z) == float(runs[1].log_Z)
    assert runs[0].info["n_leapfrogs"] == runs[1].info["n_leapfrogs"]
    for r in runs[1:]:
        assert r.info["n_stages"] == 25 and abs(float(r.log_Z)) < 0.15
        np.testing.assert_allclose(float(r.info["trajectory_length"][0]), 0.6, rtol=1e-6)
        assert 0 < r.info["n_leapfrogs"] < 25 * 4 * 32
        for value, column in ((float(r.info["final_trajectory_length"]), 0),
                              (r.info["n_leapfrogs"], 1)):
            ref = np.asarray([run[column] for run in jax_runs], np.float64)
            pad = max(0.25 * ref.mean(), 3.0 * ref.std())
            assert ref.min() - pad < value < ref.max() + pad, (value, jax_runs)
