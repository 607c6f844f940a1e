"""Port parity for the NUTS warmups and the per-sampler tuners
(`tuning/adaptation.py`'s classic and persistent NUTS branches,
`tuning/dual_averaging.py`'s convergence-driven tuners and joint GRAHMC
tune) and for `targets/rosenbrock_reference.py`: the persistent warmup's
accept statistic, the tuners' loop and the joint DA update exactly against
the JAX package (float64, deterministic stubs), the warmups and tuners
statistically against the JAX package on `standard_normal` (the tuned step
within a stated band of the JAX package's over three keys), and the
reference cache's generate/load round trip."""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import jax.random as random  # noqa: E402

from mcmc_tpu.targets import get_target as j_get_target  # noqa: E402
from mcmc_tpu.tuning import adaptation as ja  # noqa: E402
from mcmc_tpu.tuning import dual_averaging as jda  # noqa: E402
from mcmc_tpu_torch.targets import get_reference_sampler, get_target  # noqa: E402
from mcmc_tpu_torch.targets import rosenbrock_reference as rr  # noqa: E402
from mcmc_tpu_torch.tuning import adaptation as ta  # noqa: E402
from mcmc_tpu_torch.tuning import dual_averaging as tda  # noqa: E402

SHORT = dict(exploration_steps=60, adaptation_windows=[30, 60], cooldown_steps=30)
DIM, N = 4, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _init(seed=0):
    return np.random.default_rng(seed).standard_normal((N, DIM)) * 0.5


def test_persistent_accept_stat_matches_jax():
    rng = np.random.default_rng(0)
    d_alpha = rng.uniform(0, 3, 50)
    d_trans = rng.integers(0, 4, 50).astype(np.float64)
    ours = ta._persistent_accept_stat(_t(d_alpha), _t(d_trans))
    theirs = ja._persistent_accept_stat(jnp.asarray(d_alpha), jnp.asarray(d_trans))
    assert float(ours) == pytest.approx(float(theirs), rel=1e-15)
    none = ta._persistent_accept_stat(_t(d_alpha), torch.zeros(50, dtype=torch.float64))
    assert float(none) == 0.65


def test_tune_with_da_matches_jax_on_a_stub():
    """The convergence-driven loop on a deterministic accept curve (accept
    = 1 / (1 + 4 step)): the same smoothed-step history, accept history and
    converged iteration as the JAX loop, float64 to 1e-12."""
    x = _init()

    def j_batch(key, pos, step):
        return 1.0 / (1.0 + 4.0 * step), pos

    def t_batch(pos, step):
        return 1.0 / (1.0 + 4.0 * step), pos
    kw = dict(tolerance=0.01, max_iter=300, min_iter=30, patience=5)
    step_j, hist_j = jda._tune_with_da(j_batch, 0.3, 0.65, jnp.asarray(x), random.PRNGKey(0),
                                       **kw)
    step_t, hist_t = tda._tune_with_da(t_batch, 0.3, 0.65, _t(x), **kw)
    assert hist_t["converged_iter"] == hist_j["converged_iter"] < 300
    np.testing.assert_allclose(hist_t["step_size_history"], hist_j["step_size_history"],
                               rtol=1e-12)
    np.testing.assert_allclose(hist_t["accept_history"], hist_j["accept_history"], rtol=1e-12)
    assert step_t == pytest.approx(step_j, rel=1e-12)


def test_joint_da_update_matches_jax():
    """The joint [log step, log gamma] DA over a fixed accept sequence,
    gamma's clip included: float64 to 1e-12."""
    accepts = np.random.default_rng(1).uniform(0.0, 1.0, 40)
    sj = jda.joint_da_init(jnp.array([0.2, 1.0]))
    st = tda.joint_da_init(torch.tensor([0.2, 1.0], dtype=torch.float64))
    for a in accepts:
        sj = jda.joint_da_update(sj, a, 0.65)
        st = tda.joint_da_update(st, float(a), 0.65)
        for ours, theirs in zip(st, sj):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12,
                                       atol=1e-12)
    assert float(st.log_params[1]) <= math.log(tda.GAMMA_CLIP[1]) + 1e-12


def _band(theirs, ours, lo=0.75, hi=1.33):
    """The port's tuned step within [lo min, hi max] of the JAX package's
    over its keys (the tuned step's spread between keys is ~5-10% here)."""
    assert lo * min(theirs) <= ours <= hi * max(theirs), (ours, theirs)


@pytest.mark.parametrize("sampler", ["rwmh", "hmc", "nuts"])
def test_tuners_match_jax_statistically(sampler):
    """dual_averaging_tune_{rwmh, hmc, nuts} on the 4-D standard normal,
    32 chains, 20 transitions a DA iteration: the port's tuned step within
    the band of the JAX package's over three keys; both converge."""
    x = _init(1)
    jt, tt = j_get_target("standard_normal", dim=DIM), get_target("standard_normal", dim=DIM)
    kw = dict(min_iter=30, max_iter=120, patience=5, n_samples_per_tune=20)
    j_fn = {"rwmh": jda.dual_averaging_tune_rwmh, "hmc": jda.dual_averaging_tune_hmc,
            "nuts": jda.dual_averaging_tune_nuts}[sampler]
    t_fn = {"rwmh": tda.dual_averaging_tune_rwmh, "hmc": tda.dual_averaging_tune_hmc,
            "nuts": tda.dual_averaging_tune_nuts}[sampler]
    extra = {} if sampler == "rwmh" else dict(value_and_grad_fn=jt.value_and_grad_fn)
    if sampler == "hmc":
        kw["num_steps"] = 8
    theirs = [j_fn(random.PRNGKey(k), jt.log_prob_fn, jnp.asarray(x), **kw, **extra)[0]
              for k in range(3)]
    extra = {} if sampler == "rwmh" else dict(value_and_grad_fn=tt.value_and_grad_fn)
    ours, hist = t_fn(torch.Generator().manual_seed(0), tt.log_prob_fn, _t(x), **kw, **extra)
    _band(theirs, ours)
    assert hist["converged_iter"] <= 120 and len(hist["accept_history"]) % 25 == 0


def test_rwmh_tuner_runs_kernel_3_plain_version_when_asked():
    """backend="fused" on CPU positions runs kernel 3's plain version
    (T = 20 divides the 20 transitions: T = 4, five calls a DA iteration);
    "auto" stays eager on the CPU; both tune to the same band."""
    x = _t(_init(2)).float()
    tt = get_target("standard_normal", dim=DIM)
    kw = dict(min_iter=30, max_iter=100, patience=5, n_samples_per_tune=20,
              value_and_grad_fn=tt.value_and_grad_fn)
    fused, _ = tda.dual_averaging_tune_rwmh(torch.Generator().manual_seed(0), tt.log_prob_fn,
                                            x, backend="fused", **kw)
    eager, _ = tda.dual_averaging_tune_rwmh(torch.Generator().manual_seed(0), tt.log_prob_fn,
                                            x, **kw)
    assert 0.7 < fused / eager < 1.4
    with pytest.raises(TypeError):
        tda.dual_averaging_tune_rwmh(torch.Generator(), tt.log_prob_fn, x, backend="fused")


def test_joint_tune_grahmc_runs_and_matches_jax_band():
    """The deprecated joint tune: history of max_iter iterations, gamma in
    its clip, and the step within a wide band of the JAX tune's (one
    scalar error drives two parameters, so both drift)."""
    x = _init(3)
    jt, tt = j_get_target("standard_normal", dim=DIM), get_target("standard_normal", dim=DIM)
    kw = dict(num_steps=8, max_iter=40, n_samples_per_tune=10, schedule_type="tanh")
    sj, gj, _, _ = jda.joint_tune_grahmc(random.PRNGKey(0), jt.log_prob_fn, None,
                                         jnp.asarray(x), value_and_grad_fn=jt.value_and_grad_fn,
                                         **kw)
    st, gt, steep, hist = tda.joint_tune_grahmc(torch.Generator().manual_seed(0),
                                                tt.log_prob_fn, None, _t(x),
                                                value_and_grad_fn=tt.value_and_grad_fn, **kw)
    assert len(hist["step_size"]) == len(hist["accept_rate"]) == 40 and steep == 10.0
    assert tda.GAMMA_CLIP[0] - 1e-9 <= gt <= tda.GAMMA_CLIP[1] + 1e-9
    assert 0.5 * sj < st < 2.0 * sj, (st, sj, gt, gj)


@pytest.mark.parametrize("backend", ["classic", "persistent"])
def test_nuts_warmup_matches_jax_statistically(backend):
    """run_adaptive_warmup("nuts") on the 4-D standard normal, 32 chains,
    a 180-step schedule: classic NUTS, and the persistent machine (the
    eager window machine, 16 slots a step; "persistent" on the JAX side is
    its XLA machine): the tuned step within the band of the JAX package's
    over three keys, the learned diagonal metric within 0.5 of 1."""
    x = _init(4)
    jt, tt = j_get_target("standard_normal", dim=DIM), get_target("standard_normal", dim=DIM)
    kw = dict(update_freq=30, **SHORT)
    if backend == "persistent":
        kw["steps_per_warmup_step"] = 16
    jb = "persistent" if backend == "persistent" else "auto"
    theirs = [ja.run_adaptive_warmup("nuts", jt.log_prob_fn, None, jnp.asarray(x),
                                     random.PRNGKey(k), value_and_grad_fn=jt.value_and_grad_fn,
                                     backend=jb, **kw)[0] for k in range(3)]
    step, inv_mass, pos, info = ta.run_adaptive_warmup(
        "nuts", tt.log_prob_fn, None, _t(x), torch.Generator().manual_seed(0),
        value_and_grad_fn=tt.value_and_grad_fn, backend=jb, **kw)
    _band(theirs, step)
    assert pos.shape == (N, DIM) and pos.dtype == torch.float64
    assert float((inv_mass - 1.0).abs().max()) < 0.5
    assert len(info["accept_trace"]) == 2 + 1 + 2 + 1


def test_persistent_warmup_fused_path_runs_kernel_4_plain_version():
    """fused_warmup=True on CPU positions: each warmup step is one call of
    kernel 4's wrapper (its plain version here) of 16 slots at W = 4 on the
    float32 machine state; the dense metric picks the dense variant; the
    result lands in the band of the eager machine's."""
    from mcmc_tpu_torch.ops import fused_nuts
    x = _t(_init(5)).float()
    tt = get_target("standard_normal", dim=DIM)
    calls = []
    real = fused_nuts.nuts_window_kernel

    def counting(info, n_iters, steps_per_iter, *a, **k):
        calls.append((n_iters, steps_per_iter, a[3].ndim))
        return real(info, n_iters, steps_per_iter, *a, **k)
    fused_nuts.nuts_window_kernel = counting
    try:
        kw = dict(update_freq=30, steps_per_warmup_step=16, backend="persistent",
                  value_and_grad_fn=tt.value_and_grad_fn, **SHORT)
        step_f, invm_f, pos_f, _ = ta.run_adaptive_warmup(
            "nuts", tt.log_prob_fn, None, x, torch.Generator().manual_seed(1),
            fused_warmup=True, learn_mass_matrix="dense", **kw)
    finally:
        fused_nuts.nuts_window_kernel = real
    assert len(calls) == 60 + 30 + 60 + 30 and set(calls) == {(4, 4, 2)}
    assert invm_f.shape == (DIM, DIM) and pos_f.dtype == torch.float32
    step_e = ta.run_adaptive_warmup("nuts", tt.log_prob_fn, None, x,
                                    torch.Generator().manual_seed(1), **kw)[0]
    assert 0.75 < step_f / step_e < 1.33


def test_nuts_warmup_backends_and_refusals():
    tt = get_target("standard_normal", dim=DIM)
    x = _t(_init(6))
    for bad in ("fused", "pallas"):
        with pytest.raises(ValueError):
            ta.run_adaptive_warmup("nuts", tt.log_prob_fn, None, x, torch.Generator(),
                                   backend=bad)
    with pytest.raises(ValueError):
        ta.run_adaptive_warmup("hmc", tt.log_prob_fn, None, x, torch.Generator(),
                               backend="persistent")
    with pytest.raises(TypeError, match="ChainMesh"):     # mesh= runs, but takes only a ChainMesh
        ta.run_adaptive_warmup("nuts", tt.log_prob_fn, None, x, torch.Generator(),
                               mesh=object())


def test_rosenbrock_reference_generate_and_load(tmp_path, monkeypatch):
    """generate_rosenbrock_reference runs the classic warmup and nuts_run
    (a small cut) and caches float32 draws; load_rosenbrock_reference and
    get_reference_sampler read them back (draws without replacement);
    without a cache both give None; the JAX package's shipped 20-D file
    reads through `path` as data."""
    monkeypatch.setattr(rr, "CACHE_DIR", str(tmp_path))
    assert rr.load_rosenbrock_reference(3) is None
    assert get_reference_sampler("rosenbrock", 3) is None
    flat = rr.generate_rosenbrock_reference(3, n_samples=200, n_chains=8, thin=2, seed=1,
                                            device="cpu", max_tree_depth=6, verbose=False,
                                            **SHORT)
    assert flat.shape == (200, 3) and flat.dtype == np.float32 and np.isfinite(flat).all()
    assert Path(rr.cache_path(3)).exists() and rr.cache_path(3).startswith(str(tmp_path))
    loaded = rr.load_rosenbrock_reference(3)
    np.testing.assert_array_equal(loaded.numpy(), flat)
    draws = get_reference_sampler("rosenbrock", 3)(torch.Generator().manual_seed(0), 150)
    assert draws.shape == (150, 3)
    every = get_reference_sampler("rosenbrock", 3)(torch.Generator().manual_seed(1), 500)
    assert sorted(every.tolist()) == sorted(loaded.tolist())     # each cached row once
    assert 0.5 < float(loaded[:, 0].mean()) < 1.5                # about the mode's x0 = 1
    shipped = Path(__file__).parents[1] / "mcmc_tpu" / "targets" / "reference_samples"
    ref20 = rr.load_rosenbrock_reference(20, path=str(shipped / "rosenbrock_20d.npy"))
    assert ref20.shape == (50000, 20) and bool(torch.isfinite(ref20).all())
    with pytest.warns(UserWarning):
        assert rr.load_rosenbrock_reference(20) is None
