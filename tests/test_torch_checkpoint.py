"""Port of the chain-state / warmup / mid-sampling checkpoints
(mcmc_tpu_torch.utils.checkpoint) held against the JAX package's: the same
signatures and sidecars, round trips, the runner's draw-exact resume on the
CPU, and the state/meta pair written atomically (the JAX package's fault at
utils/checkpoint.py:226, recorded here as an expected difference)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mcmc_tpu.utils import checkpoint as J  # noqa: E402
from mcmc_tpu_torch.utils import checkpoint as T  # noqa: E402


def test_state_tree_roundtrip_chainstate(tmp_path):
    from mcmc_tpu_torch.samplers.base import init_chain_state
    from mcmc_tpu_torch.targets import standard_normal

    t = standard_normal(5)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 5)))
    state = init_chain_state(x, t.log_prob_fn, t.value_and_grad_fn)
    path = str(tmp_path / "cs")
    T.save_state_tree(path, state, meta={"draws": 42})
    restored, meta = T.load_state_tree(path, like=state)
    assert meta == {"draws": 42}
    assert type(restored) is type(state)
    for a, b in zip(state, restored):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_state_tree_keys_match_jax(tmp_path):
    """The same nested tree gives the same npz keys in both packages."""
    import jax
    tree = {"a": np.arange(3.0), "b": {"c": np.ones(2), "d": [np.zeros(1), np.ones(1)]}}
    J.save_state_tree(str(tmp_path / "j"), jax.tree_util.tree_map(jnp.asarray, tree))
    T.save_state_tree(str(tmp_path / "t"), tree)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])


def test_state_tree_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "t")
    T.save_state_tree(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="missing leaves"):
        T.load_state_tree(path, like={"a": torch.ones(3), "b": torch.ones(2)})


def test_load_state_tree_casts_to_like_dtype(tmp_path):
    T.save_state_tree(str(tmp_path / "st"), {"x": np.arange(3, dtype=np.float64)})
    tree, _ = T.load_state_tree(str(tmp_path / "st"), like={"x": torch.zeros(3,
                                                                              dtype=torch.bfloat16)})
    assert tree["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("args", [
    ("grahmc", "neals_funnel", "tanh", 16, True, 32, 10, 0, ""),
    ("rwmh", "standard_normal", None, 20, False, 4, 5, 2500, ""),
    ("nuts", "student_t", None, 20, "dense", 1024, 10, 2500, "persistent-multinomial"),
    ("hmc", "log_gamma_unconstrained", None, 0, True, 8, 3, 200, "chees"),
])
def test_warmup_signature_matches_jax(args):
    *pos, num_warmup, backend = args
    assert (T.warmup_signature(*pos, num_warmup=num_warmup, backend=backend)
            == J.warmup_signature(*pos, num_warmup=num_warmup, backend=backend))


@pytest.mark.parametrize("info", [
    {"gamma": 0.5, "steepness": 2.0, "accept_trace": [0.6]},
    {"scale": 0.75},
    {"trajectory_length": 3.2, "num_steps": 7, "halton_offset": 8192,
     "max_steps_cap_hit": False, "gamma_tuner": "joint", "gamma": 0.3, "steepness": 1.0},
])
@pytest.mark.parametrize("with_mass", [True, False])
def test_save_warmup_matches_jax(tmp_path, info, with_mass):
    """The sidecar and the arrays the JAX package writes, and the round
    trip of load_warmup."""
    rng = np.random.default_rng(1)
    pos = rng.standard_normal((6, 4))
    inv_mass = np.linspace(0.5, 2.0, 4) if with_mass else None
    J.save_warmup(str(tmp_path / "j"), "sig", 0.123, None if inv_mass is None
                  else jnp.asarray(inv_mass), jnp.asarray(pos), info)
    T.save_warmup(str(tmp_path / "t"), "sig", 0.123, None if inv_mass is None
                  else torch.from_numpy(inv_mass), torch.from_numpy(pos), info)
    with open(tmp_path / "j" / "sig.json") as fj, open(tmp_path / "t" / "sig.json") as ft:
        assert fj.read() == ft.read()
    step, im, p, got = T.load_warmup(str(tmp_path / "t"), "sig", device="cpu")
    j_step, j_im, j_p, j_info = J.load_warmup(str(tmp_path / "j"), "sig")
    assert step == j_step == pytest.approx(0.123)
    assert got == j_info
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_p))
    assert (im is None) == (j_im is None)
    if im is not None:
        np.testing.assert_array_equal(im.numpy(), np.asarray(j_im))


def test_load_warmup_refuses_foreign_files(tmp_path):
    assert T.load_warmup(str(tmp_path), "nope", device="cpu") is None
    T.save_warmup(str(tmp_path), "sig", 0.75, None, torch.zeros((4, 5)), {"scale": 0.75})
    (tmp_path / "sig.json").write_text(json.dumps({"foreign": True}))
    assert T.load_warmup(str(tmp_path), "sig", device="cpu") is None
    T.save_state_tree(str(tmp_path / "sig2"), {"other": np.zeros(3)},
                      meta={"step_size": 0.1, "has_inv_mass": False})
    assert T.load_warmup(str(tmp_path), "sig2", device="cpu") is None


def _loop_state(k):
    g = torch.Generator().manual_seed(k)
    return dict(prev=100 * k, generator_state=g.get_state(),
                w2_generator_state=torch.Generator().manual_seed(50 + k).get_state(),
                position=torch.full((3, 2), float(k)), replica_pos=None, halton_cursor=k,
                chees_leapfrogs=7 * k, convergence_trace=[{"checkpoint": 100 * k}],
                piece_samples=[torch.full((2, 3, 2), float(i)) for i in range(k)],
                piece_stats=[{"draws": 2}] * k)


def test_sampling_checkpoint_roundtrip_and_config_stamp(tmp_path):
    ck = T.SamplingCheckpoint(str(tmp_path), "sig", {"num_samples": 400, "quantum": 50})
    assert ck.load(device="cpu") is None
    st = _loop_state(2)
    ck.save(**st)
    got = T.SamplingCheckpoint(str(tmp_path), "sig",
                               {"num_samples": 400, "quantum": 50}).load(device="cpu")
    assert got["prev"] == 200 and got["halton_cursor"] == 2 and got["chees_leapfrogs"] == 14
    assert torch.equal(got["generator_state"], st["generator_state"])
    assert torch.equal(got["w2_generator_state"], st["w2_generator_state"])
    assert torch.equal(got["position"], st["position"]) and got["replica_pos"] is None
    assert [int(p[0, 0, 0]) for p in got["piece_samples"]] == [0, 1]
    assert T.SamplingCheckpoint(str(tmp_path), "sig", {"num_samples": 500,
                                                       "quantum": 50}).load(device="cpu") is None
    ck.clear()
    assert not os.path.exists(ck.dir)


def test_state_and_meta_are_one_atomic_pair(tmp_path, monkeypatch):
    """A crash after the state file is written but before meta.json leaves
    the port's last checkpoint whole (its meta names its own state file).
    The JAX package rewrites state.npz in place first, so there the same
    crash pairs the new state with the old meta (the recorded difference,
    ROADMAP Queue 3 part 2)."""
    ck = T.SamplingCheckpoint(str(tmp_path / "t"), "sig", {"n": 1})
    ck.save(**_loop_state(1))

    def crash(path, obj):
        raise RuntimeError("crash before meta.json")
    monkeypatch.setattr(T, "_write_json", crash)
    with pytest.raises(RuntimeError):
        ck.save(**_loop_state(3))
    monkeypatch.undo()
    got = T.SamplingCheckpoint(str(tmp_path / "t"), "sig", {"n": 1}).load(device="cpu")
    assert got["prev"] == 100 and torch.equal(got["position"], torch.full((3, 2), 1.0))

    jck = J.SamplingCheckpoint(str(tmp_path / "j"), "sig", {"n": 1})

    def jax_state(k):
        return (100 * k, jnp.asarray([k, k], jnp.uint32), jnp.asarray([0, k], jnp.uint32),
                jnp.full((3, 2), float(k)), None, k, 7 * k, [{"checkpoint": 100 * k}],
                [jnp.full((2, 3, 2), float(i)) for i in range(k)], [{"draws": 2}] * k)
    jck.save(*jax_state(1))
    real_dump = json.dump

    def crash_meta(obj, f, *a, **kw):
        if "config" in obj:
            raise RuntimeError("crash before meta.json")
        return real_dump(obj, f, *a, **kw)
    monkeypatch.setattr(J.json, "dump", crash_meta)
    with pytest.raises(RuntimeError):
        jck.save(*jax_state(3))
    monkeypatch.undo()
    jgot = J.SamplingCheckpoint(str(tmp_path / "j"), "sig", {"n": 1}).load()
    assert jgot["prev"] == 100                       # the old meta ...
    assert float(jgot["position"][0, 0]) == 3.0      # ... with the new state


def test_mid_sampling_resume_is_draw_exact(tmp_path, monkeypatch):
    """A run preempted between convergence checkpoints resumes from the last
    one, does strictly less sampling, and repeats the uninterrupted run's
    results exactly (the run generator's state restored; CPU, eager)."""
    from mcmc_tpu_torch.benchmark import runner as R
    from mcmc_tpu_torch.targets import get_target

    t = get_target("standard_normal", dim=4)
    kw = dict(n_chains=4, num_warmup=100, num_samples=400, schedule_type="constant",
              num_steps=10, track_convergence=True, convergence_base=1.5, mesh_devices="off")

    def gen():
        return R.make_generator(0, "cpu")

    ra = R.run_single_benchmark_with_L("hmc", t, "standard_normal", gen(),
                                       warmup_cache_dir=str(tmp_path / "a"), **kw)
    assert ra.get("error") is None

    calls = {"n": 0}
    real_save = T.SamplingCheckpoint.save

    def killing_save(self, *args, **kwargs):
        if calls["n"] >= 2:
            raise RuntimeError("simulated preemption")
        calls["n"] += 1
        return real_save(self, *args, **kwargs)

    monkeypatch.setattr(T.SamplingCheckpoint, "save", killing_save)
    killed = R.run_single_benchmark_with_L("hmc", t, "standard_normal", gen(),
                                           warmup_cache_dir=str(tmp_path / "b"), **kw)
    assert "simulated preemption" in str(killed.get("error"))
    monkeypatch.setattr(T.SamplingCheckpoint, "save", real_save)
    assert len([d for d in os.listdir(tmp_path / "b") if d.endswith("_sampling")]) == 1

    chunks = {"n": 0}
    real_sample = R._sample

    def counting_sample(*args, **kwargs):
        chunks["n"] += 1
        return real_sample(*args, **kwargs)

    monkeypatch.setattr(R, "_sample", counting_sample)
    rb = R.run_single_benchmark_with_L("hmc", t, "standard_normal", gen(),
                                       warmup_cache_dir=str(tmp_path / "b"), **kw)
    assert rb.get("error") is None and rb["warmup_restored"] is True
    assert 0 < chunks["n"] < 400 // min(50, 400 // 4)
    for field in ("accept_rate", "rhat_max", "ess_bulk_min", "ess_tail_min", "z_score_max",
                  "total_divergences", "sliced_w2", "step_size"):
        assert rb[field] == ra[field], field
    assert rb["convergence_trace"] == ra["convergence_trace"]
    # the trace's checkpoints are the JAX runner's, quantized to 50 draws
    from mcmc_tpu.benchmark.runner import get_log_checkpoints
    trace = ra["convergence_trace"]
    assert [c["checkpoint"] for c in trace] == get_log_checkpoints(400, 1.5, 50)
    assert [c["n_gradients"] for c in trace] == [c["checkpoint"] * 10 * 4 for c in trace]
    assert not any(d.endswith("_sampling") for d in os.listdir(tmp_path / "b"))
