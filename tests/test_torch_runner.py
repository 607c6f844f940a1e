"""Port of the benchmark runner (mcmc_tpu_torch.benchmark.runner) and its
command line (run_benchmarks_torch.py) held against the JAX package's.

- The pure functions give the JAX runner's results exactly.
- The CSV and JSON written for the same rows are the JAX runner's, byte for
  byte (the port writes the CSV with the csv module, the JAX runner with
  pandas).
- The slice as a whole: one GRAHMC cell (standard_normal, dim 4, 4 chains,
  200 warmup, 300 draws, L 8) through both runners on the CPU: the same
  result keys, the same deterministic fields, finite diagnostics. The
  random streams differ (Philox and threefry), so the draws are not
  compared. (The convergence trace's checkpoints are held in
  tests/test_torch_checkpoint.py's resume test.)
- The sampling checkpoint's config stamp adds tempering_beta_min and
  tempering_swap_interval, which the JAX runner's leaves out (its fault at
  runner.py:655): the recorded difference, read from a tempered, tracked
  run of both runners stopped at the stamp.
- The command line on the CPU, read back by analyze_benchmarks.py; without
  --device on a host with no card it refuses to run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.random as random  # noqa: E402

from mcmc_tpu.benchmark import runner as J  # noqa: E402
from mcmc_tpu.targets import get_target as j_target  # noqa: E402
from mcmc_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from mcmc_tpu_torch.benchmark import runner as T  # noqa: E402
from mcmc_tpu_torch.targets import get_target as t_target  # noqa: E402
from mcmc_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("max_samples", [50, 100, 101, 300, 400, 1000, 10000, 12345])
@pytest.mark.parametrize("quantum", [None, 0, 1, 7, 50, 75])
@pytest.mark.parametrize("base", [1.5, 2.0])
def test_log_checkpoints_match_jax(max_samples, quantum, base):
    assert (T.get_log_checkpoints(max_samples, base, quantum)
            == J.get_log_checkpoints(max_samples, base, quantum))


def test_checkpoint_chunks_match_jax():
    for batch in (1, 49, 50, 51, 100, 149, 437, 10000):
        for quantum in (0, 1, 2, 50, 75):
            assert T._checkpoint_chunks(batch, quantum) == J._checkpoint_chunks(batch, quantum)


def _row(sampler="grahmc", schedule="tanh", mass=True, **extra):
    row = {"sampler": sampler, "target": "StandardNormal10D", "schedule": schedule,
           "dim": 10, "num_steps": 16, "n_chains": 1024, "accept_rate": 0.712345678,
           "rhat_max": 1.00312345, "ess_bulk_min": 71785560.0, "ess_tail_min": 1101951.875,
           "ess_per_gradient": 0.01234567, "usable": True, "quality_pass": False,
           "sliced_w2": None, "z_score_max": np.float64(1.16371234), "n_gradients": 163840000,
           "total_divergences": np.int64(3), "stats_pass": np.bool_(True),
           "gamma": 0.5 if schedule else None, "steepness": 2.0, "mass_matrix_learned": mass,
           "mass_matrix_min": 0.8123456, "swap_accept_rate": [0.21234567, 0.3]}
    row.update(extra)
    return row


def test_grid_summary_round_floats_config_key_match_jax():
    rows = [_row(), _row("nuts", None, False, avg_tree_depth=3.14159),
            _row("rwmh", None, "dense", scale=0.58712345, error="boom"),
            {"sampler": "smc", "log_z": -0.00331234}]
    for r in rows:
        assert T._grid_summary(r) == J._grid_summary(r)
        assert T._config_key(r) == J._config_key(r)
        nested = dict(r, grid_search_info={"all_results": [J._grid_summary(r)] * 2},
                      convergence_trace=[{"checkpoint": 100, "w2_distance": 0.123456789}])
        assert T._round_floats(nested) == J._round_floats(nested)
    out = T._round_floats({"n": np.int64(7), "x": np.float64(1.23456789), "y": 2.3456789,
                           "b": np.bool_(True), "s": "k", "t": torch.tensor([0.123456, 2.0]),
                           "a": np.array([1.234567, 3.0])})
    assert out == {"n": 7, "x": 1.2346, "y": 2.3457, "b": True, "s": "k", "t": [0.1235, 2.0],
                   "a": [1.2346, 3.0]}
    assert isinstance(out["n"], int) and out["b"] is True


_SIG_ROWS = [
    dict(sampler="nuts", target_name="T", schedule=None, learn_mass=True,
         nuts_backend="persistent", nuts_steps_per_sample=64, nuts_proposal="multinomial"),
    dict(sampler="nuts", target_name="T", schedule=None, learn_mass=False,
         nuts_backend="classic", nuts_steps_per_sample=64, nuts_proposal=None),
    dict(sampler="nuts", target_name="T", schedule=None, learn_mass=True,
         nuts_backend="persistent", nuts_steps_per_sample=32),
    dict(sampler="grahmc", target_name="T", schedule="tanh", learn_mass="dense",
         trajectory_tuner="chees", tempering=None),
    dict(sampler="hmc", target_name="T", schedule=None, learn_mass=True, tempering=6),
    dict(sampler="rahmc", target_name="T", schedule="sine", learn_mass=True, tempering=1),
    dict(sampler="smc", target_name="T", schedule=None, learn_mass=False, smc_particles=4096,
         smc_tune_trajectory=True),
    dict(sampler="smc", target_name="T", schedule=None, learn_mass=False),
    dict(sampler="rwmh", target_name="T", schedule=None, learn_mass=True),
]


@pytest.mark.parametrize("i", range(len(_SIG_ROWS)))
def test_resume_signature_matches_jax(i):
    kw = _SIG_ROWS[i]
    assert T._resume_signature(**kw) == J._resume_signature(**kw)


def _rows_for_files():
    first = _row("rwmh", None, True, scale=0.5871, grid_search_info=None,
                 convergence_trace=None)
    return [
        first,
        _row(grid_search_info={"tested_L_values": [8, 16], "selected_L": 16,
                               "all_results": [{"num_steps": 8, "rhat_max": 1.2}]},
             convergence_trace=[{"checkpoint": 100, "n_gradients": 409600,
                                 "w2_distance": 0.0512345, "ess_bulk_min": 1e3}]),
        _row(rhat_max=float("nan"), extra_field="dropped from the csv, kept in the json"),
        {k: v for k, v in _row("hmc", None, False).items() if k != "accept_rate"},
        _row(schedule="tanh", ess_bulk_min=12.5),           # replaces the second row
        _row("smc", None, False, log_z=-0.0033, ess_tail_min=None, sliced_w2=float("inf")),
    ]


def test_result_files_match_jax_byte_for_byte(tmp_path):
    rows = _rows_for_files()
    for i, r in enumerate(rows):
        J.save_result_incremental(r, str(tmp_path / "j"), is_first=i == 0)
        T.save_result_incremental(r, str(tmp_path / "t"), is_first=i == 0)
    for name in ("benchmark_results.csv", "benchmark_results.json", ".csv_columns.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    # and a resumed file without its pinned columns: the row's own order
    (tmp_path / "t" / ".csv_columns.json").unlink()
    (tmp_path / "j" / ".csv_columns.json").unlink()
    J.save_result_incremental(rows[3], str(tmp_path / "j"))
    T.save_result_incremental(rows[3], str(tmp_path / "t"))
    for name in ("benchmark_results.csv", ".csv_columns.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_mesh_resolution():
    for off in (None, "off", 0, 1):
        assert T._resolve_mesh(16, off, "cpu") is None
    assert T._resolve_mesh(16, "auto", "cpu") is None
    # a mesh of N > 1 ranks is N processes (torchrun); in one process it raises
    for many in (2, 8, "4"):
        with pytest.raises(ValueError, match="torchrun"):
            T._resolve_mesh(16, many, "cpu")
    with pytest.raises(ValueError, match="torchrun"):
        T.run_all_benchmarks(["rwmh"], ["standard_normal"], ["constant"], 2, 4, 10, 10, 0,
                             "unused", mesh_devices=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        T.run_single_benchmark_with_L("rwmh", t_target("standard_normal", dim=2),
                                      "standard_normal", T.make_generator(0, "cpu"), 4, 10, 10,
                                      "constant", 8, mesh_devices=2)


def test_backend_resolution(capsys):
    t = t_target("standard_normal", dim=10)
    assert T._resolve_backend("grahmc", t, "cpu") == "eager"
    assert T._resolve_nuts_backend("auto", t, "cpu") == "classic"
    assert T._resolve_nuts_backend("persistent", t, "cpu") == "persistent"
    for sampler in ("grahmc", "hmc", "rahmc", "rwmh"):
        assert T._resolve_backend(sampler, t, "cuda") == "fused"
    assert T._resolve_backend("nuts", t, "cuda") == "eager"
    assert T._resolve_nuts_backend("auto", t, "cuda") == "persistent"
    wide = t_target("standard_normal", dim=129)
    assert T._resolve_backend("grahmc", wide, "cuda") == "eager"
    assert T._resolve_nuts_backend("auto", wide, "cuda") == "classic"
    T._say_past_cap(t, "cuda")
    T._say_past_cap(wide, "cpu")
    assert capsys.readouterr().out == ""
    T._say_past_cap(wide, "cuda")
    assert "dim 129 is past the fused kernels' 128: this row runs eager" in capsys.readouterr().out
    untagged = wide._replace(value_and_grad_fn=lambda x: None, dim=4)
    assert T._resolve_backend("grahmc", untagged, "cuda") == "eager"


def _auto_resolvers():
    """Every "auto" backend decision of the samplers and tuners, each as
    (value_and_grad_fn, device) -> True where it picks its fused kernel."""
    from mcmc_tpu_torch.samplers import nuts_persistent, smc, tempered
    from mcmc_tpu_torch.tuning import adaptation, chees, dual_averaging
    return {
        "runner": lambda v, d: T._resolve_backend("grahmc", t_target("standard_normal",
                                                                     dim=v.kernel_info["dim"]),
                                                  d) == "fused",
        "adaptation": lambda v, d: adaptation._resolve_backend("grahmc", "auto", v, d) == "fused",
        "dual_averaging": lambda v, d: dual_averaging._fused_backend("auto", "rwmh", v, d),
        "chees": lambda v, d: chees._resolve_backend("auto", v, d) == "fused",
        "smc": lambda v, d: smc.resolve_move_backend("auto", v, False, None, d) == "fused",
        "nuts_persistent": lambda v, d: nuts_persistent._resolve_backend("auto", v, d) == "fused",
        "tempered": lambda v, d: tempered._resolve_backend("auto", v, d) == "fused",
    }


@pytest.mark.parametrize("where", sorted(_auto_resolvers()))
def test_every_auto_backend_asks_one_rule(where):
    """The runner's and the samplers' "auto" answer "does this kernel take
    this target here" alike (padded_targets.fusable): fused on a card up
    to the kernels' D cap, eager past it, on the CPU and untagged."""
    from mcmc_tpu_torch.ops.fused_trajectory import MAX_DIM
    from mcmc_tpu_torch.ops.padded_targets import fusable
    picks = _auto_resolvers()[where]
    for dim, device, want in [(10, "cuda", True), (MAX_DIM, "cuda", True),
                              (MAX_DIM + 1, "cuda", False), (10, "cpu", False)]:
        vag = t_target("standard_normal", dim=dim).value_and_grad_fn
        assert picks(vag, device) is want, (dim, device)
        assert fusable("grahmc", vag, device) is want
    if where != "runner":
        assert not picks(lambda x: None, "cuda")


def test_generators_split_and_repeat():
    g = T.make_generator(42, "cpu")
    a, b = T.split_generator(g), T.split_generator(g)
    assert not torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    h = T.make_generator(42, "cpu")
    assert torch.equal(torch.rand(4, generator=T.split_generator(h)),
                       torch.rand(4, generator=T.split_generator(T.make_generator(42, "cpu"))))
    assert T.position_dtype("cpu") == torch.float64
    assert T.position_dtype("cuda") == torch.float32


# --------------------------------------------------------------------------
# The slice as a whole
# --------------------------------------------------------------------------

CELL = dict(n_chains=4, num_warmup=200, num_samples=300, schedule_type="constant",
            num_steps=8, mesh_devices="off")
DETERMINISTIC = ("sampler", "schedule", "dim", "n_chains", "num_warmup", "num_samples",
                 "total_samples", "num_steps", "n_gradients", "z_score_threshold",
                 "mass_matrix_learned", "mesh_devices", "warmup_restored", "reparam",
                 "convergence_trace", "sliced_w2_transformed", "stats_pass_transformed")


@pytest.fixture(scope="module")
def cell_rows():
    """The GRAHMC cell through both runners."""
    jr = J.run_single_benchmark_with_L("grahmc", j_target("standard_normal", dim=4),
                                       "standard_normal", random.PRNGKey(0), **CELL)
    tr = T.run_single_benchmark_with_L("grahmc", t_target("standard_normal", dim=4),
                                       "standard_normal", T.make_generator(0, "cpu"), **CELL)
    return jr, tr


def test_cell_same_keys_and_deterministic_fields(cell_rows):
    jr, tr = cell_rows
    assert jr.get("error") is None and tr.get("error") is None
    assert set(tr) == set(jr)
    for field in DETERMINISTIC:
        assert tr[field] == jr[field], field
    assert tr["target"] == jr["target"]
    assert tr["n_gradients"] == 300 * 8 * 4


def test_cell_diagnostics_finite(cell_rows):
    jr, tr = cell_rows
    for field in ("accept_rate", "rhat_max", "rhat_mean", "ess_bulk_min", "ess_bulk_mean",
                  "ess_tail_min", "ess_tail_mean", "ess_per_gradient", "sliced_w2",
                  "z_score_max", "step_size", "gamma", "steepness", "mass_matrix_min",
                  "mass_matrix_max", "warmup_time", "sample_time", "total_time"):
        assert np.isfinite(tr[field]), field
        assert isinstance(tr[field], float), field
        assert np.isfinite(jr[field]), field
    assert 0.0 < tr["accept_rate"] <= 1.0 and tr["divergence_rate"] == 0.0
    for field in ("usable", "quality_pass", "rhat_pass", "ess_pass", "stats_pass"):
        assert isinstance(tr[field], bool), field


class _Stamped(Exception):
    pass


def test_checkpoint_stamp_adds_the_two_tempering_keys(tmp_path, monkeypatch):
    """The recorded difference: the JAX runner's stamp (runner.py:655)
    leaves out tempering_beta_min and tempering_swap_interval, so there a
    checkpoint of another ladder would be resumed; the port's has them.
    Both runners run a tempered, tracked HMC row with the warmup stubbed,
    stopped where the stamp is made."""
    stamps = {}

    def stop_at_stamp(name):
        def init(self, cache_dir, signature, config):
            stamps[name] = dict(config)
            raise _Stamped
        return init

    monkeypatch.setattr(j_ckpt.SamplingCheckpoint, "__init__", stop_at_stamp("jax"))
    monkeypatch.setattr(t_ckpt.SamplingCheckpoint, "__init__", stop_at_stamp("torch"))
    monkeypatch.setattr(J, "_warmup", lambda sampler, target, name, key, pos, *a, **k:
                        (0.5, None, pos, {}))
    monkeypatch.setattr(T, "_warmup", lambda sampler, target, name, gen, pos, *a, **k:
                        (0.5, None, pos, {}))
    kw = dict(n_chains=4, num_warmup=10, num_samples=300, schedule_type="constant",
              num_steps=8, track_convergence=True, mesh_devices="off", tempering=3,
              tempering_beta_min=0.1, tempering_swap_interval=2)
    J.run_single_benchmark_with_L("hmc", j_target("standard_normal", dim=2), "standard_normal",
                                  random.PRNGKey(0), warmup_cache_dir=str(tmp_path / "j"), **kw)
    T.run_single_benchmark_with_L("hmc", t_target("standard_normal", dim=2), "standard_normal",
                                  T.make_generator(0, "cpu"),
                                  warmup_cache_dir=str(tmp_path / "t"), **kw)
    assert stamps["torch"] == dict(stamps["jax"], tempering_beta_min=0.1,
                                   tempering_swap_interval=2)
    assert "tempering_beta_min" not in stamps["jax"]


# --------------------------------------------------------------------------
# The command line
# --------------------------------------------------------------------------

def _cli(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(REPO / "run_benchmarks_torch.py"), *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


def test_cli_writes_the_jax_schema_and_analysis_reads_it(tmp_path):
    out = tmp_path / "bench"
    args = ["--targets", "standard_normal", "--samplers", "rwmh", "hmc", "nuts", "grahmc",
            "--schedules", "constant", "--dim", "4", "--n-chains", "4", "--num-warmup", "200",
            "--num-samples", "300", "--num-steps-grid", "8", "--output-dir", str(out)]
    proc = _cli(["--device", "cpu", *args])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "BENCHMARK SUMMARY" in proc.stdout
    rows = json.loads((out / "benchmark_results.json").read_text())
    assert [r["sampler"] for r in rows] == ["rwmh", "hmc", "nuts", "grahmc"]
    assert rows[2]["nuts_backend"] == "classic"
    # the CSV's columns are run_benchmarks.py's, in its order: the canonical
    # matrix's file also starts with an RWMH row
    header = (out / "benchmark_results.csv").read_text().splitlines()[0]
    reference = (REPO / "results_full_matrix_native" / "benchmark_results.csv")
    assert header == reference.read_text().splitlines()[0]
    assert json.loads((out / ".csv_columns.json").read_text()) == header.split(",")

    from analysis.utils import load_benchmark_results, summarize_results
    rs = load_benchmark_results(str(out))
    assert len(rs) == 4 and summarize_results(rs)["total_runs"] == 4
    proc = subprocess.run([sys.executable, "analyze_benchmarks.py", str(out), "--summary",
                           "--L-coverage"], capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

    # a second run resumes: every configuration skipped, files unchanged
    before = {p.name: p.read_bytes() for p in out.iterdir() if p.is_file()}
    proc = _cli(["--device", "cpu", *args])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("[SKIP]") == 4
    assert {p.name: p.read_bytes() for p in out.iterdir() if p.is_file()} == before


def test_cli_without_device_refuses_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    proc = _cli(["--targets", "standard_normal", "--samplers", "rwmh", "--dim", "2",
                 "--num-warmup", "10", "--num-samples", "10", "--output-dir",
                 str(tmp_path / "x")])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "x" / "benchmark_results.json").exists()
