"""The port's process-group layer (mcmc_tpu_torch.parallel.distributed and
the mesh's backend rule) and the runner over a mesh, on the CPU.

- initialize() is a one-process no-op, and re-raises a failed rendezvous
  when torchrun's environment says there is a multi-process job (the JAX
  package's rule, tests/test_distributed.py:271-290).
- The backend rule: gloo on the CPU, NCCL for ranks on cards of their own,
  NCCL refused where ranks share a card unless gloo is asked for.
- A 4-rank gloo group: the mesh in rank order, the blocks and the gathers,
  the collectives, each rank's stream independent of the mesh's size, and
  a sharded GRAHMC run's ranks bit for bit against 1-rank runs.
- A rank that dies makes the others' collective fail, not hang; a rank
  group runs on the card unless the caller asks for the CPU.
- run_benchmarks_torch.py --mesh 2 under torchrun on the CPU: the row keeps
  the schema of the run without a mesh, mesh_devices is 2, and the files
  are written once.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from mcmc_tpu_torch import parallel as P  # noqa: E402
from mcmc_tpu_torch.parallel import distributed as D  # noqa: E402
from mcmc_tpu_torch.parallel.launch import RankRun, run_ranks  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HERE = os.path.abspath(__file__)
CHAINS = 16
RUNNER_ARGS = ["--device", "cpu", "--targets", "standard_normal", "--samplers", "grahmc",
               "--schedules", "constant", "--dim", "3", "--n-chains", "8",
               "--num-warmup", "100", "--num-samples", "100", "--num-steps-grid", "4",
               "--no-warmup-cache"]


def _four_ranks(mesh):
    """The 4-rank cases (run on each rank)."""
    from mcmc_tpu_torch.parallel import fused_sharded as fs
    from mcmc_tpu_torch.targets import get_target
    r = mesh.rank
    x = torch.arange(CHAINS * 2, dtype=torch.float64).reshape(CHAINS, 2)
    local = P.shard_chains(x, mesh)
    t = get_target("neals_funnel", dim=6)
    init = t.init_sampler(torch.Generator().manual_seed(0), CHAINS, dtype=torch.float32)
    block = slice(r * CHAINS // mesh.size, (r + 1) * CHAINS // mesh.size)
    kw = dict(step_size=0.1, num_steps=4, gamma=1.0, steepness=0.5, num_samples=5,
              collect_chains_per_device=CHAINS // mesh.size)
    a = fs.grahmc_run_sharded(torch.Generator().manual_seed(5), t, init, mesh, **kw)
    b = fs.grahmc_run_sharded(torch.Generator().manual_seed(5), t, init[block],
                              P.solo_mesh("cpu", r), **kw)
    stream = P.rank_generator(torch.Generator().manual_seed(3), mesh)
    return {
        "rank": r, "size": mesh.size, "backend": mesh.backend, "fold": mesh.fold_index,
        "local": local, "gathered": P.all_gather(local, mesh),
        "psum": P.psum(torch.tensor([float(r), 1.0]), mesh),
        "pmax": P.pmax(torch.tensor(float(r)), mesh),
        "pmean": P.pmean(torch.tensor(float(r)), mesh),
        "stream": torch.rand(4, generator=stream),
        "grahmc": (a.samples[:, block], b.samples, a.final_state.position,
                   a.info["total_divergences"]),
    }


def _one_rank_dies(mesh):
    """Rank 1 leaves without a word; rank 0 then waits on a collective."""
    if mesh.rank == 1:
        os._exit(0)
    return {"sum": P.psum(torch.ones(1), mesh)}


@pytest.fixture(scope="module")
def four():
    return run_ranks(f"{HERE}:_four_ranks", 4, device="cpu", timeout=120)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runner_rows(tmp_path_factory):
    """The runner's cell twice, at once: torchrun over 2 ranks (--mesh 2)
    and one process (--mesh off)."""
    out = tmp_path_factory.mktemp("mesh_runner")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "TORCHELASTIC_RUN_ID"):
        env.pop(v, None)
    mesh = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), str(REPO / "run_benchmarks_torch.py"), *RUNNER_ARGS,
         "--mesh", "2", "--output-dir", str(out / "mesh")],
        cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    solo = subprocess.Popen(
        [sys.executable, str(REPO / "run_benchmarks_torch.py"), *RUNNER_ARGS, "--mesh", "off",
         "--output-dir", str(out / "solo")],
        cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = [p.communicate(timeout=120)[0] for p in (mesh, solo)]
    finally:
        for p in (mesh, solo):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert mesh.returncode == 0, logs[0][-4000:]
    assert solo.returncode == 0, logs[1][-4000:]
    return out, logs


# ----------------------------------------------------------------------------
# initialize and the backend rule
# ----------------------------------------------------------------------------

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "TORCHELASTIC_RUN_ID")


def test_initialize_single_process_noop(monkeypatch):
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    assert D.initialize() == 0
    assert D.initialize(num_processes=1) == 0
    assert not dist.is_initialized()
    assert D.make_chain_mesh(device="cpu") == P.solo_mesh("cpu")


def test_initialize_reraises_under_torchrun_env(monkeypatch):
    def boom(*args, **kw):
        raise RuntimeError("connect() timed out to 10.0.0.2:29500")
    monkeypatch.setattr(dist, "init_process_group", boom)
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    assert D.initialize() == 0          # no job in the environment: one process
    for var, value in (("MASTER_ADDR", "10.0.0.2"), ("TORCHELASTIC_RUN_ID", "job"),
                       ("WORLD_SIZE", "2")):
        monkeypatch.setenv(var, value)
        with pytest.raises(RuntimeError, match="timed out"):
            D.initialize()
        monkeypatch.delenv(var)
    # explicit arguments always re-raise
    with pytest.raises(RuntimeError, match="timed out"):
        D.initialize("tcp://10.0.0.2:29500", 2, 0, device="cpu")


def test_backend_rule(monkeypatch):
    assert P.mesh_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="CPU ranks take gloo"):
        P.mesh_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        P.mesh_backend("cpu", 2, "mpi")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert P.mesh_backend("cuda", 1) == "nccl"
    for requested in (None, "nccl"):
        with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one GPU"):
            P.mesh_backend("cuda", 2, requested)
    assert P.mesh_backend("cuda", 2, "gloo") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert P.mesh_backend("cuda:1", 4) == "nccl"


def test_a_mesh_needs_its_processes():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        P.make_mesh(2, device="cpu")


def test_fold_is_independent_of_the_stream_index_order():
    draws = [torch.rand(3, generator=P.fold_generator(torch.Generator().manual_seed(1), i))
             for i in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[1])


# ----------------------------------------------------------------------------
# Four ranks
# ----------------------------------------------------------------------------

def test_four_rank_mesh_in_rank_order(four):
    assert [r["rank"] for r in four] == [0, 1, 2, 3]
    assert all(r["size"] == 4 and r["backend"] == "gloo" and r["fold"] == r["rank"]
               for r in four)
    x = torch.arange(CHAINS * 2, dtype=torch.float64).reshape(CHAINS, 2)
    for r in four:
        assert torch.equal(r["local"], x[4 * r["rank"]:4 * (r["rank"] + 1)])
        assert torch.equal(r["gathered"], x)


def test_four_rank_collectives(four):
    for r in four:
        assert torch.equal(r["psum"], torch.tensor([6.0, 4.0]))
        assert float(r["pmax"]) == 3.0 and float(r["pmean"]) == 1.5


def test_each_rank_stream_depends_on_the_seed_and_rank_only(four):
    for r in four:
        own = P.fold_generator(torch.Generator().manual_seed(3), r["rank"])
        assert torch.equal(r["stream"], torch.rand(4, generator=own))
    assert len({tuple(r["stream"].tolist()) for r in four}) == 4


@pytest.mark.parametrize("rank", range(4))
def test_four_rank_grahmc_equals_one_rank_runs(four, rank):
    mesh_block, solo, final, total = four[rank]["grahmc"]
    assert torch.equal(mesh_block, solo)
    assert torch.equal(final, four[0]["grahmc"][2])
    assert int(total) == int(four[0]["grahmc"][3])


def test_a_dead_rank_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 0 \(exit 1\)"):
        RankRun(f"{HERE}:_one_rank_dies", 2, device="cpu", timeout=100).results()
    assert time.monotonic() - t0 < 100


def test_a_rank_group_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(f"{HERE}:_one_rank_dies", 2, timeout=10)


# ----------------------------------------------------------------------------
# The runner under torchrun
# ----------------------------------------------------------------------------

def test_runner_mesh_keeps_the_schema(runner_rows):
    out, _logs = runner_rows
    mesh = json.loads((out / "mesh" / "benchmark_results.json").read_text())
    solo = json.loads((out / "solo" / "benchmark_results.json").read_text())
    assert [r["sampler"] for r in mesh] == [r["sampler"] for r in solo] == ["grahmc"]
    for m, s in zip(mesh, solo):
        assert set(m) == set(s), set(m) ^ set(s)
        assert m["mesh_devices"] == 2 and s["mesh_devices"] is None
        assert "error" not in m and m["n_chains"] == 8
        assert m["total_samples"] == s["total_samples"]


def test_runner_mesh_writes_its_files_once(runner_rows):
    out, logs = runner_rows
    mesh_csv = (out / "mesh" / "benchmark_results.csv").read_text().splitlines()
    solo_csv = (out / "solo" / "benchmark_results.csv").read_text().splitlines()
    assert mesh_csv[0] == solo_csv[0]                 # the same header, once
    assert len(mesh_csv) == len(solo_csv) == 2
    assert sorted(p.name for p in (out / "mesh").iterdir()) == sorted(
        p.name for p in (out / "solo").iterdir())
    assert logs[0].count("[mesh]") == 0               # 8 chains divide over 2 ranks
