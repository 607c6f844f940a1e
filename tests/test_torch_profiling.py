"""The port's profiling helpers (mcmc_tpu_torch.utils.profiling) against
the JAX package's (mcmc_tpu.utils.profiling), on the CPU."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from mcmc_tpu.utils import profiling as jprof
from mcmc_tpu_torch import utils as tutils
from mcmc_tpu_torch.samplers.base import ChainState, RunResult
from mcmc_tpu_torch.utils import profiling as tprof


def test_utils_exports_the_ported_names():
    for name in ("wall_timer", "device_trace", "force_completion", "throughput_counters"):
        assert getattr(tutils, name) is getattr(tprof, name)
    assert not hasattr(tutils, "enable_compilation_cache")


def test_wall_timer():
    with tprof.wall_timer() as t:
        time.sleep(0.05)
    assert t.elapsed >= 0.05


def test_wall_timer_records_on_an_exception():
    with pytest.raises(KeyError):
        with tprof.wall_timer() as t:
            time.sleep(0.01)
            raise KeyError("x")
    assert t.elapsed >= 0.01


def test_device_trace_none_is_a_no_op(tmp_path):
    with tprof.device_trace(None) as prof:
        x = torch.ones(3).sum()
    assert prof is None and float(x) == 3.0


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.device_trace(str(log_dir)) as prof:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    (trace,) = list(log_dir.glob("*.pt.trace.json"))
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()
    assert any("matmul" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("ess", [None, 400.0, 1234.5])
@pytest.mark.parametrize("args", [(100, 8, 16, 2.0, 4), (1000, 4096, 8, 0.37, 1),
                                  (3, 1, 1, 1e-3, 8)])
def test_throughput_counters_equal_the_jax_ones(args, ess):
    num_samples, n_chains, num_steps, sample_time, n_devices = args
    kw = dict(num_samples=num_samples, n_chains=n_chains, num_steps=num_steps,
              sample_time=sample_time, ess_bulk_min=ess, n_devices=n_devices)
    want = jprof.throughput_counters(**kw)
    got = tprof.throughput_counters(**kw)
    assert got == want


def test_throughput_counters_values():
    c = tprof.throughput_counters(num_samples=100, n_chains=8, num_steps=16,
                                  sample_time=2.0, ess_bulk_min=400.0, n_devices=4)
    assert c["chain_steps_per_sec"] == 400.0
    assert c["grad_evals_per_sec"] == 6400.0
    assert c["ess_per_sec_per_chip"] == 50.0


@dataclasses.dataclass
class _Box:
    label: str
    inner: object


def _result():
    state = ChainState(position=torch.zeros(4, 2), log_prob=torch.zeros(4),
                       grad_log_prob=torch.zeros(4, 2),
                       accept_count=torch.zeros(4, dtype=torch.int32),
                       divergence_count=torch.zeros(4, dtype=torch.int32))
    return RunResult(samples=torch.zeros(3, 4, 2), log_probs=torch.zeros(3, 4),
                     accept_rate=torch.zeros(4), final_state=state,
                     info={"delta": torch.zeros(1)})


@pytest.mark.parametrize("make", [
    _result,
    lambda: {"a": [1, (2.0, _result())]},
    lambda: _Box("x", [_result()]),
    lambda: ("no tensor", 3, None),
    lambda: _result().final_state,
    lambda: np.zeros(3),
])
def test_force_completion_returns_its_argument(make):
    tree = make()
    assert tprof.force_completion(tree) is tree


def test_first_tensor_leaf_of_nested_trees():
    r = _result()
    assert tprof._first_tensor(r) is r.samples
    assert tprof._first_tensor({"k": [None, _Box("b", (1, r.log_probs))]}) is r.log_probs
    assert tprof._first_tensor(r.final_state) is r.final_state.position
    assert tprof._first_tensor([1, "x", {"y": 2.0}]) is None
