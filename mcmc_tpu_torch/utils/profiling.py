"""Profiling and throughput counters (port of ``mcmc_tpu/utils/profiling.py``).

Wall-clock timers for the result schema, a device trace through
``torch.profiler`` where the JAX package takes ``jax.profiler``, a timing
barrier, and the steps/sec and ESS/sec counters. The JAX package's
``enable_compilation_cache`` configures XLA's cache and has no
counterpart: the port's kernels are built once into
``mcmc_tpu_torch/_build/``, keyed by a digest of their sources
(``ops/_cuda.py``).
"""

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def wall_timer():
    """Wall-clock timer context: `with wall_timer() as t: ...; t.elapsed`."""
    class _T:
        elapsed = 0.0
    t = _T()
    start = time.time()
    try:
        yield t
    finally:
        t.elapsed = time.time() - start


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """torch.profiler trace context; a no-op when log_dir is None, so call
    sites can stay in production code.

    Records CPU activity, and CUDA activity where a card is present, and
    writes a Chrome/Perfetto trace (``*.pt.trace.json``) into log_dir when
    the block ends. Yields the profiler (None for the no-op), whose
    ``key_averages()`` sum the time by kernel."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor leaf of nested tuples (NamedTuples too), lists,
    dicts and dataclasses, or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        leaf = _first_tensor(child)
        if leaf is not None:
            return leaf
    return None


def force_completion(tree):
    """Wait for the card's queued work (timing barrier): torch.cuda.
    synchronize on the device of the tree's first tensor leaf. A tree whose
    first tensor lies on the CPU, or that holds none, has nothing to wait
    for. Returns tree."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return tree


def throughput_counters(num_samples: int, n_chains: int, num_steps: int,
                        sample_time: float, ess_bulk_min: Optional[float] = None,
                        n_devices: int = 1) -> Dict[str, float]:
    """steps/sec, chain-steps/sec, grad-evals/sec and ESS/sec(/chip)."""
    chain_steps = num_samples * n_chains
    out = {
        "steps_per_sec": num_samples / sample_time,
        "chain_steps_per_sec": chain_steps / sample_time,
        "grad_evals_per_sec": chain_steps * num_steps / sample_time,
        "chain_steps_per_sec_per_chip": chain_steps / sample_time / n_devices,
    }
    if ess_bulk_min is not None:
        out["ess_per_sec"] = ess_bulk_min / sample_time
        out["ess_per_sec_per_chip"] = ess_bulk_min / sample_time / n_devices
    return out
