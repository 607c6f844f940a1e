"""Utilities: timers, the torch.profiler trace, the timing barrier and the
throughput counters (``utils.profiling``), chain-state and warmup
checkpoints (``utils.checkpoint``), the run's generators
(``utils.generators``) and the headless plotting backend. The JAX
package's ``enable_compilation_cache`` (XLA's cache) has no counterpart:
the port's kernels are cached in ``mcmc_tpu_torch/_build/``."""

import os

from mcmc_tpu_torch.utils.profiling import (device_trace, force_completion,
                                            throughput_counters, wall_timer)

__all__ = ["wall_timer", "device_trace", "force_completion", "throughput_counters",
           "setup_headless_backend"]


def setup_headless_backend():
    """Select matplotlib's Agg backend, but only without a display and
    without an MPLBACKEND choice: a library must not take an interactive
    session's backend, and a headless run must not pick a GUI one."""
    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        import matplotlib
        matplotlib.use("Agg")
