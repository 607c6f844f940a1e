"""Utilities: chain-state and warmup checkpoints (``utils.checkpoint``) and
the headless plotting backend. The JAX package's XLA compilation cache has
no counterpart (the port's kernel cache is ``mcmc_tpu_torch/_build/``);
its profiling helpers are not ported yet."""

import os

__all__ = ["setup_headless_backend"]


def setup_headless_backend():
    """Select matplotlib's Agg backend, but only without a display and
    without an MPLBACKEND choice: a library must not take an interactive
    session's backend, and a headless run must not pick a GUI one."""
    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        import matplotlib
        matplotlib.use("Agg")
