"""The fixed-budget benchmark pipeline (warmup -> sample -> diagnose ->
gate) with the JAX runner's flags and result schema, on the port (port of
``mcmc_tpu/benchmark``); its command line is ``run_benchmarks_torch.py``."""

from mcmc_tpu_torch.benchmark.runner import (
    ALL_TARGET_NAMES, get_log_checkpoints, print_summary, run_all_benchmarks,
    run_single_benchmark_with_L, run_trajectory_length_grid_search, save_result_incremental,
)

__all__ = [
    "get_log_checkpoints",
    "run_single_benchmark_with_L",
    "run_trajectory_length_grid_search",
    "run_all_benchmarks",
    "save_result_incremental",
    "print_summary",
    "ALL_TARGET_NAMES",
]
