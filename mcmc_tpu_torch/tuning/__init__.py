"""Adaptation ported so far: the dual-averaging step-size core."""

from mcmc_tpu_torch.tuning.dual_averaging import (
    TARGET_ACCEPT_GRAHMC, TARGET_ACCEPT_HMC, DualAveragingState,
    da_final_step_size, da_init, da_step_size, da_update,
)

__all__ = [
    "DualAveragingState", "da_init", "da_update", "da_step_size",
    "da_final_step_size", "TARGET_ACCEPT_HMC", "TARGET_ACCEPT_GRAHMC",
]
