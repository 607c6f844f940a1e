"""Adaptive warmup: dual averaging, Welford mass-matrix learning, windowed
adaptation, sequential ESJD friction tuning, ChEES trajectory-length
adaptation and jittered sampling, tempering-ladder tuning, the per-sampler
convergence-driven DA tuners and the deprecated joint GRAHMC tune (port of
``mcmc_tpu.tuning``)."""

from mcmc_tpu_torch.tuning.adaptation import build_schedule, run_adaptive_warmup
from mcmc_tpu_torch.tuning.chees import (
    CHEES_ADAM_LR, DEFAULT_MAX_STEPS, ChEESState, GammaSPSAState, chees_init,
    chees_log_t_grad, chees_run, chees_update, gamma_spsa_batch_update, gamma_spsa_init,
    halton_sequence, num_leapfrog_steps, run_chees_warmup, scale_default_schedule,
)
from mcmc_tpu_torch.tuning.dual_averaging import (
    TARGET_ACCEPT_GRAHMC, TARGET_ACCEPT_HMC, TARGET_ACCEPT_NUTS, TARGET_ACCEPT_RWMH,
    DualAveragingState, JointDualAveragingState, da_final_step_size, da_init, da_reset,
    da_step_size, da_update, dual_averaging_tune_hmc, dual_averaging_tune_nuts,
    dual_averaging_tune_rwmh, joint_da_init, joint_da_update, joint_tune_grahmc,
)
from mcmc_tpu_torch.tuning.ladder import (DEFAULT_SWAP_TARGET, geometric_spacings,
                                          spacings_to_betas, tune_ladder)
from mcmc_tpu_torch.tuning.sequential import sequential_tune_grahmc
from mcmc_tpu_torch.tuning.welford import (
    WelfordState, chain_averaged_variance, shrink_variance, welford_covariance,
    welford_init, welford_update, welford_update_batch,
)

__all__ = [
    "WelfordState", "welford_init", "welford_update", "welford_update_batch",
    "welford_covariance", "chain_averaged_variance", "shrink_variance",
    "DualAveragingState", "da_init", "da_update", "da_reset", "da_step_size",
    "da_final_step_size", "JointDualAveragingState", "joint_da_init", "joint_da_update",
    "joint_tune_grahmc", "dual_averaging_tune_rwmh", "dual_averaging_tune_hmc",
    "dual_averaging_tune_nuts", "TARGET_ACCEPT_RWMH", "TARGET_ACCEPT_HMC",
    "TARGET_ACCEPT_NUTS", "TARGET_ACCEPT_GRAHMC",
    "build_schedule", "run_adaptive_warmup", "sequential_tune_grahmc",
    "DEFAULT_SWAP_TARGET", "geometric_spacings", "spacings_to_betas", "tune_ladder",
    "CHEES_ADAM_LR", "DEFAULT_MAX_STEPS", "ChEESState", "GammaSPSAState", "chees_init",
    "chees_update", "chees_log_t_grad", "chees_run", "run_chees_warmup", "gamma_spsa_init",
    "gamma_spsa_batch_update", "halton_sequence", "num_leapfrog_steps",
    "scale_default_schedule",
]
