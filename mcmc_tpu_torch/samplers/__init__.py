"""Samplers: GRAHMC, HMC, RWMH, classic NUTS (eager), persistent NUTS,
parallel tempering and annealed SMC (eager and fused backends)."""

from mcmc_tpu_torch.samplers.base import (ChainState, RunResult, ensure_batched,
                                          init_chain_state)
from mcmc_tpu_torch.samplers.grahmc import (
    FRICTION_SCHEDULES, NO_FRICTION, constant_schedule, default_steepness,
    get_friction_schedule, grahmc_init, grahmc_run, grahmc_step,
    grahmc_transition, linear_schedule, sigmoid_schedule, sine_schedule,
    tanh_schedule,
)
from mcmc_tpu_torch.samplers.hmc import hmc_init, hmc_run, hmc_step, leapfrog
from mcmc_tpu_torch.samplers.nuts import nuts_init, nuts_run, nuts_step
from mcmc_tpu_torch.samplers.nuts_persistent import nuts_run_persistent
from mcmc_tpu_torch.samplers.rwmh import rwmh_init, rwmh_run, rwmh_step
from mcmc_tpu_torch.samplers.smc import (SMCResult, gaussian_base, smc_run,
                                         systematic_resample, weighted_moments)
from mcmc_tpu_torch.samplers.tempered import geometric_ladder, tempered_run

__all__ = [
    "ChainState", "RunResult", "ensure_batched", "init_chain_state",
    "grahmc_init", "grahmc_step", "grahmc_transition", "grahmc_run",
    "hmc_init", "hmc_step", "hmc_run", "leapfrog",
    "rwmh_init", "rwmh_step", "rwmh_run",
    "nuts_init", "nuts_step", "nuts_run", "nuts_run_persistent",
    "geometric_ladder", "tempered_run", "SMCResult", "gaussian_base", "smc_run",
    "systematic_resample", "weighted_moments",
    "FRICTION_SCHEDULES", "get_friction_schedule", "default_steepness",
    "NO_FRICTION", "constant_schedule", "tanh_schedule", "sigmoid_schedule",
    "linear_schedule", "sine_schedule",
]
