"""Hamiltonian Monte Carlo (port of ``mcmc_tpu/samplers/hmc.py``).

HMC is the friction-free special case of the shared conformal-leapfrog
trajectory: ``hmc_run`` is ``grahmc_run`` with NO_FRICTION.
"""

from typing import Callable, Optional

import torch

from mcmc_tpu_torch.samplers.base import ChainState, RunResult, init_chain_state
from mcmc_tpu_torch.samplers.grahmc import NO_FRICTION, grahmc_run, grahmc_step
from mcmc_tpu_torch.samplers.trajectory import integrate_trajectory


def hmc_init(init_position, log_prob_fn, value_and_grad_fn=None) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                            needs_grad=True)


def leapfrog(q, p, lp, grad, value_and_grad, step_size, num_steps: int,
             inv_mass_matrix):
    """Standard leapfrog integration (no friction). Returns (q, p, lp, grad)."""
    return integrate_trajectory(q, p, lp, grad, value_and_grad, step_size,
                                num_steps, inv_mass_matrix,
                                friction_schedule=None)


def hmc_step(generator, state: ChainState, value_and_grad, step_size,
             num_steps: int, inv_mass_matrix):
    """One HMC step: the shared step with no friction schedule."""
    return grahmc_step(generator, state, value_and_grad, step_size, num_steps,
                       gamma=0.0, steepness=1.0,
                       inv_mass_matrix=inv_mass_matrix, friction_schedule=None)


def hmc_run(
    generator: torch.Generator,
    log_prob_fn,
    init_position,
    step_size,
    num_steps: int,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix=None,
    track_proposals: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "eager",
) -> RunResult:
    """Run HMC chains. Returns RunResult (see samplers.base)."""
    return grahmc_run(
        generator, log_prob_fn, init_position, step_size, num_steps,
        gamma=0.0, steepness=1.0, num_samples=num_samples, burn_in=burn_in,
        inv_mass_matrix=inv_mass_matrix,
        friction_schedule=NO_FRICTION,
        track_proposals=track_proposals,
        value_and_grad_fn=value_and_grad_fn,
        collect_chains=collect_chains,
        backend=backend,
    )
