"""Drop-in reference-shaped API (port of ``mcmc_tpu/compat.py``): tuple
returns under the reference's symbol names.

The native API returns a uniform RunResult; user code written against the
reference's samplers (rwMH_run, hmc_run, nuts_run, rahmc_run returning
positional tuples -- reference RWMH.py:122, HMC.py:222, NUTS.py:445,
GRAHMC.py:352) imports the same names from here and gets the same tuple
shapes, the track_proposals 9-tuples included. The leading PRNG key is a
``torch.Generator`` on the positions' device, as in every sampler of the
port. Like the JAX package's compat, it passes no value_and_grad_fn, so
every run is the samplers' eager backend (gradients by autograd).
"""

from mcmc_tpu_torch.samplers import grahmc_init, hmc_init, nuts_init, rwmh_init
from mcmc_tpu_torch.samplers import grahmc_run as _grahmc_run
from mcmc_tpu_torch.samplers import hmc_run as _hmc_run
from mcmc_tpu_torch.samplers import nuts_run as _nuts_run
from mcmc_tpu_torch.samplers import rwmh_run as _rwmh_run
from mcmc_tpu_torch.samplers.grahmc import (
    FRICTION_SCHEDULES, constant_schedule, get_friction_schedule, linear_schedule,
    sigmoid_schedule, sine_schedule, tanh_schedule,
)

# init aliases (reference naming)
rwMH_init = rwmh_init
rahmc_init = grahmc_init


def _tracked(r):
    return (r.samples, r.log_probs, r.accept_rate, r.final_state,
            r.info["pre_positions"], r.info["pre_log_probs"],
            r.info["proposal_positions"], r.info["proposal_log_probs"],
            r.info["delta_H"])


def rwMH_run(generator, log_prob_fn, init_position, num_samples, scale, burn_in=0):
    """(samples, log_probs, accept_rate, final_state) -- reference RWMH.py:122."""
    r = _rwmh_run(generator, log_prob_fn, init_position, num_samples=num_samples,
                  scale=scale, burn_in=burn_in)
    return r.samples, r.log_probs, r.accept_rate, r.final_state


def hmc_run(generator, log_prob_fn, init_position, step_size, num_steps,
            num_samples, burn_in=0, inv_mass_matrix=None,
            track_proposals=False):
    """Reference HMC.py:222 tuple shapes (4-tuple, or 9-tuple when tracking)."""
    r = _hmc_run(generator, log_prob_fn, init_position, step_size=step_size,
                 num_steps=num_steps, num_samples=num_samples, burn_in=burn_in,
                 inv_mass_matrix=inv_mass_matrix,
                 track_proposals=track_proposals)
    if track_proposals:
        return _tracked(r)
    return r.samples, r.log_probs, r.accept_rate, r.final_state


def nuts_run(generator, log_prob_fn, init_position, step_size, num_samples,
             burn_in=0, inv_mass_matrix=None, max_tree_depth=10,
             delta_max=1000.0):
    """(samples, log_probs, accept_rate, final_state, tree_depths,
    mean_accept_probs) -- reference NUTS.py:445."""
    r = _nuts_run(generator, log_prob_fn, init_position, step_size=step_size,
                  num_samples=num_samples, burn_in=burn_in,
                  inv_mass_matrix=inv_mass_matrix,
                  max_tree_depth=max_tree_depth, delta_max=delta_max)
    return (r.samples, r.log_probs, r.accept_rate, r.final_state,
            r.info["tree_depths"], r.info["mean_accept_probs"])


def rahmc_run(generator, log_prob_fn, init_position, step_size, num_steps, gamma,
              steepness, num_samples, burn_in=0, inv_mass_matrix=None,
              friction_schedule=None, track_proposals=False):
    """Reference GRAHMC.py:352 tuple shapes (4-tuple, or 9-tuple when
    tracking)."""
    r = _grahmc_run(generator, log_prob_fn, init_position, step_size=step_size,
                    num_steps=num_steps, gamma=gamma, steepness=steepness,
                    num_samples=num_samples, burn_in=burn_in,
                    inv_mass_matrix=inv_mass_matrix,
                    friction_schedule=friction_schedule,
                    track_proposals=track_proposals)
    if track_proposals:
        return _tracked(r)
    return r.samples, r.log_probs, r.accept_rate, r.final_state


__all__ = [
    "rwMH_init", "rwMH_run", "hmc_init", "hmc_run", "nuts_init", "nuts_run",
    "rahmc_init", "rahmc_run",
    "FRICTION_SCHEDULES", "get_friction_schedule",
    "constant_schedule", "tanh_schedule", "sigmoid_schedule",
    "linear_schedule", "sine_schedule",
]
