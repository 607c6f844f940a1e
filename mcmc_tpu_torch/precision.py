"""Mixed-precision policy (port of ``mcmc_tpu/precision.py``).

JAX switches the energy dtype globally with ``jax_enable_x64``. PyTorch has no
such switch, so the port takes it from the positions: float64 positions give
float64 log-probs and Hamiltonians, anything else gives float32. Positions
and gradients stay in the position dtype.
"""

import torch

# Forced-rejection energy for non-finite Hamiltonians: large enough that
# log_alpha is astronomically negative, small enough not to overflow float32.
ENERGY_OVERFLOW = 1e10


def energy_dtype(position_dtype: torch.dtype) -> torch.dtype:
    """Dtype for log-probs and Hamiltonians given the position dtype."""
    return torch.float64 if position_dtype == torch.float64 else torch.float32


def guard_energy(h: torch.Tensor) -> torch.Tensor:
    """Replace non-finite Hamiltonians with a huge finite value => forced reject."""
    return torch.where(torch.isfinite(h), h,
                       torch.full_like(h, ENERGY_OVERFLOW))
