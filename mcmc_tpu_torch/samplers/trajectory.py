"""Hamiltonian / conformal-Hamiltonian trajectory integration (port of
``mcmc_tpu/samplers/trajectory.py``).

One integrator serves HMC and GRAHMC; with no friction schedule it is the
plain leapfrog. Substep i, on the midpoint friction grid t = (i + 1/2) eps:
    p *= exp(-gamma(t) eps/2)        [skipped without a schedule]
    p += (eps/2) grad log p(q)
    q += eps * M^{-1} p
    lp, grad = target(q)
    p += (eps/2) grad
    p *= exp(-gamma(t) eps/2)

The JAX ``lax.scan`` over substeps is a Python loop on (C, D) tensors.
"""

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


def as_scalar(x, dtype: torch.dtype, device) -> Tensor:
    """A 0-d tensor on `device` from a number or a tensor. Numbers go through
    a fill kernel, not a host-to-device copy, so no call waits on the
    device."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=device, dtype=dtype)
    return torch.full((), float(x), dtype=dtype, device=device)


def velocity(p: Tensor, inv_mass_matrix: Tensor) -> Tensor:
    """dq/dt = M^{-1} p: elementwise for a diagonal metric, one matmul for
    a dense (symmetric) one."""
    if inv_mass_matrix.ndim == 2:
        return p @ inv_mass_matrix
    return p * inv_mass_matrix


def kinetic_energy(p: Tensor, inv_mass_matrix: Tensor) -> Tensor:
    """0.5 * p^T M^{-1} p per chain."""
    return 0.5 * torch.sum(p * velocity(p, inv_mass_matrix), dim=-1)


def sample_momentum(generator: torch.Generator, shape, inv_mass_matrix: Tensor,
                    dtype: torch.dtype) -> Tensor:
    """p ~ N(0, M) with M = inv_mass_matrix^{-1}.

    Diagonal: z / sqrt(M^{-1}). Dense: with M^{-1} = L L^T, p = L^{-T} z."""
    z = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=dtype)
    if inv_mass_matrix.ndim == 2:
        chol = torch.linalg.cholesky(inv_mass_matrix.to(dtype))
        return torch.linalg.solve_triangular(chol.mT, z.T, upper=True).T
    return z / torch.sqrt(inv_mass_matrix)


def integrate_trajectory(
    q: Tensor,
    p: Tensor,
    lp: Tensor,
    grad: Tensor,
    value_and_grad: Callable,
    step_size,
    num_steps: int,
    inv_mass_matrix: Tensor,
    friction_schedule: Optional[Callable] = None,
    gamma_max=None,
    steepness=None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Integrate num_steps (conformal) leapfrog substeps for all chains.

    step_size, gamma_max and steepness may be Python numbers or 0-d tensors
    (a tensor step size from dual averaging never leaves the device).
    Returns (q, p, lp, grad) after the trajectory.
    """
    pos_dtype = q.dtype
    e_dtype = lp.dtype
    eps = as_scalar(step_size, pos_dtype, q.device)
    half_eps = 0.5 * eps
    total_time = eps * num_steps
    if friction_schedule is not None:
        gamma_t_max = as_scalar(gamma_max, pos_dtype, q.device)
        steep = as_scalar(steepness, pos_dtype, q.device)
    for i in range(num_steps):
        if friction_schedule is not None:
            # midpoint grid: friction at i and L-1-i pairs exactly about T/2,
            # so the conformal map is volume-neutral and involutive
            gamma_t = friction_schedule((i + 0.5) * eps, total_time,
                                        gamma_t_max, steep)
            scale = torch.exp(-gamma_t * half_eps)
            p = p * scale
        p = p + half_eps * grad
        q = q + eps * velocity(p, inv_mass_matrix)
        lp, grad = value_and_grad(q)
        lp = lp.to(e_dtype)
        grad = grad.to(pos_dtype)
        p = p + half_eps * grad
        if friction_schedule is not None:
            p = p * scale
    return q, p, lp, grad
