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


def as_operand(x, dtype: torch.dtype, device) -> Tensor:
    """as_scalar, except that a (C, 1) tensor stays a per-chain row: a step
    size (or friction, steepness) per chain, as a tempering ladder gives
    its replicas."""
    if isinstance(x, torch.Tensor) and x.ndim == 2:
        return x.to(device=device, dtype=dtype)
    return as_scalar(x, dtype, device)


def velocity(p: Tensor, inv_mass_matrix: Tensor,
             matmul: Callable = torch.matmul) -> Tensor:
    """dq/dt = M^{-1} p: elementwise for a diagonal metric, one matmul for
    a dense (symmetric) one (`matmul`, e.g. ordered_matmul)."""
    if inv_mass_matrix.ndim == 2:
        return matmul(p, inv_mass_matrix)
    return p * inv_mass_matrix


def kinetic_energy(p: Tensor, inv_mass_matrix: Tensor,
                   matmul: Callable = torch.matmul) -> Tensor:
    """0.5 * p^T M^{-1} p per chain."""
    return 0.5 * torch.sum(p * velocity(p, inv_mass_matrix, matmul), dim=-1)


def ordered_matmul(x: Tensor, a: Tensor) -> Tensor:
    """x @ a for a row batch x (..., D) and a (D, D) matrix, summed over i in
    order with each product x_i a_i rounded before it is added: the dense
    metric products of csrc/metric.cuh, bit for bit."""
    acc = x[..., 0:1] * a[0]
    for i in range(1, a.shape[0]):
        acc = acc + x[..., i:i + 1] * a[i]
    return acc


def dense_unwhitening(inv_mass_matrix: Tensor, check_errors: bool = True) -> Tensor:
    """L^{-1} for a dense M^{-1} = L L^T (lower Cholesky factor L): a row of
    standard normals z gives the momentum p = z @ L^{-1}, whose covariance
    L^{-T} L^{-1} is M. Computed once per metric, outside any sampling loop,
    and exactly lower triangular, as the kernels' unwhitening takes it
    (csrc/metric.cuh skips the zero triangle). check_errors=False skips the positive-definiteness check, which would
    wait for the device (the warmup's shrunk estimates are positive definite
    by construction)."""
    chol, _ = torch.linalg.cholesky_ex(inv_mass_matrix, check_errors=check_errors)
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye, upper=False).tril()


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
    matmul: Callable = torch.matmul,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Integrate num_steps (conformal) leapfrog substeps for all chains.

    step_size, gamma_max and steepness may be Python numbers, 0-d tensors
    (a tensor step size from dual averaging never leaves the device) or
    (C, 1) per-chain rows; with a row step size the friction time
    T = eps L is per chain too.
    `matmul` computes a dense metric's velocity (ordered_matmul in the
    kernels' plain versions). Returns (q, p, lp, grad) after the trajectory.
    """
    pos_dtype = q.dtype
    e_dtype = lp.dtype
    eps = as_operand(step_size, pos_dtype, q.device)
    half_eps = 0.5 * eps
    total_time = eps * num_steps
    if friction_schedule is not None:
        gamma_t_max = as_operand(gamma_max, pos_dtype, q.device)
        steep = as_operand(steepness, pos_dtype, q.device)
    for i in range(num_steps):
        if friction_schedule is not None:
            # midpoint grid: friction at i and L-1-i pairs exactly about T/2,
            # so the conformal map is volume-neutral and involutive
            gamma_t = friction_schedule((i + 0.5) * eps, total_time,
                                        gamma_t_max, steep)
            scale = torch.exp(-gamma_t * half_eps)
            p = p * scale
        p = p + half_eps * grad
        q = q + eps * velocity(p, inv_mass_matrix, matmul)
        lp, grad = value_and_grad(q)
        lp = lp.to(e_dtype)
        grad = grad.to(pos_dtype)
        p = p + half_eps * grad
        if friction_schedule is not None:
            p = p * scale
    return q, p, lp, grad


# The JAX package's integrate_trajectory_dynamic takes a traced leapfrog
# count (a while loop); here the count is a host int shared by all chains,
# so it is integrate_trajectory itself. The friction schedule sees T =
# num_steps eps, so its switch stays centered on the realized trajectory.
integrate_trajectory_dynamic = integrate_trajectory


def mh_transition_dynamic(generator: Optional[torch.Generator], state, value_and_grad,
                          step_size, n_leapfrogs: int, inv_mass_matrix: Tensor,
                          friction_schedule: Optional[Callable] = None, gamma_max=0.0,
                          steepness=1.0, p0: Optional[Tensor] = None,
                          u: Optional[Tensor] = None):
    """One MH transition of `n_leapfrogs` (a host int) leapfrogs: the
    transition shared by the ChEES warmup and sampler (tuning/chees.py) and
    the ChEES-tuned SMC moves (samplers/smc.py).

    Draws the momentum, then the accept uniforms, from `generator` (on the
    state's device), unless p0 (C, D) and u (C,) are injected. Returns
    (new_state, accept, q1, p1, log_alpha, divergent): q1 and p1 the
    trajectory's endpoint, p1 the momentum before the reversibility flip
    (the ChEES criterion needs dq/dt there), log_alpha = min(0, H0 - H1)
    per chain (non-finite H1 guarded to a forced reject), divergent the
    |dH| > 1000 flag, already counted into the new state."""
    from mcmc_tpu_torch import precision
    from mcmc_tpu_torch.samplers.grahmc import DIVERGENCE_DELTA_H

    pos = state.position
    e_dtype = state.log_prob.dtype
    if p0 is None:
        p0 = sample_momentum(generator, pos.shape, inv_mass_matrix, pos.dtype)
    h0 = -state.log_prob + kinetic_energy(p0, inv_mass_matrix).to(e_dtype)
    q1, p1, lp1, grad1 = integrate_trajectory(
        pos, p0, state.log_prob, state.grad_log_prob, value_and_grad, step_size,
        int(n_leapfrogs), inv_mass_matrix, friction_schedule=friction_schedule,
        gamma_max=gamma_max, steepness=steepness)
    h1 = precision.guard_energy(-lp1 + kinetic_energy(p1, inv_mass_matrix).to(e_dtype))
    log_alpha = torch.clamp(h0 - h1, max=0.0)
    divergent = torch.abs(h1 - h0) > DIVERGENCE_DELTA_H
    if u is None:
        u = torch.rand(pos.shape[0], generator=generator, device=generator.device,
                       dtype=e_dtype)
    accept = torch.log(u) < log_alpha
    new_state = state._replace(
        position=torch.where(accept[:, None], q1, pos),
        log_prob=torch.where(accept, lp1, state.log_prob),
        grad_log_prob=torch.where(accept[:, None], grad1, state.grad_log_prob),
        accept_count=state.accept_count + accept.to(torch.int32),
        divergence_count=state.divergence_count + divergent.to(torch.int32))
    return new_state, accept, q1, p1, log_alpha, divergent
