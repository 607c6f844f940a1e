"""Single-trajectory tracers and HMC-vs-GRAHMC animations (port of
``mcmc_tpu/animations/animation.py``).

Feature parity with the reference's animations/animation.py:101-258: trace
one chain's proposal trajectory at substep resolution -- position q,
momentum p, potential U, kinetic K, Hamiltonian H per leapfrog substep --
and render a side-by-side HMC vs GRAHMC animation on a 2D bimodal target.

The tracer is the samplers' conformal leapfrog (the midpoint friction
grid of ``samplers/trajectory.py``) as a plain PyTorch loop that collects
each substep's state. A log-prob without an analytic value_and_grad_fn is
differentiated by autograd (``samplers.base.make_value_and_grad``).
Animations are saved as GIF through the Pillow writer (no ffmpeg), on a
headless backend only where no display or MPLBACKEND is set
(``utils.setup_headless_backend``). Host-side matplotlib: nothing on the
card's path imports this package.
"""

from typing import Dict, Optional

import numpy as np
import torch

from mcmc_tpu_torch.samplers.base import make_value_and_grad
from mcmc_tpu_torch.samplers.grahmc import get_friction_schedule
from mcmc_tpu_torch.samplers.trajectory import as_scalar


def _traced_trajectory(q0, p0, lp0, grad0, value_and_grad, step_size,
                       num_steps, inv_mass, friction_schedule, gamma,
                       steepness):
    """Run one chain's trajectory collecting every substep. q0, p0, grad0:
    (dim,); value_and_grad: (dim,) -> (lp (), grad (dim,)). Returns
    (qs, ps, Us, Ks), (num_steps + 1, dim) and (num_steps + 1,), the start
    included."""
    eps = as_scalar(step_size, q0.dtype, q0.device)
    half = 0.5 * eps
    total_time = eps * num_steps
    q, p, grad = q0, p0, grad0
    qs, ps = [q0], [p0]
    Us = [-torch.as_tensor(lp0, dtype=q0.dtype)]
    Ks = [0.5 * torch.sum(p0 * p0 * inv_mass)]
    for i in range(num_steps):
        if friction_schedule is not None:
            # midpoint friction grid -- parity with samplers/trajectory.py
            gamma_t = friction_schedule((i + 0.5) * eps, total_time, gamma, steepness)
            scale = torch.exp(-gamma_t * half)
            p = p * scale
        p = p + half * grad
        q = q + eps * (p * inv_mass)
        lp, grad = value_and_grad(q)
        p = p + half * grad
        if friction_schedule is not None:
            p = p * scale
        qs.append(q)
        ps.append(p)
        Us.append(-lp)
        Ks.append(0.5 * torch.sum(p * p * inv_mass))
    return torch.stack(qs), torch.stack(ps), torch.stack(Us), torch.stack(Ks)


def _single_chain(value_and_grad):
    """A batched (C, D) -> (lp (C,), grad (C, D)) function as (D,) ->
    (lp (), grad (D,))."""
    def vag1(q):
        lp, grad = value_and_grad(q[None])
        return lp[0], grad[0]
    return vag1


def _proposal_trace(generator, log_prob_fn, q0, step_size, num_steps,
                    value_and_grad_fn=None, inv_mass_matrix=None,
                    friction_schedule=None, gamma=1.0, steepness=1.0) -> Dict:
    q0 = torch.as_tensor(q0)
    if not q0.is_floating_point():
        q0 = q0.to(torch.float64)
    dim = q0.shape[-1]
    vag1 = _single_chain(make_value_and_grad(log_prob_fn, value_and_grad_fn))
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(dim, dtype=q0.dtype, device=q0.device)
    inv_mass_matrix = torch.as_tensor(inv_mass_matrix, dtype=q0.dtype, device=q0.device)

    lp0, grad0 = vag1(q0)
    p0 = torch.randn(dim, generator=generator, dtype=q0.dtype,
                     device=q0.device) / torch.sqrt(inv_mass_matrix)

    qs, ps, Us, Ks = _traced_trajectory(
        q0, p0, lp0, grad0, vag1, step_size, num_steps, inv_mass_matrix,
        friction_schedule, as_scalar(gamma, q0.dtype, q0.device),
        as_scalar(steepness, q0.dtype, q0.device))
    host = [x.detach().cpu().numpy() for x in (qs, ps, Us, Ks)]
    return {
        "positions": host[0],
        "momenta": host[1],
        "potential": host[2],
        "kinetic": host[3],
        "hamiltonian": host[2] + host[3],
        "num_steps": num_steps,
        "step_size": step_size,
    }


def hmc_proposal_trace(generator, log_prob_fn, q0, step_size, num_steps,
                       value_and_grad_fn=None, inv_mass_matrix=None) -> Dict:
    """Per-substep (q, p, U, K, H) for one HMC proposal from q0 (dim,); the
    momentum drawn from `generator` (on q0's device)."""
    return _proposal_trace(generator, log_prob_fn, q0, step_size, num_steps,
                           value_and_grad_fn, inv_mass_matrix,
                           friction_schedule=None)


def rahmc_proposal_trace(generator, log_prob_fn, q0, step_size, num_steps,
                         gamma=1.0, steepness=1.0, schedule_type="constant",
                         value_and_grad_fn=None, inv_mass_matrix=None) -> Dict:
    """Per-substep (q, p, U, K, H) for one GRAHMC proposal from q0 (dim,)."""
    return _proposal_trace(generator, log_prob_fn, q0, step_size, num_steps,
                           value_and_grad_fn, inv_mass_matrix,
                           friction_schedule=get_friction_schedule(schedule_type),
                           gamma=gamma, steepness=steepness)


grahmc_proposal_trace = rahmc_proposal_trace


def animate_sampler_comparison(
    generator: Optional[torch.Generator] = None,
    separation: float = 5.0,
    step_size: float = 0.15,
    num_steps: int = 40,
    gamma: float = 1.0,
    n_proposals: int = 12,
    schedule_type: str = "constant",
    output_file: str = "hmc_vs_grahmc.gif",
    fps: int = 12,
) -> str:
    """Side-by-side HMC vs GRAHMC trajectory animation on a 2D bimodal target.

    Renders each sampler's substep path over the target density contours (the
    reference's FuncAnimation layout, animation.py:240-252) and saves a GIF.
    The traces run in float64 on the CPU, their momenta from `generator`
    (a CPU generator; default seed 0). Returns the output path.
    """
    from mcmc_tpu_torch.utils import setup_headless_backend
    setup_headless_backend()
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    from mcmc_tpu_torch.targets import gaussian_mixture

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    target = gaussian_mixture(dim=2, separation=separation)

    # Collect trajectories: evolve both samplers from the same start.
    traces = {"HMC": [], f"GRAHMC ({schedule_type})": []}
    q_h = torch.tensor([-separation / 2.0, 0.0], dtype=torch.float64)
    q_g = q_h
    for _ in range(n_proposals):
        tr_h = hmc_proposal_trace(generator, target.log_prob_fn, q_h, step_size,
                                  num_steps, target.value_and_grad_fn)
        tr_g = rahmc_proposal_trace(generator, target.log_prob_fn, q_g, step_size,
                                    num_steps, gamma=gamma,
                                    schedule_type=schedule_type,
                                    value_and_grad_fn=target.value_and_grad_fn)
        traces["HMC"].append(tr_h)
        traces[f"GRAHMC ({schedule_type})"].append(tr_g)
        q_h = torch.from_numpy(tr_h["positions"][-1])
        q_g = torch.from_numpy(tr_g["positions"][-1])

    # Density contours
    grid = np.linspace(-separation, separation, 120)
    X, Y = np.meshgrid(grid, grid)
    pts = torch.from_numpy(np.stack([X.ravel(), Y.ravel()], axis=-1))
    Z = target.log_prob_fn(pts).numpy().reshape(X.shape)

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    artists = []
    for ax, name in zip(axes, traces):
        ax.contour(X, Y, np.exp(Z), levels=8, cmap="Greys", alpha=0.6)
        line, = ax.plot([], [], "-", lw=1.2, color="tab:red", alpha=0.8)
        dot, = ax.plot([], [], "o", color="tab:blue", markersize=6)
        ax.set_title(name)
        ax.set_xlim(-separation, separation)
        ax.set_ylim(-separation, separation)
        artists.append((line, dot, name))

    frames_per_prop = num_steps + 1
    total_frames = n_proposals * frames_per_prop

    def update(frame):
        prop_idx = frame // frames_per_prop
        sub_idx = frame % frames_per_prop
        out = []
        for line, dot, name in artists:
            tr = traces[name][prop_idx]
            xs = tr["positions"][: sub_idx + 1, 0]
            ys = tr["positions"][: sub_idx + 1, 1]
            line.set_data(xs, ys)
            dot.set_data(xs[-1:], ys[-1:])
            out.extend([line, dot])
        return out

    anim = FuncAnimation(fig, update, frames=total_frames, blit=True)
    anim.save(output_file, writer=PillowWriter(fps=fps))
    plt.close(fig)
    print(f"  saved {output_file}")
    return output_file
