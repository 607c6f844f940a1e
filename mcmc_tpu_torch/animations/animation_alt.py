"""Alternate single-axes overlay animation (port of
``mcmc_tpu/animations/animation_alt.py``; the reference's
animations/animation_alt.py).

Feature parity with the reference's second animation module
(animation_alt.py:299-385): instead of the side-by-side layout in
`animation.py`, ONE axes overlays an HMC trajectory (trapped in the starting
mode) and a GRAHMC/RAHMC trajectory whose repel phase (gamma < 0, first half,
energy added) and attract phase (gamma > 0, second half, energy removed) are
drawn as two differently-colored growing segments, with the phase named in the
animated title and a start-position marker.

Trajectories come from the samplers' conformal leapfrog tracers
(`hmc_proposal_trace` / `rahmc_proposal_trace`), in float64 on the CPU.
Saved through the Pillow GIF writer by default (no ffmpeg); pass an .mp4
filename to use ffmpeg like the reference.
"""

from typing import Optional

import numpy as np
import torch

from mcmc_tpu_torch.animations.animation import hmc_proposal_trace, rahmc_proposal_trace
from mcmc_tpu_torch.targets import gaussian_mixture

# Reference animation_alt.py palette (:330-337)
COLOR_HMC = "#6b8e23"
COLOR_REPEL = "#d4a574"
COLOR_ATTRACT = "#5f9ea0"
COLOR_START = "#8b4545"


def animate_overlay_comparison(
    generator: Optional[torch.Generator] = None,
    separation: float = 5.0,
    step_size: float = 0.15,
    num_steps: int = 40,
    gamma: float = 1.2,
    output_path: Optional[str] = None,
    fps: int = 12,
):
    """HMC-vs-RAHMC overlay on one 2D bimodal contour plot, the momenta
    drawn from `generator` (a CPU generator; default seed 0).

    Returns (fig, anim); saves to output_path when given (.gif via Pillow,
    .mp4 via ffmpeg, matching the reference's writer choice).
    """
    from mcmc_tpu_torch.utils import setup_headless_backend
    setup_headless_backend()
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    target = gaussian_mixture(dim=2, separation=separation)
    q0 = torch.tensor([-separation / 2.0, 0.0], dtype=torch.float64)

    tr_hmc = hmc_proposal_trace(generator, target.log_prob_fn, q0, step_size,
                                num_steps,
                                value_and_grad_fn=target.value_and_grad_fn)
    tr_ra = rahmc_proposal_trace(generator, target.log_prob_fn, q0, step_size,
                                 num_steps, gamma=gamma,
                                 schedule_type="constant",
                                 value_and_grad_fn=target.value_and_grad_fn)
    qs_hmc = tr_hmc["positions"]
    qs_ra = tr_ra["positions"]
    split_idx = num_steps // 2     # constant schedule flips gamma at T/2

    fig, ax = plt.subplots(figsize=(9, 7), facecolor="white")
    lim = separation / 2.0 + 3.0
    xs = np.linspace(-lim, lim, 160)
    ys = np.linspace(-lim, lim, 160)
    X, Y = np.meshgrid(xs, ys)
    grid = torch.from_numpy(np.stack([X.ravel(), Y.ravel()], axis=-1))
    U = -target.log_prob_fn(grid).numpy().reshape(X.shape)
    ax.contourf(X, Y, U, levels=30, cmap="Greys_r", alpha=0.75)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_xlabel("$q_1$")
    ax.set_ylabel("$q_2$")

    (line_hmc,) = ax.plot([], [], color=COLOR_HMC, lw=2.0)
    (line_repel,) = ax.plot([], [], color=COLOR_REPEL, lw=2.2)
    (line_attract,) = ax.plot([], [], color=COLOR_ATTRACT, lw=2.2)
    (dot_hmc,) = ax.plot([], [], "o", color=COLOR_HMC, ms=8)
    (dot_ra,) = ax.plot([], [], "o", color=COLOR_REPEL, ms=8)
    ax.plot([float(q0[0])], [float(q0[1])], "*", color=COLOR_START, ms=16,
            zorder=5)
    title_text = ax.set_title("")

    legend_patches = [
        mpatches.Patch(color=COLOR_HMC, label="HMC ($\\gamma=0$) - Trapped"),
        mpatches.Patch(color=COLOR_REPEL,
                       label=f"RAHMC ($\\gamma=-{gamma}$) - Repel"),
        mpatches.Patch(color=COLOR_ATTRACT,
                       label=f"RAHMC ($\\gamma=+{gamma}$) - Attract"),
        mpatches.Patch(color=COLOR_START, label="Starting Position"),
    ]
    ax.legend(handles=legend_patches, loc="upper left", fontsize=9,
              framealpha=0.95, edgecolor="gray", fancybox=True)

    def animate(frame):
        line_hmc.set_data(qs_hmc[:frame + 1, 0], qs_hmc[:frame + 1, 1])
        dot_hmc.set_data([qs_hmc[frame, 0]], [qs_hmc[frame, 1]])
        if frame <= split_idx:
            # repel phase: repel line grows, attract line hidden
            line_repel.set_data(qs_ra[:frame + 1, 0], qs_ra[:frame + 1, 1])
            line_attract.set_data([], [])
            dot_ra.set_color(COLOR_REPEL)
            phase = "REPEL ($\\gamma < 0$, Adding Energy)"
        else:
            # attract phase: repel line frozen, attract line grows from split
            line_repel.set_data(qs_ra[:split_idx + 1, 0],
                                qs_ra[:split_idx + 1, 1])
            line_attract.set_data(qs_ra[split_idx:frame + 1, 0],
                                  qs_ra[split_idx:frame + 1, 1])
            dot_ra.set_color(COLOR_ATTRACT)
            phase = "ATTRACT ($\\gamma > 0$, Removing Energy)"
        dot_ra.set_data([qs_ra[frame, 0]], [qs_ra[frame, 1]])
        title_text.set_text(f"Step {frame} / {num_steps}  |  "
                            f"RAHMC Phase: {phase}")
        return line_hmc, line_repel, line_attract, dot_hmc, dot_ra, title_text

    anim = FuncAnimation(fig, animate, frames=len(qs_ra), interval=80,
                         blit=False)
    if output_path is not None:
        if output_path.endswith(".mp4"):
            anim.save(output_path, writer="ffmpeg", fps=fps)
        else:
            anim.save(output_path, writer="pillow", fps=fps)
        plt.close(fig)
    return fig, anim
