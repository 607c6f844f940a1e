"""Trajectory visualization: per-substep tracers + side-by-side and overlay
animations (port of ``mcmc_tpu.animations``; the reference's
animations/animation.py + animation_alt.py). The animations need
matplotlib and Pillow, imported when an animation is made."""

from mcmc_tpu_torch.animations.animation import (
    animate_sampler_comparison, grahmc_proposal_trace, hmc_proposal_trace,
    rahmc_proposal_trace,
)
from mcmc_tpu_torch.animations.animation_alt import animate_overlay_comparison

__all__ = [
    "hmc_proposal_trace", "rahmc_proposal_trace", "grahmc_proposal_trace",
    "animate_sampler_comparison", "animate_overlay_comparison",
]
