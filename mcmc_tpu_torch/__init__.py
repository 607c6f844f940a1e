"""mcmc_tpu_torch — the PyTorch/CUDA port of mcmc_tpu.

The JAX package ``mcmc_tpu`` stays the reference; every module here mirrors
the module of the same name there and is held against it by the
``tests/test_torch_*.py`` parity tests. This first slice carries the GRAHMC
main path: the standard-normal and Neal's-funnel targets, the eager and fused
GRAHMC/HMC samplers, dual averaging and the bulk-ESS / split-R-hat
diagnostics.

PyTorch idiom throughout: plain functions on tensors, an explicit device, and
an explicit ``torch.Generator`` wherever the JAX package takes a PRNG key.
The energy dtype follows the positions (float64 positions give float64
energies); the fused kernels (``mcmc_tpu_torch.ops.fused_trajectory``) are
float32 and run as hand-written CUDA on a GPU, as their plain PyTorch version
on the CPU.

Importing this package never imports ``jax``.
"""

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.targets import TargetDistribution, get_target

__version__ = "0.1.0"

__all__ = ["precision", "TargetDistribution", "get_target"]
