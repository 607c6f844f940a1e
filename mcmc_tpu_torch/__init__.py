"""mcmc_tpu_torch — the PyTorch/CUDA port of mcmc_tpu.

The JAX package ``mcmc_tpu`` stays the reference; every module here mirrors
the module of the same name there and is held against it by the
``tests/test_torch_*.py`` parity tests. The port does what ``mcmc_tpu``
does: the targets with their exact reference samplers, the samplers (RWMH,
HMC, GRAHMC, classic and persistent NUTS, parallel tempering, annealed SMC),
the warmups and tuners (dual averaging, windowed mass-matrix adaptation,
the sequential friction tune, ChEES, the tempering ladder), the
diagnostics, the benchmark runner (``run_benchmarks_torch.py``), the
tune-and-sample CLI (``python -m mcmc_tpu_torch.tuning.core``), the chain
mesh over ``torch.distributed`` (``parallel``), the reference-shaped
``compat`` API, the profiling helpers, the tuning plots and the trajectory
animations. The deliberate deviations are listed in ROADMAP.md.

PyTorch idiom throughout: plain functions on tensors, an explicit device, and
an explicit ``torch.Generator`` wherever the JAX package takes a PRNG key.
The energy dtype follows the positions (float64 positions give float64
energies); the fused kernels (``mcmc_tpu_torch.ops``) are float32 and run
as hand-written CUDA on a GPU, as their plain PyTorch version on the CPU.

Importing this package never imports ``jax``.
"""

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.targets import (TargetDistribution, get_reference_sampler, get_target,
                                    has_reference_sampler)

__version__ = "0.1.0"

__all__ = ["precision", "TargetDistribution", "get_target", "get_reference_sampler",
           "has_reference_sampler"]
