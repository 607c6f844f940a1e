"""Fused CUDA kernels (built from ``mcmc_tpu_torch/csrc`` at first use) and
their plain PyTorch versions."""
