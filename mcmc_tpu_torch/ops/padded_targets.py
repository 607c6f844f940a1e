"""Plain PyTorch versions of the kernels' target device functions.

Port of the two main-path device functions of ``mcmc_tpu/ops/padded_targets.py``
(``_standard_normal`` and ``_neals_funnel``). The TPU versions work on blocks
padded to the (8, 128) tiles, in a lane or a transposed layout; the CUDA
kernels keep the public (chains, dim) row-major layout and mask lanes past
``dim`` themselves, so none of the padding, ``_mask_row`` or layout code is
ported. What remains is the float32 arithmetic of
``mcmc_tpu_torch/csrc/targets.cuh``, in the same order, on (C, D) tensors.

Families are keyed by the ``kernel_info`` tag the target factories attach;
``FAMILY_IDS`` is the enum the CUDA launcher switches on.
"""

import math
from typing import Callable

import torch

from mcmc_tpu_torch.targets import LOG_2PI

# Must match `enum Family` in csrc/targets.cuh.
FAMILY_IDS = {"standard_normal": 0, "neals_funnel": 1}


def kernel_info(value_and_grad_fn) -> dict:
    """The target's kernel dispatch tag.

    Raises TypeError when the closure carries no tag and KeyError for
    families without a device function (a Python callable cannot be
    compiled into the CUDA kernel)."""
    info = getattr(value_and_grad_fn, "kernel_info", None)
    if info is None:
        raise TypeError(
            "value_and_grad_fn has no kernel_info tag; the fused backend "
            "needs a target built by mcmc_tpu_torch.targets")
    if info["family"] not in _BUILDERS:
        raise KeyError(f"target family {info['family']!r} has no device "
                       f"function yet; ported: {sorted(_BUILDERS)}")
    return info


def make_device_vag(value_and_grad_fn) -> Callable:
    """(C, D) float32 -> (lp (C,), grad (C, D)), the plain version of the
    device function the kernels inline for this target."""
    return device_vag(kernel_info(value_and_grad_fn))


def device_vag(info: dict) -> Callable:
    """make_device_vag from the kernel_info dict itself."""
    return _BUILDERS[info["family"]](info["dim"], info["params"])


def _standard_normal(dim, params):
    const = dim * LOG_2PI

    def vag(q):
        lp = -0.5 * (torch.sum(q * q, dim=1) + const)
        return lp, -q
    return vag


def _neals_funnel(dim, params):
    d_rest = dim - 1
    log_2pi9 = math.log(2.0 * math.pi * 9.0)

    def vag(q):
        x0 = q[:, 0]
        inv_var = torch.exp(-x0)
        rest = q[:, 1:]
        sum_sq = torch.sum(rest * rest, dim=1)
        lp = (-0.5 * (x0 * x0 / 9.0 + log_2pi9)
              - 0.5 * (sum_sq * inv_var + d_rest * x0 + d_rest * LOG_2PI))
        g0 = -x0 / 9.0 + 0.5 * inv_var * sum_sq - 0.5 * d_rest
        grad = torch.cat([g0[:, None], -rest * inv_var[:, None]], dim=1)
        return lp, grad
    return vag


_BUILDERS = {
    "standard_normal": _standard_normal,
    "neals_funnel": _neals_funnel,
}
