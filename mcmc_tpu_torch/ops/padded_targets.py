"""Plain PyTorch versions of the kernels' target device functions.

Port of four device functions of ``mcmc_tpu/ops/padded_targets.py``
(``_standard_normal``, ``_neals_funnel``, ``_correlated`` and
``_gaussian_mixture``). The TPU versions work on blocks
padded to the (8, 128) tiles, in a lane or a transposed layout; the CUDA
kernels keep the public (chains, dim) row-major layout and mask lanes past
``dim`` themselves, so none of the padding, ``_mask_row`` or layout code is
ported. What remains is the float32 arithmetic of
``mcmc_tpu_torch/csrc/targets.cuh``, in the same order, on (C, D) tensors.

Families are keyed by the ``kernel_info`` tag the target factories attach;
``FAMILY_IDS`` is the enum the CUDA launchers switch on, and
``KERNEL_FAMILIES`` the families each kernel's launcher dispatches on.
"""

import math
from typing import Callable, Optional

import torch

from mcmc_tpu_torch.targets import LOG_2PI

# Must match `enum Family` in csrc/targets.cuh.
FAMILY_IDS = {"standard_normal": 0, "neals_funnel": 1, "correlated_gaussian": 2,
              "gaussian_mixture": 3}
# The families each kernel's launcher dispatches on. The correlated Gaussian's
# functor masks coordinates in the warp-per-chain layout; kernels 1, 2 and 4
# run it. The mixture runs in kernels 1 and 2 (and 1's scaled and bridged
# variants) only so far.
KERNEL_FAMILIES = {
    "grahmc": ("standard_normal", "neals_funnel", "correlated_gaussian",
               "gaussian_mixture"),
    "rwmh": ("standard_normal", "neals_funnel"),
    "nuts": ("standard_normal", "neals_funnel", "correlated_gaussian"),
}


def kernel_info(value_and_grad_fn, kernel: Optional[str] = None) -> dict:
    """The target's kernel dispatch tag.

    Raises TypeError when the closure carries no tag and KeyError for
    families without a device function (a Python callable cannot be
    compiled into the CUDA kernel), or, with `kernel` (a KERNEL_FAMILIES
    key), for families that kernel does not dispatch on."""
    info = getattr(value_and_grad_fn, "kernel_info", None)
    if info is None:
        raise TypeError(
            "value_and_grad_fn has no kernel_info tag; the fused backend "
            "needs a target built by mcmc_tpu_torch.targets")
    families = _BUILDERS if kernel is None else KERNEL_FAMILIES[kernel]
    if info["family"] not in families:
        where = "" if kernel is None else f" in the {kernel} kernel"
        raise KeyError(f"target family {info['family']!r} has no device "
                       f"function{where} yet; ported: {sorted(families)}")
    return info


def make_device_vag(value_and_grad_fn) -> Callable:
    """(C, D) float32 -> (lp (C,), grad (C, D)), the plain version of the
    device function the kernels inline for this target."""
    return device_vag(kernel_info(value_and_grad_fn))


def device_vag(info: dict) -> Callable:
    """make_device_vag from the kernel_info dict itself."""
    return _BUILDERS[info["family"]](info["dim"], info["params"])


def device_params(info: dict) -> tuple:
    """The four floats of `struct TargetParams` (csrc/targets.cuh) for this
    target, computed in double as the plain version computes them: (a, b,
    log|Sigma| + D log 2pi, 0) for the correlated Gaussian, (sep / 2, 0, 0,
    0) for the mixture, zeros for the families without parameters."""
    p = info["params"]
    if info["family"] == "correlated_gaussian":
        return (p["a"], p["b"], p["log_det_cov"] + info["dim"] * LOG_2PI, 0.0)
    if info["family"] == "gaussian_mixture":
        return (p["separation"] / 2.0, 0.0, 0.0, 0.0)
    return (0.0, 0.0, 0.0, 0.0)


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


def warp_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x (C, D) in the order of csrc/targets.cuh's warp_sum over
    the warp-per-chain layout: lane j adds its coordinates j, j + 32, ... in
    turn, then a butterfly over the 32 lanes (offsets 16, 8, 4, 2, 1)."""
    n_chains, dim = x.shape
    k = -(-dim // 32)
    lanes = torch.zeros((n_chains, 32 * k), dtype=x.dtype, device=x.device)
    lanes[:, :dim] = x
    lanes = lanes.reshape(n_chains, k, 32)
    v = lanes[:, 0]
    for r in range(1, k):
        v = v + lanes[:, r]
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    return v[:, 0]


def _correlated(dim, params):
    a, b = params["a"], params["b"]
    const = params["log_det_cov"] + dim * LOG_2PI

    def vag(q):
        # the kernel's summation order: see csrc/targets.cuh
        s = warp_order_sum(q)[:, None]
        siv = a * q + b * s
        lp = -0.5 * (warp_order_sum(siv * q) + const)
        return lp, -siv
    return vag


def _gaussian_mixture(dim, params):
    half_sep = params["separation"] / 2.0
    c_rest = (dim - 1) * LOG_2PI

    def vag(q):
        x0 = q[:, 0]
        a = x0 + half_sep
        b = x0 - half_sep
        m1 = -0.5 * (a * a)
        m2 = -0.5 * (b * b)
        mx = torch.maximum(m1, m2)
        e1 = torch.exp(m1 - mx)
        e2 = torch.exp(m2 - mx)
        lse = e1 + e2
        log_p_x0 = math.log(0.5) + mx + torch.log(lse) - 0.5 * LOG_2PI
        rest = q[:, 1:]
        lp = log_p_x0 - 0.5 * (torch.sum(rest * rest, dim=1) + c_rest)
        g0 = -(a * e1 + b * e2) / lse
        return lp, torch.cat([g0[:, None], -rest], dim=1)
    return vag


_BUILDERS = {
    "standard_normal": _standard_normal,
    "neals_funnel": _neals_funnel,
    "correlated_gaussian": _correlated,
    "gaussian_mixture": _gaussian_mixture,
}
