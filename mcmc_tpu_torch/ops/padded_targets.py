"""Plain PyTorch versions of the kernels' target device functions.

Port of the 14 device functions of ``mcmc_tpu/ops/padded_targets.py``
(``_BUILDERS``: ``_standard_normal``, ``_neals_funnel``,
``_neals_funnel_noncentered``, ``_ill_conditioned``, ``_student_t``,
``_log_gamma``, ``_log_gamma_unconstrained``, ``_correlated``,
``_gaussian_mixture``, ``_hierarchical_logistic``, ``_rosenbrock``,
``_multimodal_funnel_2d``, ``_concentric_l1`` and ``_nested_l1``). The TPU
versions work on blocks
padded to the (8, 128) tiles, in a lane or a transposed layout; the CUDA
kernels keep the public (chains, dim) row-major layout and mask lanes past
``dim`` themselves, so none of the padding, ``_mask_row`` or layout code is
ported. What remains is the float32 arithmetic of
``mcmc_tpu_torch/csrc/targets.cuh``, in the same order, on (C, D) tensors.

Families are keyed by the ``kernel_info`` tag the target factories attach;
``FAMILY_IDS`` is the enum the CUDA launchers switch on, and
``KERNEL_FAMILIES`` the families each kernel's launcher dispatches on. A
family of ``DATA_FAMILIES`` carries a data set, which ``device_data`` puts
on the device once and the kernels read from there (``struct TargetData``).
"""

import math
from typing import Callable, Optional

import torch

from mcmc_tpu_torch.targets import LOG_2PI, gamma_log_norm, student_t_log_norm

# Must match `enum Family` in csrc/targets.cuh.
FAMILY_IDS = {"standard_normal": 0, "neals_funnel": 1, "correlated_gaussian": 2,
              "gaussian_mixture": 3, "hierarchical_logistic": 4,
              "neals_funnel_noncentered": 5, "ill_conditioned_gaussian": 6,
              "student_t": 7, "log_gamma": 8, "log_gamma_unconstrained": 9,
              "rosenbrock": 10, "multimodal_funnel_2d": 11, "concentric_l1_balls": 12,
              "nested_l1_balls": 13}
# The families each kernel's launcher dispatches on: every ported family in
# every kernel (kernel 3 runs a family's log-density in its lane groups; the
# hierarchical posterior through its log-density-only form). The launchers
# instantiate exactly these pairs.
_ALL_FAMILIES = tuple(FAMILY_IDS)
KERNEL_FAMILIES = {"grahmc": _ALL_FAMILIES, "rwmh": _ALL_FAMILIES, "nuts": _ALL_FAMILIES}
# Families whose plain device function sums in the kernels' lane order in
# both layouts (warp_order_sum), so kernel 3's log-density takes its own
# lane-group order (device_lp).
LANE_ORDER_FAMILIES = ("correlated_gaussian", "neals_funnel_noncentered",
                       "ill_conditioned_gaussian", "student_t", "log_gamma",
                       "log_gamma_unconstrained", "rosenbrock", "concentric_l1_balls",
                       "nested_l1_balls")
# The L1 families carry their shells' radii in `struct TargetParams`
# (csrc/targets.cuh), at most MAX_SHELLS of them; a target with more is
# refused (device_shells), never truncated.
L1_FAMILIES = ("concentric_l1_balls", "nested_l1_balls")
MAX_SHELLS = 8
# Floats of TargetParams.v.
N_PARAMS = 8
# Families whose device function reads a data set from device memory.
DATA_FAMILIES = ("hierarchical_logistic",)
# Kernel 3 gives a chain 2^ceil(log2(ceil(D / 4))) lanes, lane j holding
# coordinates 4j..4j+3 (csrc/fused_rwmh.cu).
RWMH_COORDS_PER_LANE = 4


def kernel_info(value_and_grad_fn, kernel: Optional[str] = None) -> dict:
    """The target's kernel dispatch tag.

    Raises TypeError when the closure carries no tag and KeyError for
    families without a device function (a Python callable cannot be
    compiled into the CUDA kernel), or, with `kernel` (a KERNEL_FAMILIES
    key), for families that kernel does not dispatch on; ValueError for an
    L1 target with more shells than the kernels carry (device_shells)."""
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
    device_shells(info)
    return info


def fusable(kernel: str, value_and_grad_fn, device) -> bool:
    """Whether `kernel`'s (a KERNEL_FAMILIES key) CUDA launcher takes this
    target on this device: CUDA, a tagged family it dispatches on, and D
    within the kernels' cap (fused_trajectory.MAX_DIM). Every "auto"
    backend asks this; an explicit "fused" skips it and raises instead."""
    from mcmc_tpu_torch.ops.fused_trajectory import MAX_DIM
    info = getattr(value_and_grad_fn, "kernel_info", None)
    return (torch.device(device).type == "cuda" and info is not None
            and info["family"] in KERNEL_FAMILIES[kernel] and info["dim"] <= MAX_DIM)


def make_device_vag(value_and_grad_fn) -> Callable:
    """(C, D) float32 -> (lp (C,), grad (C, D)), the plain version of the
    device function the kernels inline for this target."""
    return device_vag(kernel_info(value_and_grad_fn))


def device_vag(info: dict) -> Callable:
    """make_device_vag from the kernel_info dict itself."""
    return _BUILDERS[info["family"]](info["dim"], info["params"])


def device_lp(info: dict) -> Callable:
    """(C, D) float32 -> lp (C,), the plain version of what kernel 3 (RWMH)
    evaluates for this target: the log-density only, summed in kernel 3's
    lane-group order where the family's device function has its own
    log-density form (the hierarchical posterior), else the device
    function's lp."""
    if info["family"] == "hierarchical_logistic":
        return _hierarchical_logistic(info["dim"], info["params"], rwmh_lanes(info["dim"]))
    if info["family"] in LANE_ORDER_FAMILIES:
        vag = _BUILDERS[info["family"]](info["dim"], info["params"], rwmh_lanes(info["dim"]))
        return lambda q: vag(q)[0]
    vag = device_vag(info)
    return lambda q: vag(q)[0]


def rwmh_lanes(dim: int) -> int:
    """Lanes per chain in kernel 3: the power of two that holds dim
    coordinates at RWMH_COORDS_PER_LANE per lane (csrc/fused_rwmh.cu:
    dispatch_g)."""
    lanes = -(-dim // RWMH_COORDS_PER_LANE)
    return min(32, 1 << max(0, (lanes - 1).bit_length()))


_DEVICE_DATA = {}    # (dim, n_data, data_seed, device) -> (X, xt, y)


def device_data(info: dict, device) -> tuple:
    """The data set of a DATA_FAMILIES target on `device`, as the kernels
    read it: X (n_data, D) float32 with a zero column 0 (the hyperparameter
    tau's, so X q picks out the coefficients and the likelihood's share of
    tau's gradient is 0), its transpose xt (D, n_data) and y (n_data,), all
    contiguous. Made once per data set and device: the factory makes the
    data from (dim, n_data, data_seed) alone."""
    p = info["params"]
    key = (info["dim"], p["n_data"], p["data_seed"], str(torch.device(device)))
    if key not in _DEVICE_DATA:
        X = torch.zeros((p["n_data"], info["dim"]), dtype=torch.float32)
        X[:, 1:] = torch.from_numpy(p["X"])
        _DEVICE_DATA[key] = tuple(t.contiguous().to(device) for t in (
            X, X.T, torch.from_numpy(p["y"]).to(torch.float32)))
    return _DEVICE_DATA[key]


def device_params(info: dict) -> tuple:
    """The leading floats of `struct TargetParams`'s v (csrc/targets.cuh)
    for this target, computed in double as the plain version computes them
    and rounded once (the rest of v is 0): (a, b, log|Sigma| + D log 2pi, 0)
    for the correlated Gaussian, (sep / 2, 0, 0, 0) for the mixture, (log 9
    + D log 2pi, 0, 0, 0) for the non-centered funnel, (slope (kappa - 1) /
    (D - 1), log|Sigma| + D log 2pi, 0, 0) for the ill-conditioned Gaussian,
    (df, (df + 1) / 2, D log_norm, -(df + 1)) for Student-t, (shape - 1,
    rate, log Z, 0) for log-gamma and (shape, rate, D log Z, 0) for its
    unconstrained form (log Z = gammaln(shape) + shape log(rate)), (a, 2 a,
    4 a, 0) with a = 1 / scale^2 for Rosenbrock, (mu, sigma^2, c, log(1/2)
    - log(2 pi sigma^2) / 2, log(2 pi c)) for the bimodal funnel, (sigma^2,
    0, 0, 0) for the concentric and (sigma^2, mu_norm, 0, 0) for the nested
    L1 shells (their radii: device_shells), zeros for the families without
    parameters."""
    p, dim, family = info["params"], info["dim"], info["family"]
    if family == "correlated_gaussian":
        return (p["a"], p["b"], p["log_det_cov"] + dim * LOG_2PI, 0.0)
    if family == "gaussian_mixture":
        return (p["separation"] / 2.0, 0.0, 0.0, 0.0)
    if family == "neals_funnel_noncentered":
        return (math.log(9.0) + dim * LOG_2PI, 0.0, 0.0, 0.0)
    if family == "ill_conditioned_gaussian":
        kappa = p["condition_number"]
        log_det = sum(math.log(1.0 + (kappa - 1.0) * i / max(dim - 1, 1)) for i in range(dim))
        return ((kappa - 1.0) / max(dim - 1, 1), log_det + dim * LOG_2PI, 0.0, 0.0)
    if family == "student_t":
        df = p["df"]
        return (df, (df + 1.0) / 2.0, dim * student_t_log_norm(df), -(df + 1.0))
    if family == "log_gamma":
        return (p["shape"] - 1.0, p["rate"], gamma_log_norm(p["shape"], p["rate"]), 0.0)
    if family == "log_gamma_unconstrained":
        return (p["shape"], p["rate"], dim * gamma_log_norm(p["shape"], p["rate"]), 0.0)
    if family == "rosenbrock":
        a = 1.0 / (p["scale"] ** 2)
        return (a, 2.0 * a, 4.0 * a, 0.0)
    if family == "multimodal_funnel_2d":
        sig2 = p["sigma"] * p["sigma"]
        return (p["mu"], sig2, p["c"], math.log(0.5) - 0.5 * math.log(2.0 * math.pi * sig2),
                math.log(2.0 * math.pi * p["c"]))
    if family == "concentric_l1_balls":
        return (p["sigma"] ** 2, 0.0, 0.0, 0.0)
    if family == "nested_l1_balls":
        return (p["sigma"] ** 2, p["mu_norm"], 0.0, 0.0)
    return (0.0, 0.0, 0.0, 0.0)


def device_shells(info: dict) -> tuple:
    """The shell radii of an L1 family in `struct TargetParams`'s shell
    array: the concentric target's radii, the nested one's r_outer then
    r_inner n_inner times; () for the other families. Raises ValueError for
    more than MAX_SHELLS shells, the kernels' cap: a target is never
    truncated and never run eagerly in the kernel's place."""
    p, family = info["params"], info["family"]
    if family == "concentric_l1_balls":
        shells = tuple(float(r) for r in p["radii"])
    elif family == "nested_l1_balls":
        shells = (float(p["r_outer"]),) + (float(p["r_inner"]),) * int(p["n_inner"])
    else:
        return ()
    if not 1 <= len(shells) <= MAX_SHELLS:
        raise ValueError(f"{family} has {len(shells)} L1 shells; the CUDA kernels carry "
                         f"1 to MAX_SHELLS = {MAX_SHELLS} (csrc/targets.cuh)")
    return shells


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


def warp_order_sum(x: torch.Tensor, lanes: int = 32, blocked: int = 0) -> torch.Tensor:
    """Row sums of x (C, N) in the order of csrc/targets.cuh's group_sum
    over a group of `lanes` lanes: lane j adds its entries in turn, then a
    butterfly over the lanes (offsets lanes / 2, ..., 2, 1). Lane j holds
    entries j, j + lanes, ... (the warp-per-chain layout at lanes = 32, and
    the data rows a lane owns), or with `blocked` = b entries b j .. b j +
    b - 1 (kernel 3's layout)."""
    n_chains, n = x.shape
    per_lane = blocked or -(-n // lanes)
    padded = torch.zeros((n_chains, lanes * per_lane), dtype=x.dtype, device=x.device)
    padded[:, :n] = x
    if blocked:
        padded = padded.reshape(n_chains, lanes, per_lane).transpose(1, 2)
    else:
        padded = padded.reshape(n_chains, per_lane, lanes)
    v = padded[:, 0]
    for r in range(1, per_lane):
        v = v + padded[:, r]
    idx = torch.arange(lanes, device=x.device)
    off = lanes // 2
    while off:
        v = v + v[:, idx ^ off]
        off //= 2
    return v[:, 0]


def _order(group):
    """warp_order_sum's (lanes, blocked) for a layout: the warp-per-chain
    one of kernels 1, 2 and 4 (group None), or kernel 3's lane groups of
    `group` lanes holding RWMH_COORDS_PER_LANE coordinates each."""
    return (group, RWMH_COORDS_PER_LANE) if group else (32, 0)


def _correlated(dim, params, group=None):
    a, b = params["a"], params["b"]
    const = params["log_det_cov"] + dim * LOG_2PI
    order = _order(group)

    def vag(q):
        # the kernel's summation order: see csrc/targets.cuh
        s = warp_order_sum(q, *order)[:, None]
        siv = a * q + b * s
        lp = -0.5 * (warp_order_sum(siv * q, *order) + const)
        return lp, -siv
    return vag


# The five families below sum in the kernels' lane order in either layout
# (`group`, as _correlated's) and round each product before its sum in the
# functors' order (csrc/targets.cuh), so a kernel and its plain version
# differ only where the leapfrog itself contracts to FMA.

def _neals_funnel_noncentered(dim, params, group=None):
    """N(0, diag(9, 1, ..., 1)): the funnel's curvature lives in
    funnel_transform, not in the sampled density."""
    const = math.log(9.0) + dim * LOG_2PI
    order = _order(group)

    def vag(q):
        inv_var = torch.ones(dim, dtype=q.dtype, device=q.device)
        inv_var[0] = 1.0 / 9.0
        siv = q * inv_var
        return -0.5 * (warp_order_sum(siv * q, *order) + const), -siv
    return vag


def _ill_conditioned(dim, params, group=None):
    """N(0, diag(linspace(1, kappa, D))): eig_i = 1 + slope i in float32
    from the integer i, as the TPU kernel rebuilds it."""
    slope, const = device_params({"family": "ill_conditioned_gaussian", "dim": dim,
                                  "params": params})[:2]
    order = _order(group)

    def vag(q):
        ids = torch.arange(dim, dtype=q.dtype, device=q.device)
        inv_eig = 1.0 / (1.0 + ids * slope)
        siv = q * inv_eig
        return -0.5 * (warp_order_sum(siv * q, *order) + const), -siv
    return vag


def _student_t(dim, params, group=None):
    df, half_df1, const, neg_df1 = device_params({"family": "student_t", "dim": dim,
                                                  "params": params})
    order = _order(group)

    def vag(q):
        x2 = q * q
        lp = const - half_df1 * warp_order_sum(torch.log1p(x2 / df), *order)
        return lp, (neg_df1 * q) / (df + x2)
    return vag


def _log_gamma(dim, params, group=None):
    """Gamma(shape, rate) per coordinate: lp -inf and gradient 0 when any
    coordinate is <= 0 (the clamp at 1e-10 keeps the log finite)."""
    sm1, rate, log_norm = device_params({"family": "log_gamma", "dim": dim,
                                         "params": params})[:3]
    eps = 1e-10
    order = _order(group)

    def vag(q):
        valid = torch.all(q > 0, dim=1)
        qc = torch.clamp(q, min=eps)
        terms = sm1 * torch.log(qc) - rate * q - log_norm
        lp = torch.where(valid, warp_order_sum(terms, *order),
                         torch.full_like(q[:, 0], -math.inf))
        g = sm1 * torch.where(q > eps, 1.0 / qc, torch.zeros_like(q)) - rate
        return lp, torch.where(valid[:, None], g, torch.zeros_like(g))
    return vag


def _log_gamma_unconstrained(dim, params, group=None):
    """expGamma, log-gamma's log-transformed form: lp = sum(shape y - rate
    e^y) - D log Z, grad = shape - rate e^y."""
    shape, rate, const = device_params({"family": "log_gamma_unconstrained", "dim": dim,
                                        "params": params})[:3]
    order = _order(group)

    def vag(q):
        ey = torch.exp(q)
        return (warp_order_sum(shape * q - rate * ey, *order) - const,
                shape - rate * ey)
    return vag


def _rosenbrock(dim, params, group=None):
    """-sum_{i < D-1} [(1 - q_i)^2 + a r_i^2], r_i = q_{i+1} - q_i^2, with
    the forward term -2 (1 - q_i) - 4 a q_i r_i and the backward term
    2 a r_{i-1} of the gradient; the pairs past dim - 1 masked to 0."""
    a, a2, a4 = device_params({"family": "rosenbrock", "dim": dim, "params": params})[:3]
    order = _order(group)

    def vag(q):
        pair = torch.arange(dim, device=q.device) < dim - 1
        zero = torch.zeros_like(q[:, :1])
        resid = torch.where(pair, torch.cat([q[:, 1:], zero], dim=1) - q * q, 0.0)
        om = 1.0 - q
        term = torch.where(pair, om * om + (a * resid) * resid, 0.0)
        fwd = torch.where(pair, -2.0 * om - (a4 * q) * resid, 0.0)
        bwd = torch.cat([zero, (a2 * resid)[:, :-1]], dim=1)
        return -warp_order_sum(term, *order), -(fwd + bwd)
    return vag


def _multimodal_funnel_2d(dim, params, group=None):
    """v ~ (N(mu, s^2) + N(-mu, s^2)) / 2, x | v ~ N(0, c e^v) on
    coordinates 0 and 1; no sum, so both layouts are one formula."""
    mu, sig2, c, log_norm_prior, log_2pi_c = device_params(
        {"family": "multimodal_funnel_2d", "dim": dim, "params": params})

    def vag(q):
        v, x = q[:, 0], q[:, 1]
        dm, dp = v - mu, v + mu
        a1 = (-0.5 * (dm * dm)) / sig2
        a2 = (-0.5 * (dp * dp)) / sig2
        mx = torch.maximum(a1, a2)
        e1, e2 = torch.exp(a1 - mx), torch.exp(a2 - mx)
        lse = e1 + e2
        log_prior = (log_norm_prior + mx) + torch.log(lse)
        inv_var = torch.exp(-v) / c
        log_cond = -0.5 * (((x * x) * inv_var + v) + log_2pi_c)
        w1, w2 = e1 / lse, e2 / lse
        gv = (-(w1 * dm + w2 * dp)) / sig2 + ((0.5 * x) * x) * inv_var - 0.5
        grad = torch.zeros_like(q)
        grad[:, 0] = gv
        grad[:, 1] = (-x) * inv_var
        return log_prior + log_cond, grad
    return vag


def _sign(x):
    """jnp.sign: 0 at 0."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def _shell_logsumexp(us, radii, sig2):
    """The shells' log-weights -(u_k - r_k)^2 / (2 s^2) and their
    logsumexp, unrolled in the JAX builder's order (the max, the exps, their
    sum): (lp, exps, lse, slopes -(u_k - r_k) / s^2)."""
    terms = [(-0.5 * ((u - r) * (u - r))) / sig2 for u, r in zip(us, radii)]
    mx = terms[0]
    for t in terms[1:]:
        mx = torch.maximum(mx, t)
    exps = [torch.exp(t - mx) for t in terms]
    lse = exps[0]
    for e in exps[1:]:
        lse = lse + e
    slopes = [(-(u - r)) / sig2 for u, r in zip(us, radii)]
    return mx + torch.log(lse), exps, lse, slopes


def _concentric_l1(dim, params, group=None):
    """p ∝ sum_k exp(-(|q|_1 - r_k)^2 / (2 s^2)): one sum for u = |q|_1,
    grad = (sum_k e_k slope_k) / lse * sign(q)."""
    info = {"family": "concentric_l1_balls", "dim": dim, "params": params}
    sig2 = device_params(info)[0]
    radii = device_shells(info)
    order = _order(group)

    def vag(q):
        u = warp_order_sum(torch.abs(q), *order)
        lp, exps, lse, slopes = _shell_logsumexp([u] * len(radii), radii, sig2)
        du = exps[0] * slopes[0]
        for e, sl in zip(exps[1:], slopes[1:]):
            du = du + e * sl
        return lp, (du / lse)[:, None] * _sign(q)
    return vag


def _nested_l1(dim, params, group=None):
    """An outer L1 shell about the origin and n_inner about the axis points
    c_k (k >= 1: +-mu_norm on axis (k - 1) // 2 % dim, + for odd k): one
    sum u_k = |q - c_k|_1 per shell, grad = sum_k e_k slope_k sign(q - c_k)
    / lse."""
    info = {"family": "nested_l1_balls", "dim": dim, "params": params}
    sig2, mu_norm = device_params(info)[:2]
    radii = device_shells(info)
    order = _order(group)

    def vag(q):
        diffs = [q]
        for k in range(1, len(radii)):
            d = q.clone()
            axis = (k - 1) // 2 % dim
            d[:, axis] = q[:, axis] - (mu_norm if (k - 1) % 2 == 0 else -mu_norm)
            diffs.append(d)
        us = [warp_order_sum(torch.abs(d), *order) for d in diffs]
        lp, exps, lse, slopes = _shell_logsumexp(us, radii, sig2)
        grad = torch.zeros_like(q)
        for e, sl, d in zip(exps, slopes, diffs):
            grad = grad + (e * sl)[:, None] * _sign(d)
        return lp, grad / lse[:, None]
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


def _hierarchical_logistic(dim, params, group=None):
    """The logistic posterior's device function, in the kernels' order
    (csrc/targets.cuh): z = X q summed over the coordinates in order, each
    product rounded before its sum; per data row one exp(-|z|) for the
    sigmoid and the softplus; the log-likelihood's row terms summed by the
    lane owning the row (rows j, j + G, ... of G lanes), then a butterfly;
    X^T (y - sigmoid z) summed over the rows in order. Both products are
    elementwise loops, never torch.matmul, so no TF32 and no other order.

    With `group` = G, the log-density only, in kernel 3's lane groups (G
    lanes, coordinates 4j..4j+3 on lane j); otherwise (lp, grad) in the
    warp-per-chain layout of kernels 1, 2 and 4."""
    info = {"family": "hierarchical_logistic", "dim": dim, "params": params}
    half_p = 0.5 * (dim - 1)
    lanes, blocked = (group, RWMH_COORDS_PER_LANE) if group else (32, 0)

    def evaluate(q, with_grad):
        X, xt, y = device_data(info, q.device)
        z = torch.zeros((q.shape[0], X.shape[0]), dtype=q.dtype, device=q.device)
        for d in range(dim):
            z = z + q[:, d:d + 1] * xt[d]
        e = torch.exp(-torch.abs(z))
        denom = 1.0 + e
        term = y * z - (torch.clamp(z, min=0.0) + torch.log1p(e))
        lik = warp_order_sum(term, lanes)
        tau = q[:, 0]
        inv_scale = torch.exp(-tau)
        beta_sq = warp_order_sum(torch.cat([torch.zeros_like(q[:, :1]), q[:, 1:] * q[:, 1:]],
                                           dim=1), lanes, blocked)
        shrink = 0.5 * inv_scale * beta_sq
        lp = lik - shrink - half_p * tau - 0.5 * tau * tau
        if not with_grad:
            return lp
        resid = y - torch.where(z >= 0.0, 1.0 / denom, e / denom)
        g = torch.zeros_like(q)
        for n in range(X.shape[0]):
            g = g + X[n] * resid[:, n:n + 1]
        g = g - q * inv_scale[:, None]
        g[:, 0] = shrink - half_p - tau
        return lp, g

    return lambda q: evaluate(q, not group)


_BUILDERS = {
    "standard_normal": _standard_normal,
    "neals_funnel": _neals_funnel,
    "neals_funnel_noncentered": _neals_funnel_noncentered,
    "ill_conditioned_gaussian": _ill_conditioned,
    "student_t": _student_t,
    "log_gamma": _log_gamma,
    "log_gamma_unconstrained": _log_gamma_unconstrained,
    "correlated_gaussian": _correlated,
    "gaussian_mixture": _gaussian_mixture,
    "hierarchical_logistic": _hierarchical_logistic,
    "rosenbrock": _rosenbrock,
    "multimodal_funnel_2d": _multimodal_funnel_2d,
    "concentric_l1_balls": _concentric_l1,
    "nested_l1_balls": _nested_l1,
}
