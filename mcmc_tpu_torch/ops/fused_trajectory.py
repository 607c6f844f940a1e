"""Fused GRAHMC/HMC transitions: CUDA kernel wrappers and their plain versions.

Port of ``mcmc_tpu/ops/fused_trajectory.py``. Two kernels, both in
``mcmc_tpu_torch/csrc/fused_trajectory.cu``, each with a diagonal and a
dense variant (the TPU kernels' ``dense`` flag: variants 1a and 2a), and two
variants of the first with another potential (the TPU kernel's ``scaled``
and ``bridged`` flags), each diagonal or dense too:

- ``grahmc_step_kernel`` — one MH transition per chain (the TPU
  ``_make_kernel``): momentum draw, L conformal-leapfrog substeps with the
  target's device function inlined, momentum flip, guarded energies,
  Metropolis accept and select. Writes the new state, accept, delta H and
  the proposal.
- ``grahmc_multistep_kernel`` — T such transitions per call with the state
  kept in registers (the TPU ``_make_multistep_kernel``); writes each
  transition's accept, delta H and post-transition q and lp.
- ``grahmc_scaled_kernel`` (1b, ``csrc/fused_trajectory_scaled.cu``) — one
  transition of every row of a tempering ladder's replica-major (K C, D)
  batch in one launch, rung k = row // C sampling pi^beta_k with its own
  step: a (K, 4) rung table (eps_k, gamma, steepness, beta_k), each row the
  TPU scaled kernel's scalars (``rung_table``).
- ``grahmc_bridged_kernel`` (1c, ``csrc/fused_trajectory_bridged.cu``) — one
  transition on annealed SMC's bridge beta logp + (1 - beta) log N(m, S^2 I):
  scalars (eps, gamma, steepness, beta, base_log_norm) (``bridge_scalars``)
  and the base's (D,) mean and 1/S rows (``bridge_base``).

The metric is inv_mass's: (D,) diagonal, or (D, D) dense with its
unwhitening factor l_inv = L^{-1} (M^{-1} = L L^T), the momentum then being
z @ L^{-1}. ``prepare_dense_metric`` factors a dense M^{-1} once; the public
constructors take a raw (D,) or (D, D) metric or a ``PreparedDenseMetric``,
as the JAX ones do. The dense plain versions sum the products in the
kernels' order (``trajectory.ordered_matmul``).

A data-carrying target (``padded_targets.DATA_FAMILIES``, the hierarchical
posterior) runs in every kernel and metric here: the TPU kernels' form with
``data_arrays`` (variants 1d and 2b, and the same form of 1a, 1b, 1c and
2a). Its data set goes to the kernels as device pointers
(``padded_targets.device_data``).

Kernel 1's variants 1a (dense metric) and 1d (a data-carrying target), and
kernel 2's 2b (a data-carrying target, either metric), are block-tiled
(``csrc/tiled_step.cuh``): a block of DENSE_TILE_CHAINS (1a) or
HIER_TILE_CHAINS (1d, 2b) chains computes the products its chains take with
the shared M^{-1}, L^{-1} or X together, X streamed through shared memory
in row tiles; 2b's chains run their T transitions in lockstep.
``tile_geometry`` is their geometry (blocks, row tile, shared memory) as the
launcher picks it; the card tests hold the two equal.
Their outputs equal the warp-per-chain kernels' bit for bit.

Each wrapper takes its plain PyTorch version ONLY for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. There is no fallback. Each
counts its launches in plain int attributes, ``.launches`` (every variant),
``.variant_launches[name]`` (``variant_name``: the metric's VARIANTS name,
with DATA_SUFFIX for a data-carrying target) and ``.shape_launches[(name,
family, n_chains, dim)]`` (``count_launch``); ``reset_launches`` zeroes
them.

Randomness: either injected (``p0`` and ``u``, the parity mode the tests use)
or drawn in the kernel from Philox4x32-10. The Philox key is two 32-bit words
drawn once per run from the run's ``torch.Generator``; the counter is
(chain, call index, transition, draw index), the call index a host integer
that ``PhiloxStream`` advances. ``philox4x32_10`` below is the same generator
in PyTorch integer arithmetic, so the plain versions draw exactly the bits
the kernels draw.

Supported: a diagonal or dense metric, the five named friction schedules
and NO_FRICTION, and target families with a device function
(``padded_targets.KERNEL_FAMILIES["grahmc"]``); D <= 128. Anything else raises.
"""

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.ops.padded_targets import (DATA_FAMILIES, FAMILY_IDS, MAX_SHELLS,
                                               N_PARAMS, device_data, device_params,
                                               device_shells, device_vag, kernel_info)
from mcmc_tpu_torch.samplers.grahmc import DIVERGENCE_DELTA_H, FRICTION_SCHEDULES
from mcmc_tpu_torch.samplers.trajectory import (as_scalar, dense_unwhitening,
                                                integrate_trajectory,
                                                kinetic_energy, ordered_matmul)
from mcmc_tpu_torch.targets import LOG_2PI

Tensor = torch.Tensor

ENERGY_OVERFLOW = precision.ENERGY_OVERFLOW
MAX_DIM = 128            # 32 lanes x 4 registers per lane
# the block-tiled kernel 1 (csrc/tiled_step.cuh, constants of the same names)
DENSE_TILE_CHAINS = 8    # chains a block, one warp each: 1a
HIER_TILE_CHAINS = 32    # 1d and 1a's data form
TILE_ROWS = (64, 32, 16)  # data rows a tile: the largest that fits
MAX_TILE_SMEM = 232_448  # dynamic shared memory of an H100 block
ACCEPT_DRAW = 32         # Philox draw index of the accept uniform; momentum
                         # coordinate d uses draw d // 4 < 32
TWO_PI = 2.0 * math.pi

# Must match `enum Schedule` in csrc/fused_trajectory.cu; 0 is NO_FRICTION.
SCHEDULE_IDS = {None: 0, "constant": 1, "tanh": 2, "sigmoid": 3,
                "linear": 4, "sine": 5}
_SCHEDULE_FNS = {SCHEDULE_IDS[name]: fn for name, fn in FRICTION_SCHEDULES.items()}
_SCHEDULE_FNS[0] = None
# dense metric? -> variant name; the kernels' DENSE flag
VARIANTS = {False: "diagonal", True: "dense"}
# appended to a variant's name for a data-carrying target
DATA_SUFFIX = "+data"


def variant_name(base: str, info: dict) -> str:
    """A kernel variant's name: `base` (its metric or scheme), with
    DATA_SUFFIX for a target that carries a data set."""
    return base + (DATA_SUFFIX if info["family"] in DATA_FAMILIES else "")


def variant_names(bases) -> list:
    """Every variant name over `bases`, without and with DATA_SUFFIX."""
    return [b + s for b in bases for s in ("", DATA_SUFFIX)]


def schedule_id(friction_schedule: Optional[Callable]) -> int:
    """Kernel enum of a friction schedule (None = no friction). A schedule
    that is not one of the five named ones raises KeyError: a Python
    callable cannot be compiled into the kernel."""
    if friction_schedule is None:
        return 0
    for name, fn in FRICTION_SCHEDULES.items():
        if fn is friction_schedule:
            return SCHEDULE_IDS[name]
    raise KeyError(f"friction schedule {friction_schedule!r} has no kernel "
                   f"counterpart; use one of {sorted(FRICTION_SCHEDULES)}")


class TileGeometry(NamedTuple):
    """A block-tiled kernel's geometry for one call (1a, 1d, 2b; 3a's in
    ops/fused_rwmh.py)."""
    chains: int        # chains a block, one warp each
    blocks: int        # ceil(n_chains / chains); a warp past n_chains stores nothing
    row_tile: int      # data rows a tile of X (0 without data)
    row_tiles: int     # ceil(n_data / row_tile)
    smem_bytes: int    # dynamic shared memory a block


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _tile_bytes(dim: int, dense: bool, rows: int, chains: int) -> int:
    """csrc/tiled_step.cuh:tile_layout's bytes: M^{-1} and L^{-1} (dense),
    the rows transposed, the products' rows, and for data two X^T and two X
    row tiles and the residuals."""
    dp, ps = _round4(dim), chains + 4
    floats = ((2 * dim * dp if dense else 0) + dim * ps + chains * max(dp, rows)
              + 2 * dim * rows + 2 * rows * dp + rows * ps)
    return 4 * floats


def tile_geometry(n_chains: int, dim: int, n_data: int = 0,
                  dense: bool = False) -> TileGeometry:
    """The geometry of the block-tiled variants of kernel 1 (1a, 1d) and 2
    (2b, which takes 1d's) for n_chains chains of dimension dim, with a data
    set of n_data rows (0: none; HIER_TILE_CHAINS chains a block with data,
    DENSE_TILE_CHAINS without) and a dense or diagonal metric, as
    csrc/tiled_step.cuh:tile_geometry picks it (the
    largest row tile that fits; the smallest fits at MAX_DIM, which a
    static_assert there checks). Raises ValueError naming the limit for a
    shape the kernel does not take."""
    chains = HIER_TILE_CHAINS if n_data else DENSE_TILE_CHAINS
    if n_chains < 1:
        raise ValueError("need at least one chain")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the tiled kernel takes 1 <= dim <= {MAX_DIM}, got {dim}")
    if n_data < 0:
        raise ValueError(f"n_data must be >= 0, got {n_data}")
    rows = next(r for r in (TILE_ROWS if n_data else (0,))
                if _tile_bytes(dim, dense, r, chains) <= MAX_TILE_SMEM)
    return TileGeometry(chains, -(-n_chains // chains), rows, -(-n_data // rows) if rows else 0,
                        _tile_bytes(dim, dense, rows, chains))


# ============================================================================
# Philox4x32-10 in PyTorch integer arithmetic (uint32 values in int64)
# ============================================================================

_U32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b without leaving
    int64: split `a` into 16-bit halves so no partial product passes 2^48."""
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC11) on broadcastable int64 tensors
    holding uint32 values; the bits csrc/philox.cuh produces."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _U32
            k1 = (k1 + _PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _bits_to_uniform(bits: Tensor) -> Tensor:
    """uint32 bits -> float32 uniform in (0, 1]: 24-bit mantissa, never 0."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


def _philox_words(key: Tensor, call: int, t: int, chains: Tensor, draws: Tensor):
    dev = chains.device
    k = key.to(device=dev, dtype=torch.int64) & _U32
    call_t = torch.full((), call & _U32, dtype=torch.int64, device=dev)
    t_t = torch.full((), t, dtype=torch.int64, device=dev)
    return philox4x32_10(chains, call_t, t_t, draws, k[0], k[1])


def philox_normal(key: Tensor, call: int, t: int, n_chains: int, dim: int,
                  device) -> Tensor:
    """(n_chains, dim) standard normals, coordinate d from Philox draw d // 4:
    words (x0, x1) give coordinates 4k, 4k+1 (Box-Muller cos, sin), words
    (x2, x3) give 4k+2, 4k+3."""
    n_draw = (dim + 3) // 4
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)[:, None]
    draws = torch.arange(n_draw, dtype=torch.int64, device=device)[None, :]
    x = [_bits_to_uniform(w) for w in _philox_words(key, call, t, chains, draws)]
    z = []
    for a, b in ((x[0], x[1]), (x[2], x[3])):
        r = torch.sqrt(-2.0 * torch.log(a))
        theta = TWO_PI * b
        z += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(z, dim=2).reshape(n_chains, 4 * n_draw)[:, :dim]


def philox_uniform(key: Tensor, call: int, t: int, n_chains: int,
                   device) -> Tensor:
    """(n_chains,) accept uniforms: word x0 of draw ACCEPT_DRAW."""
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)
    draws = torch.full((), ACCEPT_DRAW, dtype=torch.int64, device=device)
    return _bits_to_uniform(_philox_words(key, call, t, chains, draws)[0])


class PhiloxStream:
    """Key words and call counter of the kernels' Philox generator — the
    fused backend's counterpart of a torch.Generator."""

    def __init__(self, key: Tensor):
        self.key = key            # (2,) int32, bit patterns of two uint32 words
        self.calls = 0

    @classmethod
    def from_generator(cls, generator: torch.Generator, device) -> "PhiloxStream":
        key = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=generator,
                            device=generator.device, dtype=torch.int32)
        return cls(key.to(device))

    def next_call(self) -> int:
        call = self.calls
        self.calls += 1
        return call


def kernel_scalars(step_size, gamma, steepness, device) -> Tensor:
    """The (3,) float32 device tensor (eps, gamma, steepness) the kernels read;
    a tensor step size (dual averaging) stays on the device."""
    return torch.stack([as_scalar(x, torch.float32, device)
                        for x in (step_size, gamma, steepness)])


def rung_table(step_sizes, gamma, steepness, betas, device) -> Tensor:
    """Kernel 1b's (K, 4) float32 table, row k = (eps_k, gamma, steepness,
    beta_k): the TPU scaled kernel's scalars for rung k. step_sizes and
    betas are (K,) tensors (or numbers, K = 1); gamma and steepness are
    shared by the rungs."""
    cols = [x.to(device=device, dtype=torch.float32).reshape(-1)
            if isinstance(x, torch.Tensor) else as_scalar(x, torch.float32, device)[None]
            for x in (step_sizes, gamma, steepness, betas)]
    n_rungs = max(c.numel() for c in cols)
    return torch.stack([c.expand(n_rungs) for c in cols], dim=1).contiguous()


class BridgeBase(NamedTuple):
    """The spherical-Gaussian base N(m, S^2 I) of kernel 1c's bridge."""
    mean: Tensor        # (D,) float32 m
    inv_scale: Tensor   # (D,) float32 1/S, computed in double
    log_norm: float     # -sum log S - D/2 log 2pi, in double


def bridge_base(base_mean, base_scale, dim: int, device) -> BridgeBase:
    """The base from a mean (None = 0) and scale, numbers or (D,)-broadcastable
    arrays or tensors, computed in double on the host and rounded once, as
    device_params does; once per run."""
    def host(x):
        return torch.as_tensor(x, dtype=torch.float64).cpu().broadcast_to((dim,))
    scale = host(base_scale)
    if bool((scale <= 0.0).any()):
        raise ValueError("base scale must be strictly positive")
    mean = torch.zeros(dim, dtype=torch.float64) if base_mean is None else host(base_mean)
    log_norm = float(-torch.sum(torch.log(scale)) - 0.5 * dim * LOG_2PI)
    return BridgeBase(_f32(mean).to(device), _f32(1.0 / scale).to(device), log_norm)


def bridge_scalars(step_size, gamma, steepness, beta, log_norm: float, device) -> Tensor:
    """Kernel 1c's (5,) float32 scalars (eps, gamma, steepness, beta,
    base_log_norm); a tensor step size or beta stays on the device."""
    return torch.stack([as_scalar(x, torch.float32, device)
                        for x in (step_size, gamma, steepness, beta, log_norm)])


# ============================================================================
# Dense metric, factored once
# ============================================================================

class PreparedDenseMetric(NamedTuple):
    """A dense M^{-1} factored once for reuse across kernel calls. The
    public constructors accept it anywhere they accept a raw (D, D)
    inv_mass_matrix; the JAX package's (padded to its TPU block) has no
    padding here."""
    invm: Tensor     # (D, D) float32 M^{-1}
    l_inv: Tensor    # (D, D) float32 L^{-1}, lower triangular, M^{-1} = L L^T


def prepare_dense_metric(inv_mass_matrix: Tensor,
                         check_errors: bool = True) -> PreparedDenseMetric:
    """Factor a dense (D, D) M^{-1} once, outside any sampling loop, in
    float64, on its own device. check_errors=False does not wait for the
    device to check positive definiteness (trajectory.dense_unwhitening)."""
    shape = tuple(inv_mass_matrix.shape)
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError(f"a dense metric is a square (D, D) matrix, got {shape}")
    l_inv = dense_unwhitening(inv_mass_matrix.to(torch.float64), check_errors)
    return PreparedDenseMetric(_f32(inv_mass_matrix), _f32(l_inv))


def is_dense_metric(inv_mass_matrix) -> bool:
    """True for a raw (D, D) matrix or a PreparedDenseMetric."""
    return (isinstance(inv_mass_matrix, PreparedDenseMetric)
            or inv_mass_matrix.ndim == 2)


# ============================================================================
# Plain versions
# ============================================================================

def _transition(vag, q, lp, grad, p0, u, scalars, inv_mass, num_steps,
                schedule):
    """One float32 transition, the arithmetic of the kernel's __device__
    transition. Returns (q, lp, grad, accept, dh, prop_q, prop_lp)."""
    h0 = -lp + kinetic_energy(p0, inv_mass, ordered_matmul)
    q1, p1, lp1, g1 = integrate_trajectory(
        q, p0, lp, grad, vag, scalars[0], num_steps, inv_mass,
        friction_schedule=_SCHEDULE_FNS[schedule], gamma_max=scalars[1],
        steepness=scalars[2], matmul=ordered_matmul)
    p1 = -p1
    h1 = precision.guard_energy(-lp1 + kinetic_energy(p1, inv_mass, ordered_matmul))
    accept = torch.log(u) < torch.clamp(h0 - h1, max=0.0)
    return (torch.where(accept[:, None], q1, q),
            torch.where(accept, lp1, lp),
            torch.where(accept[:, None], g1, grad),
            accept, h1 - h0, q1, lp1)


def unwhiten(z: Tensor, inv_mass: Tensor, l_inv: Optional[Tensor]) -> Tensor:
    """Standard normals z -> momentum ~ N(0, M), as the kernels unwhiten:
    z / sqrt(M^{-1}) (diagonal), z @ L^{-1} summed in order (dense)."""
    if l_inv is not None:
        return ordered_matmul(z, l_inv)
    return z / torch.sqrt(inv_mass)


def _randoms(key, call, t, p0, u, inv_mass, l_inv, n_chains, dim, device):
    """Injected (p0, u) or this transition's Philox draws."""
    if p0 is not None:
        return p0, u
    z = philox_normal(key, call, t, n_chains, dim, device)
    return (unwhiten(z, inv_mass, l_inv),
            philox_uniform(key, call, t, n_chains, device))


def grahmc_step_plain(info: dict, num_steps: int, schedule: int, q: Tensor,
                      lp: Tensor, grad: Tensor, scalars: Tensor,
                      inv_mass: Tensor, key: Optional[Tensor] = None,
                      call: int = 0, p0: Optional[Tensor] = None,
                      u: Optional[Tensor] = None,
                      l_inv: Optional[Tensor] = None):
    """Plain PyTorch version of grahmc_step_kernel, on any device (same
    arguments and results)."""
    n_chains, dim = q.shape
    p0, u = _randoms(key, call, 0, p0, u, inv_mass, l_inv, n_chains, dim,
                     q.device)
    return _transition(device_vag(info), q, lp, grad, p0, u, scalars,
                       inv_mass, num_steps, schedule)


def grahmc_multistep_plain(info: dict, num_steps: int, schedule: int,
                           transitions: int, q: Tensor, lp: Tensor,
                           grad: Tensor, scalars: Tensor, inv_mass: Tensor,
                           key: Optional[Tensor] = None, call: int = 0,
                           p0: Optional[Tensor] = None,
                           u: Optional[Tensor] = None,
                           l_inv: Optional[Tensor] = None):
    """Plain PyTorch version of grahmc_multistep_kernel, on any device (same
    arguments and results)."""
    n_chains, dim = q.shape
    vag = device_vag(info)
    accs, dhs, hist_q, hist_lp = [], [], [], []
    for t in range(transitions):
        p0_t, u_t = _randoms(key, call, t, None if p0 is None else p0[t],
                             None if u is None else u[t], inv_mass, l_inv,
                             n_chains, dim, q.device)
        q, lp, grad, acc, dh, _, _ = _transition(
            vag, q, lp, grad, p0_t, u_t, scalars, inv_mass, num_steps,
            schedule)
        accs.append(acc)
        dhs.append(dh)
        hist_q.append(q)
        hist_lp.append(lp)
    return (q, lp, grad, torch.stack(accs), torch.stack(dhs),
            torch.stack(hist_q), torch.stack(hist_lp))


def scaled_vag(vag: Callable, beta: Tensor) -> Callable:
    """lp and grad of `vag` times beta, per row (1b's potential)."""
    def scaled(q):
        lp, grad = vag(q)
        return beta * lp, beta[:, None] * grad
    return scaled


def bridged_vag(vag: Callable, beta: Tensor, log_norm: Tensor, mean: Tensor,
                inv_scale: Tensor) -> Callable:
    """beta * vag + (1 - beta) * log N(mean, diag(inv_scale^-2)) (1c's
    potential), in the TPU kernel's order."""
    def mixture(q):
        lt, gt = vag(q)
        z = (q - mean) * inv_scale
        lb = -0.5 * torch.sum(z * z, dim=1) + log_norm
        return beta * lt + (1.0 - beta) * lb, beta * gt - (1.0 - beta) * (z * inv_scale)
    return mixture


def grahmc_scaled_plain(info: dict, num_steps: int, schedule: int, q: Tensor,
                        lp: Tensor, grad: Tensor, rungs: Tensor, inv_mass: Tensor,
                        key: Optional[Tensor] = None, call: int = 0,
                        p0: Optional[Tensor] = None, u: Optional[Tensor] = None,
                        l_inv: Optional[Tensor] = None):
    """Plain PyTorch version of grahmc_scaled_kernel, on any device (same
    arguments and results): each row's rung scalars as (N, 1) rows."""
    n_chains, dim = q.shape
    rows = rungs.repeat_interleave(n_chains // rungs.shape[0], dim=0)
    p0, u = _randoms(key, call, 0, p0, u, inv_mass, l_inv, n_chains, dim, q.device)
    return _transition(scaled_vag(device_vag(info), rows[:, 3]), q, lp, grad, p0, u,
                       (rows[:, 0:1], rows[:, 1:2], rows[:, 2:3]), inv_mass, num_steps,
                       schedule)


def grahmc_bridged_plain(info: dict, num_steps: int, schedule: int, q: Tensor,
                         lp: Tensor, grad: Tensor, scalars: Tensor, base_mean: Tensor,
                         base_inv_scale: Tensor, inv_mass: Tensor,
                         key: Optional[Tensor] = None, call: int = 0,
                         p0: Optional[Tensor] = None, u: Optional[Tensor] = None,
                         l_inv: Optional[Tensor] = None):
    """Plain PyTorch version of grahmc_bridged_kernel, on any device (same
    arguments and results)."""
    n_chains, dim = q.shape
    vag = bridged_vag(device_vag(info), scalars[3], scalars[4], base_mean, base_inv_scale)
    p0, u = _randoms(key, call, 0, p0, u, inv_mass, l_inv, n_chains, dim, q.device)
    return _transition(vag, q, lp, grad, p0, u, scalars, inv_mass, num_steps, schedule)


# ============================================================================
# Kernel wrappers
# ============================================================================

def _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u, l_inv,
                  transitions=None, scalars_shape=(3,), extra=()):
    n_chains, dim = q.shape
    if dim != info["dim"]:
        raise ValueError(f"positions have dim {dim}, target has {info['dim']}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the fused kernels take 1 <= dim <= {MAX_DIM}, got {dim}")
    if n_chains < 1:
        raise ValueError("need at least one chain")
    if (p0 is None) != (u is None):
        raise ValueError("inject both p0 and u, or neither")
    if p0 is None and key is None:
        raise ValueError("need a Philox key or injected p0 and u")
    dense = inv_mass.ndim == 2
    if dense != (l_inv is not None):
        raise ValueError("a dense (D, D) inv_mass needs its l_inv, a diagonal one none")
    lead = () if transitions is None else (transitions,)
    expected = {"q": (q, (n_chains, dim)), "lp": (lp, (n_chains,)),
                "grad": (grad, (n_chains, dim)), "scalars": (scalars, scalars_shape),
                "inv_mass": (inv_mass, (dim, dim) if dense else (dim,))}
    expected.update({name: (t, (dim,)) for name, t in extra})
    if dense:
        expected["l_inv"] = (l_inv, (dim, dim))
    if p0 is not None:
        expected["p0"] = (p0, lead + (n_chains, dim))
        expected["u"] = (u, lead + (n_chains,))
    check_tensors(expected, q.device, key)


def check_tensors(expected: dict, device, key: Optional[Tensor] = None,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor of `expected` ({name: (tensor, shape)} or
    {name: (tensor, shape, dtype)}) has its dtype (default `dtype`) and
    shape, is contiguous and lies on `device`; and unless `key`, if given,
    is a (2,) int32 tensor there. The wrappers' argument check."""
    for name, spec in expected.items():
        t, shape = spec[:2]
        want = spec[2] if len(spec) > 2 else dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, positions on {device}")
    if key is not None and (key.dtype != torch.int32 or key.shape != (2,)
                            or key.device != device):
        raise ValueError("key must be a (2,) int32 tensor on the positions' device")


def _kernel_device(q: Tensor) -> None:
    """Raise unless the tensors are CUDA tensors: the wrappers never run a
    CUDA request on another device."""
    if not q.is_cuda:
        raise ValueError(f"the fused kernels run on CUDA tensors (or their "
                         f"plain version on CPU tensors); got {q.device}")


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on_error(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {code}")


def _step_outputs(q: Tensor, lp: Tensor):
    """Kernel 1's and its variants' seven output tensors (q, lp, grad,
    accept, delta_h, proposal q, proposal lp) and their pointers."""
    out = (torch.empty_like(q), torch.empty_like(lp), torch.empty_like(q),
           torch.empty(q.shape[0], dtype=torch.bool, device=q.device),
           torch.empty_like(lp), torch.empty_like(q), torch.empty_like(lp))
    return out, [t.data_ptr() for t in out]


def count_launch(kernel, name: str, info: dict, q: Tensor) -> None:
    """Count one launch of `kernel`'s variant `name` on the target `info`
    with positions q (n_chains, dim): in total, per variant, and per
    (variant, family, n_chains, dim) in ``.shape_launches``."""
    kernel.launches += 1
    kernel.variant_launches[name] += 1
    shape = (name, info["family"], *q.shape)
    kernel.shape_launches[shape] = kernel.shape_launches.get(shape, 0) + 1


def _count(kernel, inv_mass: Tensor, info: dict, q: Tensor) -> None:
    count_launch(kernel, variant_name(VARIANTS[inv_mass.ndim == 2], info), info, q)


def target_args(info: dict, device):
    """The launchers' host target arguments: a reference to the
    TargetParams (device_params, and device_shells for an L1 family, which
    raises past the kernels' MAX_SHELLS) and one to the TargetData of the
    target's device data set (None for a family without one). Both must
    live until the launch returns."""
    from mcmc_tpu_torch.ops import _cuda
    values, shells = device_params(info), device_shells(info)
    params = ctypes.byref(_cuda.TargetParams(
        (ctypes.c_float * N_PARAMS)(*values), (ctypes.c_float * MAX_SHELLS)(*shells),
        len(shells)))
    if info["family"] not in DATA_FAMILIES:
        return params, None
    X, xt, y = device_data(info, device)
    return params, ctypes.byref(_cuda.TargetData(X.data_ptr(), xt.data_ptr(), y.data_ptr(),
                                                 X.shape[0]))


def _metric_args(info: dict, inv_mass: Tensor, l_inv: Optional[Tensor]):
    """The launchers' (dense, host target params, host TargetData, inv_mass,
    l_inv) args."""
    params, data = target_args(info, inv_mass.device)
    return int(inv_mass.ndim == 2), params, data, inv_mass.data_ptr(), _ptr(l_inv)


def grahmc_step_kernel(info: dict, num_steps: int, schedule: int, q: Tensor,
                       lp: Tensor, grad: Tensor, scalars: Tensor,
                       inv_mass: Tensor, key: Optional[Tensor] = None,
                       call: int = 0, p0: Optional[Tensor] = None,
                       u: Optional[Tensor] = None,
                       l_inv: Optional[Tensor] = None):
    """One fused transition of every chain (kernel 1; 1a with a dense
    metric, 1d with a data-carrying target: block-tiled, tile_geometry).

    q, grad (C, D), lp (C,), scalars (3,) = (eps, gamma, steepness),
    inv_mass (D,) or (D, D) with its l_inv (D, D), injected momentum p0
    (C, D) and u (C,): float32, contiguous. key (2,) int32 with the host
    `call` index when p0/u are not injected.
    Returns (q, lp, grad, accept (C,) bool, delta_h, proposal_q, proposal_lp).
    """
    _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u, l_inv)
    if q.device.type == "cpu":
        return grahmc_step_plain(info, num_steps, schedule, q, lp, grad,
                                 scalars, inv_mass, key, call, p0, u, l_inv)
    _kernel_device(q)
    n_chains, dim = q.shape
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    out, ptrs = _step_outputs(q, lp)
    dense, params, data, invm_ptr, l_inv_ptr = _metric_args(info, inv_mass, l_inv)
    code = lib.grahmc_step_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, num_steps, schedule, dense,
        params, data, scalars.data_ptr(), _ptr(key), call & _U32,
        q.data_ptr(), lp.data_ptr(), grad.data_ptr(), invm_ptr, l_inv_ptr,
        _ptr(p0), _ptr(u), *ptrs, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "grahmc_step_kernel")
    _count(grahmc_step_kernel, inv_mass, info, q)
    return out


def grahmc_multistep_kernel(info: dict, num_steps: int, schedule: int,
                            transitions: int, q: Tensor, lp: Tensor,
                            grad: Tensor, scalars: Tensor, inv_mass: Tensor,
                            key: Optional[Tensor] = None, call: int = 0,
                            p0: Optional[Tensor] = None,
                            u: Optional[Tensor] = None,
                            l_inv: Optional[Tensor] = None):
    """T = `transitions` fused transitions of every chain (kernel 2; 2a
    with a dense metric; 2b with a data-carrying target, either metric:
    block-tiled, tile_geometry).

    Inputs as grahmc_step_kernel; injected p0 is (T, C, D) and u (T, C).
    Returns (q, lp, grad, accept (T, C) bool, delta_h (T, C),
    hist_q (T, C, D), hist_lp (T, C)), the histories holding each
    transition's post-transition state.
    """
    if transitions < 1:
        raise ValueError("transitions must be >= 1")
    _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u, l_inv,
                  transitions)
    if q.device.type == "cpu":
        return grahmc_multistep_plain(info, num_steps, schedule, transitions,
                                      q, lp, grad, scalars, inv_mass, key,
                                      call, p0, u, l_inv)
    _kernel_device(q)
    n_chains, dim = q.shape
    if info["family"] in DATA_FAMILIES:
        tile_geometry(n_chains, dim, info["params"]["n_data"], inv_mass.ndim == 2)
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    q_out, grad_out = torch.empty_like(q), torch.empty_like(grad)
    lp_out = torch.empty_like(lp)
    acc = torch.empty((transitions, n_chains), dtype=torch.bool, device=q.device)
    dh, hist_lp = (lp.new_empty((transitions, n_chains)) for _ in range(2))
    hist_q = q.new_empty((transitions, n_chains, dim))
    dense, params, data, invm_ptr, l_inv_ptr = _metric_args(info, inv_mass, l_inv)
    code = lib.grahmc_multistep_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, num_steps, schedule,
        transitions, dense, params, data, scalars.data_ptr(), _ptr(key), call & _U32,
        q.data_ptr(), lp.data_ptr(), grad.data_ptr(), invm_ptr, l_inv_ptr,
        _ptr(p0), _ptr(u),
        q_out.data_ptr(), lp_out.data_ptr(), grad_out.data_ptr(),
        acc.data_ptr(), dh.data_ptr(), hist_q.data_ptr(), hist_lp.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "grahmc_multistep_kernel")
    _count(grahmc_multistep_kernel, inv_mass, info, q)
    return q_out, lp_out, grad_out, acc, dh, hist_q, hist_lp


def grahmc_scaled_kernel(info: dict, num_steps: int, schedule: int, q: Tensor,
                         lp: Tensor, grad: Tensor, rungs: Tensor, inv_mass: Tensor,
                         key: Optional[Tensor] = None, call: int = 0,
                         p0: Optional[Tensor] = None, u: Optional[Tensor] = None,
                         l_inv: Optional[Tensor] = None):
    """One fused transition of every row of a replica-major (K C, D) batch
    (kernel 1b): row r belongs to rung k = r // C and samples pi^beta_k.

    rungs (K, 4) = (eps_k, gamma, steepness, beta_k) per rung (rung_table);
    q, grad (K C, D) and lp (K C,) hold the tempered state (beta_k lp,
    beta_k grad); the rest as grahmc_step_kernel's. Returns the same seven
    tensors, tempered."""
    n_chains = q.shape[0]
    n_rungs = rungs.shape[0] if rungs.ndim == 2 else 0
    if n_rungs < 1 or n_chains % n_rungs:
        raise ValueError(f"rungs must be a (K, 4) table with K dividing the {n_chains} "
                         f"rows, got {tuple(rungs.shape)}")
    _check_inputs(info, q, lp, grad, rungs, inv_mass, key, p0, u, l_inv,
                  scalars_shape=(n_rungs, 4))
    if q.device.type == "cpu":
        return grahmc_scaled_plain(info, num_steps, schedule, q, lp, grad, rungs, inv_mass,
                                   key, call, p0, u, l_inv)
    _kernel_device(q)
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    out, ptrs = _step_outputs(q, lp)
    dense, params, data, invm_ptr, l_inv_ptr = _metric_args(info, inv_mass, l_inv)
    code = lib.grahmc_scaled_launch(
        FAMILY_IDS[info["family"]], q.shape[1], n_chains, n_chains // n_rungs, num_steps,
        schedule, dense, params, data, rungs.data_ptr(), _ptr(key), call & _U32,
        q.data_ptr(), lp.data_ptr(), grad.data_ptr(), invm_ptr, l_inv_ptr, _ptr(p0),
        _ptr(u), *ptrs, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "grahmc_scaled_kernel")
    _count(grahmc_scaled_kernel, inv_mass, info, q)
    return out


def grahmc_bridged_kernel(info: dict, num_steps: int, schedule: int, q: Tensor,
                          lp: Tensor, grad: Tensor, scalars: Tensor, base_mean: Tensor,
                          base_inv_scale: Tensor, inv_mass: Tensor,
                          key: Optional[Tensor] = None, call: int = 0,
                          p0: Optional[Tensor] = None, u: Optional[Tensor] = None,
                          l_inv: Optional[Tensor] = None):
    """One fused transition of every chain on the SMC bridge beta logp +
    (1 - beta) log N(m, S^2 I) (kernel 1c).

    scalars (5,) = (eps, gamma, steepness, beta, base_log_norm)
    (bridge_scalars), base_mean and base_inv_scale the (D,) rows m and 1/S
    (bridge_base); lp and grad the bridge's at q; the rest as
    grahmc_step_kernel's. Returns the same seven tensors."""
    _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u, l_inv,
                  scalars_shape=(5,),
                  extra=(("base_mean", base_mean), ("base_inv_scale", base_inv_scale)))
    if q.device.type == "cpu":
        return grahmc_bridged_plain(info, num_steps, schedule, q, lp, grad, scalars,
                                    base_mean, base_inv_scale, inv_mass, key, call, p0,
                                    u, l_inv)
    _kernel_device(q)
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    out, ptrs = _step_outputs(q, lp)
    dense, params, data, invm_ptr, l_inv_ptr = _metric_args(info, inv_mass, l_inv)
    code = lib.grahmc_bridged_launch(
        FAMILY_IDS[info["family"]], q.shape[1], q.shape[0], num_steps, schedule, dense,
        params, data, scalars.data_ptr(), base_mean.data_ptr(), base_inv_scale.data_ptr(),
        _ptr(key), call & _U32, q.data_ptr(), lp.data_ptr(), grad.data_ptr(), invm_ptr,
        l_inv_ptr, _ptr(p0), _ptr(u), *ptrs,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "grahmc_bridged_kernel")
    _count(grahmc_bridged_kernel, inv_mass, info, q)
    return out


KERNELS = (grahmc_step_kernel, grahmc_multistep_kernel, grahmc_scaled_kernel,
           grahmc_bridged_kernel)


def reset_launches() -> None:
    """Set the launch counts of kernels 1, 2, 1b and 1c, total, per variant
    (metric, with or without data) and per shape, to 0."""
    for kernel in KERNELS:
        kernel.launches = 0
        kernel.variant_launches = dict.fromkeys(variant_names(VARIANTS.values()), 0)
        kernel.shape_launches = {}


reset_launches()


# ============================================================================
# Public constructors (the JAX package's contracts)
# ============================================================================

def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def kernel_metric(inv_mass_matrix):
    """(inv_mass, l_inv) in float32 as the kernels take them, from a (D,)
    metric (l_inv None), a PreparedDenseMetric, or a raw (D, D) one,
    factored here on every call as the JAX package's raw dense metric is:
    prepare it once outside a loop."""
    if isinstance(inv_mass_matrix, PreparedDenseMetric):
        return inv_mass_matrix
    if inv_mass_matrix.ndim == 2:
        return prepare_dense_metric(inv_mass_matrix)
    if inv_mass_matrix.ndim != 1:
        raise ValueError(f"a metric is (D,) or (D, D), got "
                         f"{tuple(inv_mass_matrix.shape)}")
    return _f32(inv_mass_matrix), None


def _scalar_cache():
    """kernel_scalars memoized on plain-number arguments, so a run with a
    fixed step size builds its (3,) device tensor once, not per step."""
    cache = {}

    def get(step_size, gamma, steepness, device):
        args = (step_size, gamma, steepness)
        if any(isinstance(a, torch.Tensor) for a in args):
            return kernel_scalars(step_size, gamma, steepness, device)
        k = args + (str(device),)
        if k not in cache:
            cache[k] = kernel_scalars(step_size, gamma, steepness, device)
        return cache[k]
    return get


def _kernel_target(value_and_grad_fn, friction_schedule):
    """(kernel_info, schedule id), raising for what the kernels cannot run."""
    if value_and_grad_fn is None:
        raise TypeError("the fused backend requires an analytic "
                        "value_and_grad_fn from mcmc_tpu_torch.targets")
    return kernel_info(value_and_grad_fn, "grahmc"), schedule_id(friction_schedule)


def _advance(state, q1, lp1, g1, n_accept, n_divergent):
    """The state after a kernel call, in the state's own dtypes."""
    return state._replace(
        position=q1.to(state.position.dtype),
        log_prob=lp1.to(state.log_prob.dtype),
        grad_log_prob=g1.to(state.position.dtype),
        accept_count=state.accept_count + n_accept,
        divergence_count=state.divergence_count + n_divergent,
    )


def _variant_step(info, num_steps, sched, q, lp, grad, step_size, gamma, steepness,
                  inv_mass, l_inv, lp_scale=None, bridge=None, scalars=None, **rand):
    """One transition of float32 tensors through kernel 1, 1b (lp_scale: a
    number or a (K,) row of betas, one per rung of C = N / K rows, the step
    size then a number or a (K,) row too) or 1c (bridge = (beta,
    BridgeBase)). `scalars` is kernel 1's (3,) tensor when already built."""
    if lp_scale is not None and bridge is not None:
        raise ValueError("lp_scale and bridge are mutually exclusive")
    dev = q.device
    if lp_scale is not None:
        rungs = rung_table(step_size, gamma, steepness, lp_scale, dev)
        return grahmc_scaled_kernel(info, num_steps, sched, q, lp, grad, rungs, inv_mass,
                                    l_inv=l_inv, **rand)
    if bridge is not None:
        beta, base = bridge
        return grahmc_bridged_kernel(
            info, num_steps, sched, q, lp, grad,
            bridge_scalars(step_size, gamma, steepness, beta, base.log_norm, dev),
            base.mean, base.inv_scale, inv_mass, l_inv=l_inv, **rand)
    if scalars is None:
        scalars = kernel_scalars(step_size, gamma, steepness, dev)
    return grahmc_step_kernel(info, num_steps, sched, q, lp, grad, scalars, inv_mass,
                              l_inv=l_inv, **rand)


def _bridge(bridge, dim: int, device):
    """(beta, BridgeBase) from (beta, BridgeBase) or (beta, mean, scale)."""
    if bridge is None or len(bridge) == 2:
        return bridge
    beta, base_mean, base_scale = bridge
    return beta, bridge_base(base_mean, base_scale, dim, device)


def make_fused_grahmc_step(value_and_grad_fn, num_steps: int,
                           friction_schedule: Optional[Callable]):
    """Build fused(stream, state, step_size, gamma, steepness, inv_mass,
    lp_scale=None, bridge=None) -> (new_state, (accept, proposal_q,
    proposal_lp, delta_h)), the grahmc_step contract on kernel 1 (1a for a
    dense metric: a raw (D, D) one or a PreparedDenseMetric). `stream` is a
    PhiloxStream on the state's device. Raises TypeError/KeyError for
    untagged targets, families without a device function and schedules
    without a kernel counterpart.

    lp_scale: the target's lp and grad times beta in every substep (kernel
    1b), a number, or a (K,) row of a tempering ladder's betas for a
    replica-major state of K rungs, the step size then a number or a (K,)
    row too: one launch for the whole ladder. bridge: (beta, base_mean,
    base_scale) or (beta, BridgeBase), the SMC bridge beta logp + (1 - beta)
    log N(m, S^2 I) with a runtime beta (kernel 1c); the state's lp and grad
    must be the bridge's."""
    info, sched = _kernel_target(value_and_grad_fn, friction_schedule)
    scalars_for = _scalar_cache()

    def fused(stream: PhiloxStream, state, step_size, gamma, steepness,
              inv_mass_matrix, lp_scale=None, bridge=None):
        inv_mass, l_inv = kernel_metric(inv_mass_matrix)
        dev = state.position.device
        scalars = None
        if lp_scale is None and bridge is None:
            scalars = scalars_for(step_size, gamma, steepness, dev)
        q1, lp1, g1, accept, dh, prop_q, prop_lp = _variant_step(
            info, num_steps, sched, _f32(state.position), _f32(state.log_prob),
            _f32(state.grad_log_prob), step_size, gamma, steepness, inv_mass, l_inv,
            lp_scale, _bridge(bridge, state.position.shape[1], dev), scalars,
            key=stream.key, call=stream.next_call())
        divergent = torch.abs(dh) > DIVERGENCE_DELTA_H
        new_state = _advance(state, q1, lp1, g1, accept.to(torch.int32),
                             divergent.to(torch.int32))
        e_dtype = state.log_prob.dtype
        return new_state, (accept, prop_q.to(state.position.dtype),
                           prop_lp.to(e_dtype), dh.to(e_dtype))

    return fused


def make_fused_grahmc_multistep(value_and_grad_fn, num_steps: int,
                                friction_schedule: Optional[Callable],
                                transitions: int):
    """Build multi(stream, state, step_size, gamma, steepness, inv_mass)
    -> (new_state, (accept (T, C), hist_q (T, C, D), hist_lp (T, C),
    delta_h (T, C))) running T = `transitions` transitions per kernel 2
    call (2a for a dense metric, raw or prepared)."""
    info, sched = _kernel_target(value_and_grad_fn, friction_schedule)
    scalars_for = _scalar_cache()

    def multi(stream: PhiloxStream, state, step_size, gamma, steepness,
              inv_mass_matrix):
        inv_mass, l_inv = kernel_metric(inv_mass_matrix)
        q1, lp1, g1, accept, dh, hist_q, hist_lp = grahmc_multistep_kernel(
            info, num_steps, sched, transitions, _f32(state.position),
            _f32(state.log_prob), _f32(state.grad_log_prob),
            scalars_for(step_size, gamma, steepness, state.position.device),
            inv_mass, key=stream.key, call=stream.next_call(), l_inv=l_inv)
        divergent = torch.abs(dh) > DIVERGENCE_DELTA_H
        new_state = _advance(state, q1, lp1, g1,
                             torch.sum(accept, dim=0, dtype=torch.int32),
                             torch.sum(divergent, dim=0, dtype=torch.int32))
        e_dtype = state.log_prob.dtype
        return new_state, (accept, hist_q.to(state.position.dtype),
                           hist_lp.to(e_dtype), dh.to(e_dtype))

    return multi


def make_debug_trajectory(value_and_grad_fn, num_steps: int,
                          friction_schedule: Optional[Callable],
                          n_chains: int, dim: int):
    """Kernel 1 (1a for a dense metric; 1b with lp_scale, 1c with bridge)
    with injected momentum and uniforms, the parity hook.

    Returns run(q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass,
    lp_scale=None, bridge=None) -> (q', lp', grad', accept, delta_h), with
    lp_scale and bridge as make_fused_grahmc_step's."""
    info = kernel_info(value_and_grad_fn, "grahmc")
    if info["dim"] != dim:
        raise ValueError(f"target dim {info['dim']} != {dim}")
    sched = schedule_id(friction_schedule)

    def run(q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass, lp_scale=None,
            bridge=None):
        if q.shape != (n_chains, dim):
            raise ValueError(f"expected q of shape {(n_chains, dim)}")
        invm, l_inv = kernel_metric(inv_mass)
        q1, lp1, g1, accept, dh, _, _ = _variant_step(
            info, num_steps, sched, _f32(q), _f32(lp), _f32(grad), step_size, gamma,
            steepness, invm, l_inv, lp_scale, _bridge(bridge, dim, q.device),
            p0=_f32(p0), u=_f32(u))
        return q1, lp1, g1, accept, dh

    return run
