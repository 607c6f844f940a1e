"""Fused GRAHMC/HMC transitions: CUDA kernel wrappers and their plain versions.

Port of ``mcmc_tpu/ops/fused_trajectory.py``. Two kernels, both in
``mcmc_tpu_torch/csrc/fused_trajectory.cu``:

- ``grahmc_step_kernel`` — one MH transition per chain (the TPU
  ``_make_kernel``): momentum draw, L conformal-leapfrog substeps with the
  target's device function inlined, momentum flip, guarded energies,
  Metropolis accept and select. Writes the new state, accept, delta H and
  the proposal.
- ``grahmc_multistep_kernel`` — T such transitions per call with the state
  kept in registers (the TPU ``_make_multistep_kernel``); writes each
  transition's accept, delta H and post-transition q and lp.

Each wrapper takes its plain PyTorch version ONLY for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. There is no fallback. Each
counts its launches in a plain int attribute, ``.launches``.

Randomness: either injected (``p0`` and ``u``, the parity mode the tests use)
or drawn in the kernel from Philox4x32-10. The Philox key is two 32-bit words
drawn once per run from the run's ``torch.Generator``; the counter is
(chain, call index, transition, draw index), the call index a host integer
that ``PhiloxStream`` advances. ``philox4x32_10`` below is the same generator
in PyTorch integer arithmetic, so the plain versions draw exactly the bits
the kernels draw.

Supported: a diagonal metric, the five named friction schedules and
NO_FRICTION, and target families with a device function
(``padded_targets.FAMILY_IDS``); D <= 128. Anything else raises.
"""

import math
from typing import Callable, Optional

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.ops.padded_targets import (FAMILY_IDS, device_vag,
                                               kernel_info)
from mcmc_tpu_torch.samplers.grahmc import DIVERGENCE_DELTA_H, FRICTION_SCHEDULES
from mcmc_tpu_torch.samplers.trajectory import (as_scalar,
                                                integrate_trajectory,
                                                kinetic_energy)

Tensor = torch.Tensor

ENERGY_OVERFLOW = precision.ENERGY_OVERFLOW
MAX_DIM = 128            # 32 lanes x 4 registers per lane
ACCEPT_DRAW = 32         # Philox draw index of the accept uniform; momentum
                         # coordinate d uses draw d // 4 < 32
TWO_PI = 2.0 * math.pi

# Must match `enum Schedule` in csrc/fused_trajectory.cu; 0 is NO_FRICTION.
SCHEDULE_IDS = {None: 0, "constant": 1, "tanh": 2, "sigmoid": 3,
                "linear": 4, "sine": 5}
_SCHEDULE_FNS = {SCHEDULE_IDS[name]: fn for name, fn in FRICTION_SCHEDULES.items()}
_SCHEDULE_FNS[0] = None


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


# ============================================================================
# Plain versions
# ============================================================================

def _transition(vag, q, lp, grad, p0, u, scalars, inv_mass, num_steps,
                schedule):
    """One float32 transition, the arithmetic of the kernel's __device__
    transition. Returns (q, lp, grad, accept, dh, prop_q, prop_lp)."""
    h0 = -lp + kinetic_energy(p0, inv_mass)
    q1, p1, lp1, g1 = integrate_trajectory(
        q, p0, lp, grad, vag, scalars[0], num_steps, inv_mass,
        friction_schedule=_SCHEDULE_FNS[schedule], gamma_max=scalars[1],
        steepness=scalars[2])
    p1 = -p1
    h1 = precision.guard_energy(-lp1 + kinetic_energy(p1, inv_mass))
    accept = torch.log(u) < torch.clamp(h0 - h1, max=0.0)
    return (torch.where(accept[:, None], q1, q),
            torch.where(accept, lp1, lp),
            torch.where(accept[:, None], g1, grad),
            accept, h1 - h0, q1, lp1)


def _randoms(key, call, t, p0, u, inv_mass, n_chains, dim, device):
    """Injected (p0, u) or this transition's Philox draws."""
    if p0 is not None:
        return p0, u
    z = philox_normal(key, call, t, n_chains, dim, device)
    return z / torch.sqrt(inv_mass), philox_uniform(key, call, t, n_chains, device)


def grahmc_step_plain(info: dict, num_steps: int, schedule: int, q: Tensor,
                      lp: Tensor, grad: Tensor, scalars: Tensor,
                      inv_mass: Tensor, key: Optional[Tensor] = None,
                      call: int = 0, p0: Optional[Tensor] = None,
                      u: Optional[Tensor] = None):
    """Plain PyTorch version of grahmc_step_kernel, on any device (same
    arguments and results)."""
    n_chains, dim = q.shape
    p0, u = _randoms(key, call, 0, p0, u, inv_mass, n_chains, dim, q.device)
    return _transition(device_vag(info), q, lp, grad, p0, u, scalars,
                       inv_mass, num_steps, schedule)


def grahmc_multistep_plain(info: dict, num_steps: int, schedule: int,
                           transitions: int, q: Tensor, lp: Tensor,
                           grad: Tensor, scalars: Tensor, inv_mass: Tensor,
                           key: Optional[Tensor] = None, call: int = 0,
                           p0: Optional[Tensor] = None,
                           u: Optional[Tensor] = None):
    """Plain PyTorch version of grahmc_multistep_kernel, on any device (same
    arguments and results)."""
    n_chains, dim = q.shape
    vag = device_vag(info)
    accs, dhs, hist_q, hist_lp = [], [], [], []
    for t in range(transitions):
        p0_t, u_t = _randoms(key, call, t, None if p0 is None else p0[t],
                             None if u is None else u[t], inv_mass, n_chains,
                             dim, q.device)
        q, lp, grad, acc, dh, _, _ = _transition(
            vag, q, lp, grad, p0_t, u_t, scalars, inv_mass, num_steps,
            schedule)
        accs.append(acc)
        dhs.append(dh)
        hist_q.append(q)
        hist_lp.append(lp)
    return (q, lp, grad, torch.stack(accs), torch.stack(dhs),
            torch.stack(hist_q), torch.stack(hist_lp))


# ============================================================================
# Kernel wrappers
# ============================================================================

def _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u,
                  transitions=None):
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
    lead = () if transitions is None else (transitions,)
    expected = {"q": (q, (n_chains, dim)), "lp": (lp, (n_chains,)),
                "grad": (grad, (n_chains, dim)), "scalars": (scalars, (3,)),
                "inv_mass": (inv_mass, (dim,))}
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


def grahmc_step_kernel(info: dict, num_steps: int, schedule: int, q: Tensor,
                       lp: Tensor, grad: Tensor, scalars: Tensor,
                       inv_mass: Tensor, key: Optional[Tensor] = None,
                       call: int = 0, p0: Optional[Tensor] = None,
                       u: Optional[Tensor] = None):
    """One fused transition of every chain (kernel 1).

    q, grad (C, D), lp (C,), scalars (3,) = (eps, gamma, steepness),
    inv_mass (D,), injected p0 (C, D) and u (C,): float32, contiguous.
    key (2,) int32 with the host `call` index when p0/u are not injected.
    Returns (q, lp, grad, accept (C,) bool, delta_h, proposal_q, proposal_lp).
    """
    _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u)
    if q.device.type == "cpu":
        return grahmc_step_plain(info, num_steps, schedule, q, lp, grad,
                                 scalars, inv_mass, key, call, p0, u)
    _kernel_device(q)
    n_chains, dim = q.shape
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    q_out, grad_out, prop_q = (torch.empty_like(q) for _ in range(3))
    lp_out, dh, prop_lp = (torch.empty_like(lp) for _ in range(3))
    acc = torch.empty(n_chains, dtype=torch.bool, device=q.device)
    code = lib.grahmc_step_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, num_steps, schedule,
        scalars.data_ptr(), _ptr(key), call & _U32,
        q.data_ptr(), lp.data_ptr(), grad.data_ptr(), inv_mass.data_ptr(),
        _ptr(p0), _ptr(u),
        q_out.data_ptr(), lp_out.data_ptr(), grad_out.data_ptr(),
        acc.data_ptr(), dh.data_ptr(), prop_q.data_ptr(), prop_lp.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "grahmc_step_kernel")
    grahmc_step_kernel.launches += 1
    return q_out, lp_out, grad_out, acc, dh, prop_q, prop_lp


grahmc_step_kernel.launches = 0


def grahmc_multistep_kernel(info: dict, num_steps: int, schedule: int,
                            transitions: int, q: Tensor, lp: Tensor,
                            grad: Tensor, scalars: Tensor, inv_mass: Tensor,
                            key: Optional[Tensor] = None, call: int = 0,
                            p0: Optional[Tensor] = None,
                            u: Optional[Tensor] = None):
    """T = `transitions` fused transitions of every chain (kernel 2).

    Inputs as grahmc_step_kernel; injected p0 is (T, C, D) and u (T, C).
    Returns (q, lp, grad, accept (T, C) bool, delta_h (T, C),
    hist_q (T, C, D), hist_lp (T, C)), the histories holding each
    transition's post-transition state.
    """
    if transitions < 1:
        raise ValueError("transitions must be >= 1")
    _check_inputs(info, q, lp, grad, scalars, inv_mass, key, p0, u,
                  transitions)
    if q.device.type == "cpu":
        return grahmc_multistep_plain(info, num_steps, schedule, transitions,
                                      q, lp, grad, scalars, inv_mass, key,
                                      call, p0, u)
    _kernel_device(q)
    n_chains, dim = q.shape
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    q_out, grad_out = torch.empty_like(q), torch.empty_like(grad)
    lp_out = torch.empty_like(lp)
    acc = torch.empty((transitions, n_chains), dtype=torch.bool, device=q.device)
    dh, hist_lp = (lp.new_empty((transitions, n_chains)) for _ in range(2))
    hist_q = q.new_empty((transitions, n_chains, dim))
    code = lib.grahmc_multistep_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, num_steps, schedule,
        transitions, scalars.data_ptr(), _ptr(key), call & _U32,
        q.data_ptr(), lp.data_ptr(), grad.data_ptr(), inv_mass.data_ptr(),
        _ptr(p0), _ptr(u),
        q_out.data_ptr(), lp_out.data_ptr(), grad_out.data_ptr(),
        acc.data_ptr(), dh.data_ptr(), hist_q.data_ptr(), hist_lp.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "grahmc_multistep_kernel")
    grahmc_multistep_kernel.launches += 1
    return q_out, lp_out, grad_out, acc, dh, hist_q, hist_lp


grahmc_multistep_kernel.launches = 0


# ============================================================================
# Public constructors (the JAX package's contracts)
# ============================================================================

def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def _diagonal_metric(inv_mass_matrix: Tensor) -> Tensor:
    if inv_mass_matrix.ndim != 1:
        raise ValueError("the fused kernels take a diagonal metric (D,); "
                         "run a dense metric with backend='eager'")
    return _f32(inv_mass_matrix)


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
    return kernel_info(value_and_grad_fn), schedule_id(friction_schedule)


def _advance(state, q1, lp1, g1, n_accept, n_divergent):
    """The state after a kernel call, in the state's own dtypes."""
    return state._replace(
        position=q1.to(state.position.dtype),
        log_prob=lp1.to(state.log_prob.dtype),
        grad_log_prob=g1.to(state.position.dtype),
        accept_count=state.accept_count + n_accept,
        divergence_count=state.divergence_count + n_divergent,
    )


def make_fused_grahmc_step(value_and_grad_fn, num_steps: int,
                           friction_schedule: Optional[Callable]):
    """Build fused(stream, state, step_size, gamma, steepness, inv_mass)
    -> (new_state, (accept, proposal_q, proposal_lp, delta_h)), the
    grahmc_step contract on kernel 1. `stream` is a PhiloxStream on the
    state's device. Raises TypeError/KeyError for untagged targets, families
    without a device function and schedules without a kernel counterpart."""
    info, sched = _kernel_target(value_and_grad_fn, friction_schedule)
    scalars_for = _scalar_cache()

    def fused(stream: PhiloxStream, state, step_size, gamma, steepness,
              inv_mass_matrix):
        q1, lp1, g1, accept, dh, prop_q, prop_lp = grahmc_step_kernel(
            info, num_steps, sched, _f32(state.position), _f32(state.log_prob),
            _f32(state.grad_log_prob),
            scalars_for(step_size, gamma, steepness, state.position.device),
            _diagonal_metric(inv_mass_matrix), key=stream.key,
            call=stream.next_call())
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
    call."""
    info, sched = _kernel_target(value_and_grad_fn, friction_schedule)
    scalars_for = _scalar_cache()

    def multi(stream: PhiloxStream, state, step_size, gamma, steepness,
              inv_mass_matrix):
        q1, lp1, g1, accept, dh, hist_q, hist_lp = grahmc_multistep_kernel(
            info, num_steps, sched, transitions, _f32(state.position),
            _f32(state.log_prob), _f32(state.grad_log_prob),
            scalars_for(step_size, gamma, steepness, state.position.device),
            _diagonal_metric(inv_mass_matrix), key=stream.key,
            call=stream.next_call())
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
    """Kernel 1 with injected momentum and uniforms, the parity hook.

    Returns run(q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass)
    -> (q', lp', grad', accept, delta_h)."""
    info = kernel_info(value_and_grad_fn)
    if info["dim"] != dim:
        raise ValueError(f"target dim {info['dim']} != {dim}")
    sched = schedule_id(friction_schedule)

    def run(q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass):
        if q.shape != (n_chains, dim):
            raise ValueError(f"expected q of shape {(n_chains, dim)}")
        q1, lp1, g1, accept, dh, _, _ = grahmc_step_kernel(
            info, num_steps, sched, _f32(q), _f32(lp), _f32(grad),
            kernel_scalars(step_size, gamma, steepness, q.device),
            _diagonal_metric(inv_mass), p0=_f32(p0), u=_f32(u))
        return q1, lp1, g1, accept, dh

    return run
