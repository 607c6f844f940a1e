"""Fused persistent-NUTS window: CUDA kernel wrapper and its plain version.

Port of ``mcmc_tpu/ops/fused_nuts.py`` (endpoint scheme, diagonal metric).
One kernel, in ``mcmc_tpu_torch/csrc/fused_nuts.cu``: ``nuts_window_kernel``
runs one snapshot window -- `n_iters` machine iterations of up to W leapfrog
slots each -- of the persistent-NUTS state machine with each chain's whole
state in registers, so device memory sees the state once per window instead
of once per leapfrog (the TPU ``_make_kernel``). Its plain version,
``nuts_window_plain``, is ``samplers.nuts_persistent._machine_iteration``
with `slots` = W, the same arithmetic as the eager machine.

State: the port's ``_PState`` in its own layout -- the 14 position-like
fields of FULL_FIELDS as (C, D) row-major float32, per-chain float32
scalars, int32 counters and bool flags; no 8/128 padding, no chain tile, no
f32-carried counters. The wrapper and its plain version write the new state
into the given tensors (a field that aliases another is cloned first) and
return it.

Randomness: injected (`draws` = p0 (n_iters, C, D) normals, dir, dir2
(n_iters, C) bool, swap, slice, res (n_iters, C) float32) or drawn in the
kernel from Philox4x32-10 with counter (chain, call, iteration, draw):
draws 0..31 give the momentum exactly as ``philox_normal`` lays it out,
draw FLAGS_DRAW's four words give dir, dir2 (uniform < 1/2), swap and slice,
and word x0 of RES_DRAW the reservoir uniform -- ``philox_nuts_draws``.

The wrapper takes the plain version ONLY for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, and counts ``.launches``.
"""

import ctypes
from typing import Optional

import torch

from mcmc_tpu_torch.ops.fused_trajectory import (
    MAX_DIM, PhiloxStream, _bits_to_uniform, _kernel_device, _philox_words,
    _ptr, _raise_on_error, _U32, check_tensors, philox_normal)
from mcmc_tpu_torch.ops.padded_targets import FAMILY_IDS, device_vag, kernel_info
from mcmc_tpu_torch.samplers.nuts_persistent import _machine_iteration, _PState
from mcmc_tpu_torch.samplers.trajectory import as_scalar

Tensor = torch.Tensor

FLAGS_DRAW = 32   # words: dir, dir2, swap, slice
RES_DRAW = 33     # word x0: the snapshot reservoir uniform

# Field order of `struct State` in csrc/fused_nuts.cu.
FULL_FIELDS = ("q", "grad", "q_l", "p_l", "g_l", "q_r", "p_r", "g_r",
               "q_prop", "g_prop", "q_c", "p_c", "g_c", "q_res")
FLOAT_FIELDS = ("lp", "lp_prop", "h0", "log_u", "sum_alpha", "direction",
                "alpha_acc", "lp_res")
INT_FIELDS = ("n_valid", "n_steps", "depth", "steps_left", "transitions",
              "divergences", "depth_acc", "n_exec", "k_res")
BOOL_FIELDS = ("diverged", "needs_start")
KERNEL_FIELDS = FULL_FIELDS + FLOAT_FIELDS + INT_FIELDS + BOOL_FIELDS
assert sorted(KERNEL_FIELDS) == sorted(_PState._fields)


def nuts_scalars(step_size, delta_max, device) -> Tensor:
    """The (2,) float32 device tensor (step size, delta_max) the kernel
    reads; a tensor step size (dual averaging) stays on the device."""
    return torch.stack([as_scalar(step_size, torch.float32, device),
                        as_scalar(delta_max, torch.float32, device)])


def philox_nuts_draws(key: Tensor, call: int, it: int, n_chains: int, dim: int,
                      device):
    """Iteration `it`'s randomness as the kernel draws it: (z (C, D),
    dir (C,) bool, dir2 (C,) bool, swap, slice, res (C,) float32)."""
    z = philox_normal(key, call, it, n_chains, dim, device)
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)
    draw = torch.full((), FLAGS_DRAW, dtype=torch.int64, device=device)
    x = [_bits_to_uniform(w) for w in _philox_words(key, call, it, chains, draw)]
    res = _bits_to_uniform(_philox_words(key, call, it, chains, draw + 1)[0])
    return z, x[0] < 0.5, x[1] < 0.5, x[2], x[3], res


def _distinct(state: _PState) -> _PState:
    """The state with every field in its own buffer: fields that share
    storage with an earlier field (as _init_pstate's do) are cloned, so an
    in-place write of one field cannot overwrite another."""
    seen, fields = set(), {}
    for name, t in zip(state._fields, state):
        ptr = t.untyped_storage().data_ptr()
        fields[name] = t.clone() if ptr in seen else t
        seen.add(ptr)
    return _PState(**fields)


def nuts_window_plain(info: dict, n_iters: int, steps_per_iter: int,
                      max_tree_depth: int, state: _PState, scalars: Tensor,
                      inv_mass: Tensor, key: Optional[Tensor] = None,
                      call: int = 0, draws=None) -> _PState:
    """Plain PyTorch version of nuts_window_kernel, on any device (same
    arguments and results)."""
    state = _distinct(state)
    n_chains, dim = state.q.shape
    vag = device_vag(info)
    s = state
    for it in range(n_iters):
        d = (tuple(x[it] for x in draws) if draws is not None
             else philox_nuts_draws(key, call, it, n_chains, dim, s.q.device))
        s = _machine_iteration(s, d, vag, scalars[0], inv_mass, max_tree_depth,
                               scalars[1], slots=steps_per_iter)
    for dst, src in zip(state, s):
        dst.copy_(src)
    return state


def _check_inputs(info, n_iters, steps_per_iter, max_tree_depth, state,
                  scalars, inv_mass, key, draws):
    n_chains, dim = state.q.shape
    if dim != info["dim"]:
        raise ValueError(f"positions have dim {dim}, target has {info['dim']}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the fused kernels take 1 <= dim <= {MAX_DIM}, got {dim}")
    if n_chains < 1 or n_iters < 1 or steps_per_iter < 1:
        raise ValueError("need at least one chain, iteration and slot")
    if not 1 <= max_tree_depth <= 30:
        raise ValueError(f"max_tree_depth must lie in [1, 30], got {max_tree_depth}")
    if draws is None and key is None:
        raise ValueError("need a Philox key or injected draws")
    expected = {"scalars": (scalars, (2,)), "inv_mass": (inv_mass, (dim,))}
    for name in FULL_FIELDS:
        expected[name] = (getattr(state, name), (n_chains, dim))
    for names, dtype in ((FLOAT_FIELDS, torch.float32), (INT_FIELDS, torch.int32),
                         (BOOL_FIELDS, torch.bool)):
        for name in names:
            expected[name] = (getattr(state, name), (n_chains,), dtype)
    if draws is not None:
        if len(draws) != 6:
            raise ValueError("draws are (p0, dir, dir2, swap, slice, res)")
        row = (n_iters, n_chains)
        for name, t, shape, dtype in zip(
                ("p0", "dir", "dir2", "swap", "slice", "res"), draws,
                (row + (dim,),) + (row,) * 5,
                (torch.float32, torch.bool, torch.bool) + (torch.float32,) * 3):
            expected[name] = (t, shape, dtype)
    check_tensors(expected, state.q.device, key)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def nuts_window_kernel(info: dict, n_iters: int, steps_per_iter: int,
                       max_tree_depth: int, state: _PState, scalars: Tensor,
                       inv_mass: Tensor, key: Optional[Tensor] = None,
                       call: int = 0, draws=None) -> _PState:
    """One persistent-NUTS window of every chain (kernel 4): `n_iters`
    machine iterations of up to W = `steps_per_iter` leapfrog slots.

    state: the port's _PState in float32 / int32 / bool (KERNEL_FIELDS);
    scalars (2,) = (step size, delta_max); inv_mass (D,) float32; key (2,)
    int32 with the host `call` index (the window index) when `draws` are
    not injected. Writes the new state into the state's tensors and
    returns it.
    """
    _check_inputs(info, n_iters, steps_per_iter, max_tree_depth, state, scalars,
                  inv_mass, key, draws)
    if state.q.device.type == "cpu":
        return nuts_window_plain(info, n_iters, steps_per_iter, max_tree_depth,
                                 state, scalars, inv_mass, key, call, draws)
    _kernel_device(state.q)
    state = _distinct(state)
    n_chains, dim = state.q.shape
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    fields = _pointers([getattr(state, f) for f in KERNEL_FIELDS])
    injected = None if draws is None else _pointers(draws)
    code = lib.nuts_window_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, n_iters, steps_per_iter,
        max_tree_depth, scalars.data_ptr(), inv_mass.data_ptr(), _ptr(key),
        call & _U32, fields, injected,
        torch.cuda.current_stream(state.q.device).cuda_stream)
    _raise_on_error(code, "nuts_window_kernel")
    nuts_window_kernel.launches += 1
    return state


nuts_window_kernel.launches = 0


# What a window emits: the chain's current state, its snapshot reservoir and
# its accept statistic. The other float fields are the trajectory in flight.
EMITTED_FIELDS = ("q", "grad", "q_res", "lp", "lp_res", "alpha_acc")
IN_FLIGHT_FIELDS = tuple(f for f in FULL_FIELDS + FLOAT_FIELDS
                         if f not in EMITTED_FIELDS)


def _chains_close(x: Tensor, y: Tensor, tol: float) -> Tensor:
    """(C,) bool: every entry of the chain within tol + tol |y|, or equal
    (infinities), or NaN in both."""
    ok = ((x - y).abs() <= tol + tol * y.abs()) | (x == y) | (x.isnan() & y.isnan())
    return ok.all(dim=1) if ok.ndim == 2 else ok


def window_agreement(a: _PState, b: _PState, tol: float = 1e-4):
    """Hold one window's result against another's on the same inputs (the
    kernel against its plain version), chain by chain.

    A sum taken in another order rounds differently. A U-turn test is the
    sign of a dot product, so a near-zero sign can flip, after which the
    chain's tree differs for the rest of the window; and where the leapfrog
    is unstable (the funnel's neck at a large step) a rounding difference
    grows within a subtree until the trajectory diverges. So the result is
    per chain: (same: every counter and flag equal, emitted: the emitted
    state within tol, in_flight: the trajectory in flight within tol, err:
    the largest |a - b| of the emitted fields on the chains that are `same`
    and `emitted`)."""
    same = torch.ones_like(a.needs_start)
    for name in INT_FIELDS + BOOL_FIELDS:
        same &= getattr(a, name) == getattr(b, name)
    emitted, in_flight = torch.ones_like(same), torch.ones_like(same)
    for names, ok in ((EMITTED_FIELDS, emitted), (IN_FLIGHT_FIELDS, in_flight)):
        for name in names:
            ok &= _chains_close(getattr(a, name), getattr(b, name), tol)
    keep = same & emitted
    err = 0.0
    for name in EMITTED_FIELDS:
        x, y = getattr(a, name)[keep], getattr(b, name)[keep]
        if x.numel():
            err = max(err, float((x - y).abs().max()))
    return same, emitted, in_flight, err


def make_fused_nuts_window(value_and_grad_fn, generator: torch.Generator,
                           step_size, inv_mass_matrix: Tensor,
                           max_tree_depth: int, delta_max, steps_per_iter: int,
                           device):
    """Build window(state, n_slots) -> state: one kernel 4 call running
    n_slots // steps_per_iter machine iterations, its Philox key drawn once
    from `generator` and its call index the window's number. The state is
    the float32 _PState; the step size may be a device tensor."""
    info = kernel_info(value_and_grad_fn)
    stream = PhiloxStream.from_generator(generator, device)
    scalars = nuts_scalars(step_size, delta_max, device)
    inv_mass = inv_mass_matrix.to(device=device, dtype=torch.float32).contiguous()

    def window(ps: _PState, n_slots: int) -> _PState:
        return nuts_window_kernel(info, n_slots // steps_per_iter, steps_per_iter,
                                  max_tree_depth, ps, scalars, inv_mass,
                                  key=stream.key, call=stream.next_call())
    return window
