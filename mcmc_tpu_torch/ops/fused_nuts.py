"""Fused persistent-NUTS window: CUDA kernel wrapper and its plain version.

Port of ``mcmc_tpu/ops/fused_nuts.py``: both proposal schemes (endpoint,
multinomial) and both metrics (diagonal, dense), four variants of one
kernel. ``nuts_window_kernel`` runs one snapshot window -- `n_iters` machine
iterations of up to W leapfrog slots each -- of the persistent-NUTS state
machine with each chain's trajectory in registers, so device memory sees
the state once per window instead of once per leapfrog (the TPU
``_make_kernel``), in ``mcmc_tpu_torch/csrc/nuts_window.cuh`` (launched
from ``fused_nuts.cu``) in one of two forms (``window_form``): warp per
chain for every family without data (4, 4a, 4b, 4a+4b); block-tiled for a
data-carrying target in either scheme and metric (4c, 4a's and 4b's data
forms): a block of WINDOW_TILE_CHAINS chains computes the products its
live chains take with the shared X, M^{-1} or L^{-1} together
(``tile_geometry``; the card tests hold it to the kernel's). Both forms sum
in the same order, so the tiled form's outputs are bit for bit the warp
kernel's. ``lockstep_counts`` counts what the tiles' block-uniform control
costs. Its plain version, ``nuts_window_plain``, is
``samplers.nuts_persistent._machine_iteration`` with `slots` = W, the same
arithmetic as the eager machine (the dense products summed in the kernel's
order, ``trajectory.ordered_matmul``).

State: the port's ``_PState`` in its own layout -- the 14 position-like
fields of FULL_FIELDS as (C, D) row-major float32, per-chain float32
scalars, int32 counters and bool flags; under the multinomial scheme also
the subtree reservoir (q_sub, g_sub (C, D), lp_sub, lw_tree, lw_sub,
div_sub, turn_sub (C,)) and the two checkpoint stacks q_stk, p_stk
(C, max_tree_depth, D). No 8/128 padding, no chain tile, no f32-carried
counters. The scheme is the state's: a state with q_sub runs the
multinomial scheme. The metric is inv_mass's: (D,) diagonal, or (D, D)
dense with its unwhitening factor l_inv = L^{-1} (M^{-1} = L L^T). The
wrapper and its plain version write the new state into the given tensors
(a field that aliases another is cloned first) and return it.

Randomness: injected (`draws` = p0 (n_iters, C, D) normals, dir, dir2
(n_iters, C) bool, swap, slice, res (n_iters, C) float32; under the
multinomial scheme slice is (n_iters * W, C), slot k of iteration i at row
i * W + k, as the TPU kernel takes it) or drawn in the kernel from
Philox4x32-10 with counter (chain, call, iteration, draw): draws 0..31 give
the momentum exactly as ``philox_normal`` lays it out, draw FLAGS_DRAW's
four words give dir, dir2 (uniform < 1/2), swap and slice, word x0 of
RES_DRAW the reservoir uniform, and under the multinomial scheme slot k's
leaf uniform is word k % 4 of draw SLICE_DRAW + k // 4 (slot 0's doubling
as the start's slice variable) -- ``philox_nuts_draws``.

A data-carrying target (the hierarchical posterior) runs in every variant
as the TPU kernel's ``data_arrays`` form (4c with the endpoint scheme and
the diagonal metric), its data set passed as device pointers.

The wrapper takes the plain version ONLY for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, and counts ``.launches`` (all
variants), ``.variant_launches[name]`` (per variant: VARIANTS, and each
with DATA_SUFFIX for a data-carrying target) and ``.shape_launches`` (per
(variant, family, n_chains, dim)).
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from mcmc_tpu_torch.ops.fused_trajectory import (
    MAX_DIM, MAX_TILE_SMEM, TILE_ROWS, PhiloxStream, TileGeometry, _bits_to_uniform,
    _kernel_device, _philox_words, _ptr, _raise_on_error, _tile_bytes, _U32, check_tensors,
    count_launch, kernel_metric, philox_normal, target_args, variant_name, variant_names)
from mcmc_tpu_torch.ops.padded_targets import DATA_FAMILIES, FAMILY_IDS, device_vag, kernel_info
from mcmc_tpu_torch.samplers.nuts_persistent import _machine_iteration, _PState
from mcmc_tpu_torch.samplers.trajectory import as_scalar, ordered_matmul

Tensor = torch.Tensor

# csrc/nuts_window.cuh:WINDOW_TILE_CHAINS, the tiled form's chains a block,
# one warp each
WINDOW_TILE_CHAINS = 32

FLAGS_DRAW = 32   # words: dir, dir2, swap, slice
RES_DRAW = 33     # word x0: the snapshot reservoir uniform
SLICE_DRAW = 34   # multinomial: slot k's leaf uniform, word k % 4 of draw 34 + k // 4

# Field order of `struct State` in csrc/nuts_window.cuh: the endpoint machine's
# 33 fields, then the multinomial scheme's 9 (null under the endpoint scheme).
FULL_FIELDS = ("q", "grad", "q_l", "p_l", "g_l", "q_r", "p_r", "g_r",
               "q_prop", "g_prop", "q_c", "p_c", "g_c", "q_res")
FLOAT_FIELDS = ("lp", "lp_prop", "h0", "log_u", "sum_alpha", "direction",
                "alpha_acc", "lp_res")
INT_FIELDS = ("n_valid", "n_steps", "depth", "steps_left", "transitions",
              "divergences", "depth_acc", "n_exec", "k_res")
BOOL_FIELDS = ("diverged", "needs_start")
MULTI_FULL_FIELDS = ("q_sub", "g_sub")
MULTI_FLOAT_FIELDS = ("lp_sub", "lw_tree", "lw_sub")
MULTI_BOOL_FIELDS = ("div_sub", "turn_sub")
STACK_FIELDS = ("q_stk", "p_stk")
KERNEL_FIELDS = (FULL_FIELDS + FLOAT_FIELDS + INT_FIELDS + BOOL_FIELDS
                 + MULTI_FULL_FIELDS + MULTI_FLOAT_FIELDS + MULTI_BOOL_FIELDS
                 + STACK_FIELDS)
assert sorted(KERNEL_FIELDS) == sorted(_PState._fields)

# (multinomial, dense) -> variant name; the kernel's MULTI and DENSE flags
VARIANTS = {(False, False): "endpoint", (True, False): "multinomial",
            (False, True): "dense", (True, True): "multinomial+dense"}


def variant(state: _PState, inv_mass: Tensor, info: Optional[dict] = None) -> str:
    """The kernel variant a window of `state` under `inv_mass` runs (for
    the target of `info`: with DATA_SUFFIX for a data-carrying one)."""
    base = VARIANTS[(state.q_sub is not None, inv_mass.ndim == 2)]
    return base if info is None else variant_name(base, info)


def window_form(info: dict) -> str:
    """The form a window of the target of `info` runs (csrc/
    nuts_window.cuh:WARP_WINDOW): "tiled" for a data-carrying target, else
    "warp", in either metric."""
    return "tiled" if info["family"] in DATA_FAMILIES else "warp"


def tile_geometry(n_chains: int, dim: int, n_data: int,
                  dense: bool = False) -> TileGeometry:
    """The tiled form's geometry for n_chains chains of dimension dim,
    with a data set of n_data rows and a dense or diagonal metric, as
    csrc/nuts_window.cuh:window_tile_geometry picks it: kernel 1's tile
    layout at WINDOW_TILE_CHAINS chains a block, the largest row tile that
    fits beside the live-chain flags (2 C ints of static shared memory).
    Raises ValueError naming the limit for a shape the kernel does not
    take."""
    chains = WINDOW_TILE_CHAINS
    if n_chains < 1:
        raise ValueError("need at least one chain")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the tiled window takes 1 <= dim <= {MAX_DIM}, got {dim}")
    if n_data < 1:
        raise ValueError(f"the tiled window carries a data set: n_data >= 1, got {n_data}")
    flags = 2 * chains * 4
    rows = next(r for r in TILE_ROWS
                if _tile_bytes(dim, dense, r, chains) + flags <= MAX_TILE_SMEM)
    return TileGeometry(chains, -(-n_chains // chains), rows, -(-n_data // rows),
                        _tile_bytes(dim, dense, rows, chains))


class LockstepCounts(NamedTuple):
    """What blocks of C chains in lockstep run against what their chains
    need (lockstep_counts)."""
    chain_slots: int    # leapfrog slots the chains ran
    block_slots: int    # C x, per block and iteration, the most any chain ran
    chain_starts: int   # transitions started
    start_blocks: int   # (block, iteration) pairs in which a chain started

    @property
    def slot_share(self) -> float:
        """The share of the blocks' warp-slots whose chain was live."""
        return self.chain_slots / max(self.block_slots, 1)


def lockstep_counts(live_slots: Tensor, starts: Tensor, chains: int) -> LockstepCounts:
    """Blocks of `chains` consecutive chains run each iteration's slot k
    while any of their chains is live in it, and the start's products while
    any starts. From the slots each chain ran per iteration (live_slots,
    (n_iters, C) int) and whether it started (starts, (n_iters, C) bool),
    count both sides; a ragged last block's missing chains run nothing."""
    n_iters, n = live_slots.shape
    pad = -n % chains
    live = torch.nn.functional.pad(live_slots.to(torch.int64), (0, pad))
    start = torch.nn.functional.pad(starts.to(torch.int64), (0, pad))
    blocks = live.reshape(n_iters, -1, chains)
    return LockstepCounts(int(live.sum()), chains * int(blocks.amax(dim=2).sum()),
                          int(start.sum()),
                          int((start.reshape(n_iters, -1, chains).amax(dim=2) > 0).sum()))


def nuts_scalars(step_size, delta_max, device) -> Tensor:
    """The (2,) float32 device tensor (step size, delta_max) the kernel
    reads; a tensor step size (dual averaging) stays on the device."""
    return torch.stack([as_scalar(step_size, torch.float32, device),
                        as_scalar(delta_max, torch.float32, device)])


def philox_slice_uniforms(key: Tensor, call: int, it: int, n_chains: int,
                          slots: int, device) -> Tensor:
    """(slots, C) multinomial leaf uniforms of iteration `it`: slot k is
    word k % 4 of draw SLICE_DRAW + k // 4."""
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)[None, :]
    draws = SLICE_DRAW + torch.arange((slots + 3) // 4, dtype=torch.int64,
                                      device=device)[:, None]
    words = _philox_words(key, call, it, chains, draws)
    u = torch.stack([_bits_to_uniform(x) for x in words], dim=1)
    return u.reshape(-1, n_chains)[:slots]


def philox_nuts_draws(key: Tensor, call: int, it: int, n_chains: int, dim: int,
                      device, slots: Optional[int] = None):
    """Iteration `it`'s randomness as the kernel draws it: (z (C, D),
    dir (C,) bool, dir2 (C,) bool, swap, slice, res (C,) float32); with
    `slots` (the multinomial scheme) slice is the (slots, C) leaf uniforms."""
    z = philox_normal(key, call, it, n_chains, dim, device)
    chains = torch.arange(n_chains, dtype=torch.int64, device=device)
    draw = torch.full((), FLAGS_DRAW, dtype=torch.int64, device=device)
    x = [_bits_to_uniform(w) for w in _philox_words(key, call, it, chains, draw)]
    res = _bits_to_uniform(_philox_words(key, call, it, chains, draw + 1)[0])
    slc = x[3] if slots is None else philox_slice_uniforms(key, call, it, n_chains,
                                                            slots, device)
    return z, x[0] < 0.5, x[1] < 0.5, x[2], slc, res


def _distinct(state: _PState) -> _PState:
    """The state with every field in its own buffer: fields that share
    storage with an earlier field (as _init_pstate's do) are cloned, so an
    in-place write of one field cannot overwrite another."""
    seen, fields = set(), {}
    for name, t in zip(state._fields, state):
        if t is None:
            fields[name] = t
            continue
        ptr = t.untyped_storage().data_ptr()
        fields[name] = t.clone() if ptr in seen else t
        seen.add(ptr)
    return _PState(**fields)


def _iteration_draws(draws, it: int, slots: int, multinomial: bool):
    """Iteration `it`'s part of injected draws."""
    d = [x[it] for x in draws]
    if multinomial:
        d[4] = draws[4][it * slots:(it + 1) * slots]
    return tuple(d)


def nuts_window_plain(info: dict, n_iters: int, steps_per_iter: int,
                      max_tree_depth: int, state: _PState, scalars: Tensor,
                      inv_mass: Tensor, key: Optional[Tensor] = None,
                      call: int = 0, draws=None,
                      l_inv: Optional[Tensor] = None) -> _PState:
    """Plain PyTorch version of nuts_window_kernel, on any device (same
    arguments and results)."""
    state = _distinct(state)
    n_chains, dim = state.q.shape
    multinomial = state.q_sub is not None
    vag = device_vag(info)
    s = state
    for it in range(n_iters):
        if draws is not None:
            d = _iteration_draws(draws, it, steps_per_iter, multinomial)
        else:
            d = philox_nuts_draws(key, call, it, n_chains, dim, s.q.device,
                                  steps_per_iter if multinomial else None)
        s = _machine_iteration(s, d, vag, scalars[0], inv_mass, max_tree_depth,
                               scalars[1], slots=steps_per_iter, l_inv=l_inv,
                               matmul=ordered_matmul)
    for dst, src in zip(state, s):
        if dst is not None:
            dst.copy_(src)
    return state


def _check_inputs(info, n_iters, steps_per_iter, max_tree_depth, state,
                  scalars, inv_mass, key, draws, l_inv):
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
    dense = inv_mass.ndim == 2
    if dense != (l_inv is not None):
        raise ValueError("a dense (D, D) inv_mass needs its l_inv, a diagonal one none")
    multinomial = state.q_sub is not None
    missing = [f for f in KERNEL_FIELDS if getattr(state, f) is None]
    if multinomial and missing:
        raise ValueError(f"the multinomial scheme needs all of its fields: missing {missing}")
    expected = {"scalars": (scalars, (2,)),
                "inv_mass": (inv_mass, (dim, dim) if dense else (dim,))}
    if dense:
        expected["l_inv"] = (l_inv, (dim, dim))
    for name in FULL_FIELDS + (MULTI_FULL_FIELDS if multinomial else ()):
        expected[name] = (getattr(state, name), (n_chains, dim))
    groups = ((FLOAT_FIELDS, torch.float32), (INT_FIELDS, torch.int32),
              (BOOL_FIELDS, torch.bool))
    if multinomial:
        groups += ((MULTI_FLOAT_FIELDS, torch.float32), (MULTI_BOOL_FIELDS, torch.bool))
        for name in STACK_FIELDS:
            expected[name] = (getattr(state, name), (n_chains, max_tree_depth, dim))
    for names, dtype in groups:
        for name in names:
            expected[name] = (getattr(state, name), (n_chains,), dtype)
    if draws is not None:
        if len(draws) != 6:
            raise ValueError("draws are (p0, dir, dir2, swap, slice, res)")
        it = (n_iters, n_chains)
        slc = (n_iters * steps_per_iter, n_chains) if multinomial else it
        for name, t, shape, dtype in zip(
                ("p0", "dir", "dir2", "swap", "slice", "res"), draws,
                (it + (dim,), it, it, it, slc, it),
                (torch.float32, torch.bool, torch.bool) + (torch.float32,) * 3):
            expected[name] = (t, shape, dtype)
    check_tensors(expected, state.q.device, key)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(_ptr(t) for t in tensors))


def nuts_window_kernel(info: dict, n_iters: int, steps_per_iter: int,
                       max_tree_depth: int, state: _PState, scalars: Tensor,
                       inv_mass: Tensor, key: Optional[Tensor] = None,
                       call: int = 0, draws=None,
                       l_inv: Optional[Tensor] = None) -> _PState:
    """One persistent-NUTS window of every chain (kernel 4): `n_iters`
    machine iterations of up to W = `steps_per_iter` leapfrog slots.

    state: the port's _PState in float32 / int32 / bool, with the
    multinomial fields or without them (endpoint scheme); scalars (2,) =
    (step size, delta_max); inv_mass (D,) or (D, D) float32, l_inv (D, D)
    with a dense one; key (2,) int32 with the host `call` index (the window
    index) when `draws` are not injected. Writes the new state into the
    state's tensors and returns it.
    """
    _check_inputs(info, n_iters, steps_per_iter, max_tree_depth, state, scalars,
                  inv_mass, key, draws, l_inv)
    if state.q.device.type == "cpu":
        return nuts_window_plain(info, n_iters, steps_per_iter, max_tree_depth,
                                 state, scalars, inv_mass, key, call, draws, l_inv)
    _kernel_device(state.q)
    state = _distinct(state)
    n_chains, dim = state.q.shape
    name = variant(state, inv_mass, info)
    if window_form(info) == "tiled":
        tile_geometry(n_chains, dim, info["params"]["n_data"], inv_mass.ndim == 2)
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    fields = _pointers([getattr(state, f) for f in KERNEL_FIELDS])
    injected = None if draws is None else _pointers(draws)
    params, data = target_args(info, state.q.device)
    code = lib.nuts_window_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, n_iters, steps_per_iter,
        max_tree_depth, int(state.q_sub is not None), int(inv_mass.ndim == 2),
        params, data, scalars.data_ptr(), inv_mass.data_ptr(), _ptr(l_inv), _ptr(key),
        call & _U32, fields, injected,
        torch.cuda.current_stream(state.q.device).cuda_stream)
    _raise_on_error(code, f"nuts_window_kernel ({name})")
    count_launch(nuts_window_kernel, name, info, state.q)
    return state


def reset_launches() -> None:
    """Set kernel 4's launch counts, total, per variant and per shape, to 0."""
    nuts_window_kernel.launches = 0
    nuts_window_kernel.variant_launches = dict.fromkeys(variant_names(VARIANTS.values()), 0)
    nuts_window_kernel.shape_launches = {}


reset_launches()


# What a window emits: the chain's current state, its snapshot reservoir and
# its accept statistic. The other float fields are the trajectory in flight.
EMITTED_FIELDS = ("q", "grad", "q_res", "lp", "lp_res", "alpha_acc")
IN_FLIGHT_FIELDS = tuple(f for f in FULL_FIELDS + FLOAT_FIELDS + MULTI_FULL_FIELDS
                         + MULTI_FLOAT_FIELDS + STACK_FIELDS
                         if f not in EMITTED_FIELDS)


def _chains_close(x: Tensor, y: Tensor, tol: float) -> Tensor:
    """(C,) bool: every entry of the chain within tol + tol |y| (a finite
    difference), or equal (infinities), or NaN in both."""
    diff = (x - y).abs()
    ok = (((diff <= tol + tol * y.abs()) & torch.isfinite(diff)) | (x == y)
          | (x.isnan() & y.isnan()))
    return ok.reshape(ok.shape[0], -1).all(dim=1)


def window_agreement(a: _PState, b: _PState, tol: float = 1e-4):
    """Hold one window's result against another's on the same inputs (the
    kernel against its plain version), chain by chain.

    A sum taken in another order rounds differently. A U-turn test is the
    sign of a dot product, so a near-zero sign can flip, after which the
    chain's tree differs for the rest of the window; and where the leapfrog
    is unstable (the funnel's neck at a large step) a rounding difference
    grows within a subtree until the trajectory diverges. So the result is
    per chain: (same: every counter and flag equal, emitted: the emitted
    state within tol, in_flight: the trajectory in flight within tol -- with
    the multinomial reservoir, log weights and checkpoint stacks --, err:
    the largest |a - b| of the emitted fields on the chains that are `same`
    and `emitted`)."""
    same = torch.ones_like(a.needs_start)
    for name in INT_FIELDS + BOOL_FIELDS + MULTI_BOOL_FIELDS:
        if getattr(a, name) is not None:
            same &= getattr(a, name) == getattr(b, name)
    emitted, in_flight = torch.ones_like(same), torch.ones_like(same)
    for names, ok in ((EMITTED_FIELDS, emitted), (IN_FLIGHT_FIELDS, in_flight)):
        for name in names:
            if getattr(a, name) is not None:
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
    """Build window(state, n_slots, step_size=None) -> state: one kernel 4
    call running n_slots // steps_per_iter machine iterations, its Philox
    key drawn once from `generator` and its call index the window's number.
    The state is the float32 _PState (its fields choose the scheme);
    inv_mass_matrix is (D,) or (D, D); the step size may be a device tensor,
    and a window's own `step_size` (the warmup's dual averaging) replaces
    it for that window."""
    info = kernel_info(value_and_grad_fn, "nuts")
    stream = PhiloxStream.from_generator(generator, device)
    scalars = nuts_scalars(step_size, delta_max, device)
    inv_mass, l_inv = kernel_metric(inv_mass_matrix.to(device))

    def window(ps: _PState, n_slots: int, step_size=None) -> _PState:
        own = scalars if step_size is None else nuts_scalars(step_size, delta_max, device)
        return nuts_window_kernel(info, n_slots // steps_per_iter, steps_per_iter,
                                  max_tree_depth, ps, own, inv_mass,
                                  key=stream.key, call=stream.next_call(),
                                  l_inv=l_inv)
    return window
