"""Fused multi-transition RWMH: CUDA kernel wrapper and its plain version.

Port of ``mcmc_tpu/ops/fused_rwmh.py``. One kernel, in
``mcmc_tpu_torch/csrc/fused_rwmh.cu``: ``rwmh_multistep_kernel`` runs T
random-walk Metropolis transitions per call with the chain state on chip
(the TPU ``_make_rwmh_kernel``). Per transition: q' = q + scale * eps, the
target's log-density only, accept if log u < min(0, lp' - lp), select, and
the accept and history writes.

The wrapper takes its plain PyTorch version ONLY for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. It counts its launches in
``.launches``.

Randomness: injected (``noise`` (T, C, D) and ``u`` (T, C)) or drawn in the
kernel from the Philox stream of ``ops/fused_trajectory.py`` with the same
counters: noise coordinate d of transition t from draw d // 4, the accept
uniform from draw ``ACCEPT_DRAW``, so ``philox_normal`` / ``philox_uniform``
are exactly the plain version's draws.

History: the kernel writes q and lp after each transition for the first
``n_hist`` chains only -- the harness keeps ``hist[:, :n_collect]`` and
nothing else (``samplers/base.py``), so writing (T, C, D) would be wasted
device traffic. The values equal a full write followed by the slice.
"""

from typing import Optional

import torch

from mcmc_tpu_torch.ops.fused_trajectory import (
    MAX_DIM, PhiloxStream, _f32, _kernel_device, _ptr, _raise_on_error, _U32,
    check_tensors, philox_normal, philox_uniform)
from mcmc_tpu_torch.ops.padded_targets import FAMILY_IDS, device_vag, kernel_info
from mcmc_tpu_torch.samplers.trajectory import as_scalar

Tensor = torch.Tensor


def rwmh_scale(scale, device) -> Tensor:
    """The (1,) float32 device tensor of the proposal scale the kernel reads;
    a tensor scale stays on the device."""
    return as_scalar(scale, torch.float32, device).reshape(1)


def rwmh_multistep_plain(info: dict, transitions: int, q: Tensor, lp: Tensor,
                         scale: Tensor, n_hist: int,
                         key: Optional[Tensor] = None, call: int = 0,
                         noise: Optional[Tensor] = None,
                         u: Optional[Tensor] = None):
    """Plain PyTorch version of rwmh_multistep_kernel, on any device (same
    arguments and results)."""
    n_chains, dim = q.shape
    vag = device_vag(info)
    accs, hist_q, hist_lp = [], [], []
    for t in range(transitions):
        if noise is None:
            eps = philox_normal(key, call, t, n_chains, dim, q.device)
            u_t = philox_uniform(key, call, t, n_chains, q.device)
        else:
            eps, u_t = noise[t], u[t]
        prop = q + scale * eps
        lp1, _ = vag(prop)
        accept = torch.log(u_t) < torch.clamp(lp1 - lp, max=0.0)
        q = torch.where(accept[:, None], prop, q)
        lp = torch.where(accept, lp1, lp)
        accs.append(accept)
        hist_q.append(q[:n_hist])
        hist_lp.append(lp[:n_hist])
    return q, lp, torch.stack(accs), torch.stack(hist_q), torch.stack(hist_lp)


def _check_inputs(info, transitions, q, lp, scale, n_hist, key, noise, u):
    n_chains, dim = q.shape
    if dim != info["dim"]:
        raise ValueError(f"positions have dim {dim}, target has {info['dim']}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the fused kernels take 1 <= dim <= {MAX_DIM}, got {dim}")
    if n_chains < 1 or transitions < 1:
        raise ValueError("need at least one chain and one transition")
    if not 0 <= n_hist <= n_chains:
        raise ValueError(f"n_hist must lie in [0, {n_chains}], got {n_hist}")
    if (noise is None) != (u is None):
        raise ValueError("inject both noise and u, or neither")
    if noise is None and key is None:
        raise ValueError("need a Philox key or injected noise and u")
    expected = {"q": (q, (n_chains, dim)), "lp": (lp, (n_chains,)),
                "scale": (scale, (1,))}
    if noise is not None:
        expected["noise"] = (noise, (transitions, n_chains, dim))
        expected["u"] = (u, (transitions, n_chains))
    check_tensors(expected, q.device, key)


def rwmh_multistep_kernel(info: dict, transitions: int, q: Tensor, lp: Tensor,
                          scale: Tensor, n_hist: int,
                          key: Optional[Tensor] = None, call: int = 0,
                          noise: Optional[Tensor] = None,
                          u: Optional[Tensor] = None):
    """T = `transitions` fused RWMH transitions of every chain (kernel 3).

    q (C, D), lp (C,), scale (1,), injected noise (T, C, D) and u (T, C):
    float32, contiguous. key (2,) int32 with the host `call` index when
    noise/u are not injected. Returns (q, lp, accept (T, C) bool,
    hist_q (T, n_hist, D), hist_lp (T, n_hist)), the histories holding the
    first n_hist chains' post-transition state.
    """
    _check_inputs(info, transitions, q, lp, scale, n_hist, key, noise, u)
    if q.device.type == "cpu":
        return rwmh_multistep_plain(info, transitions, q, lp, scale, n_hist,
                                    key, call, noise, u)
    _kernel_device(q)
    n_chains, dim = q.shape
    from mcmc_tpu_torch.ops import _cuda
    lib = _cuda.load_library().lib
    q_out, lp_out = torch.empty_like(q), torch.empty_like(lp)
    acc = torch.empty((transitions, n_chains), dtype=torch.bool, device=q.device)
    hist_q = q.new_empty((transitions, n_hist, dim))
    hist_lp = lp.new_empty((transitions, n_hist))
    code = lib.rwmh_multistep_launch(
        FAMILY_IDS[info["family"]], dim, n_chains, transitions, n_hist,
        scale.data_ptr(), _ptr(key), call & _U32, q.data_ptr(), lp.data_ptr(),
        _ptr(noise), _ptr(u), q_out.data_ptr(), lp_out.data_ptr(),
        acc.data_ptr(), hist_q.data_ptr(), hist_lp.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(code, "rwmh_multistep_kernel")
    rwmh_multistep_kernel.launches += 1
    return q_out, lp_out, acc, hist_q, hist_lp


rwmh_multistep_kernel.launches = 0


def make_fused_rwmh_multistep(value_and_grad_fn, transitions: int,
                              n_hist: Optional[int] = None):
    """Build multi(stream, state, scale) -> (new_state, (accept (T, C),
    hist_q (T, n_hist, D), hist_lp (T, n_hist))) running T = `transitions`
    RWMH transitions per kernel 3 call; n_hist None keeps every chain. Pass
    the scale as a device tensor (rwmh_scale) to build it once per run.

    `value_and_grad_fn` must carry a ``kernel_info`` tag
    (mcmc_tpu_torch.targets); only its log-density runs. `stream` is a
    PhiloxStream on the state's device. Raises TypeError for an untagged
    target and KeyError for a family without a device function."""
    if value_and_grad_fn is None:
        raise TypeError("the fused backend requires an analytic "
                        "value_and_grad_fn from mcmc_tpu_torch.targets")
    info = kernel_info(value_and_grad_fn)

    def multi(stream: PhiloxStream, state, scale):
        n = state.position.shape[0] if n_hist is None else n_hist
        q1, lp1, accept, hist_q, hist_lp = rwmh_multistep_kernel(
            info, transitions, _f32(state.position), _f32(state.log_prob),
            rwmh_scale(scale, state.position.device), n, key=stream.key,
            call=stream.next_call())
        new_state = state._replace(
            position=q1.to(state.position.dtype),
            log_prob=lp1.to(state.log_prob.dtype),
            accept_count=state.accept_count
            + torch.sum(accept, dim=0, dtype=torch.int32))
        return new_state, (accept, hist_q.to(state.position.dtype),
                           hist_lp.to(state.log_prob.dtype))

    return multi
