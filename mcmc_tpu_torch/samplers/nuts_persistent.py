"""Persistent (asynchronous) NUTS (port of
``mcmc_tpu/samplers/nuts_persistent.py``).

The transition is a per-chain state machine advanced one leapfrog per
global iteration: a chain that finishes its subtree does the doubling
bookkeeping in place (proposal update, U-turn test) and a chain whose
trajectory terminates starts its next transition at once, so chains never
wait for each other. Samples are emitted once every `steps_per_sample`
iterations: by default (`snapshot_mode="uniform"`) a uniformly chosen
completed transition of the window (a 1/k reservoir), or (`"last"`) the
last completed state, which is length-biased.

Two proposal schemes (the JAX module's docstring has the derivations):

- ``"endpoint"`` (default, reference semantics): subtree validity checked at
  the subtree ENDPOINT, a valid endpoint counting the whole 2^depth subtree;
  the slice variable log u = log U(0, 1] - h0; divergence when
  h - h0 > delta_max. A few percent underdispersed.
- ``"multinomial"`` (Stan's): every leaf enters a weighted reservoir with
  weight e^{h0 - h}; a finished subtree replaces the proposal with
  probability min(1, W_sub / W_tree); a divergent leaf or an internal U-turn
  of the subtree (the full recursive check set, from two checkpoint stacks)
  discards the subtree and ends the trajectory.

Both: alpha = exp(min(0, h0 - h)) accumulated over all integration steps,
a NaN mean falling back to 0.65; U-turn when (q_r - q_l) . p_l < 0 or
. p_r < 0 on raw momenta, for the diagonal and the dense metric alike;
termination evaluated after the doubling. A dense (D, D) M^{-1} draws the
momentum as z @ L^{-1} (M^{-1} = L L^T) and moves with v = M^{-1} p.

Two backends. ``"eager"`` is the counterpart of the JAX package's "xla":
one masked leapfrog per iteration in plain PyTorch, any target, randomness
drawn per window from a torch.Generator in the JAX xs layout. ``"fused"`` is
the counterpart of "pallas": each window is one call of the hand-written
CUDA kernel of ``mcmc_tpu_torch.ops.fused_nuts`` (its plain PyTorch version
on the CPU), W leapfrog slots per machine iteration, Philox randomness.
Both run the same iteration (``_machine_iteration``), so W = 1 is the
eager machine exactly (a dense metric's products summed in another order).

Counters are int32 per chain and int64 totals; the JAX package's f32 rows
and ``_count_dtype`` exist for Mosaic and for JAX without x64, and have no
counterpart here.
"""

from typing import Callable, NamedTuple, Optional

import torch

from mcmc_tpu_torch import precision
from mcmc_tpu_torch.samplers.base import (ChainState, RunResult,
                                          init_chain_state, make_value_and_grad)
from mcmc_tpu_torch.samplers.trajectory import (as_scalar, dense_unwhitening,
                                                kinetic_energy, velocity)

Tensor = torch.Tensor

STEPS_PER_ITER = (4, 2, 1)   # fused backend's W, largest dividing the windows
NAN_ACCEPT_FALLBACK = 0.65
PROPOSAL_SCHEMES = ("endpoint", "multinomial")


class _PState(NamedTuple):
    """Batched per-chain persistent-NUTS machine state (leading axis =
    chains). Position-like fields are (C, D) in the position dtype; lp-like
    scalars are (C,) in the energy dtype; counters (C,) int32; flags (C,)
    bool. The subtree size is 1 << depth. The multinomial fields are None
    under the endpoint scheme."""
    # last completed sample (the chain's current state)
    q: Tensor
    lp: Tensor
    grad: Tensor
    # trajectory endpoints
    q_l: Tensor
    p_l: Tensor
    g_l: Tensor
    q_r: Tensor
    p_r: Tensor
    g_r: Tensor
    # running proposal
    q_prop: Tensor
    lp_prop: Tensor
    g_prop: Tensor
    # advancing endpoint
    q_c: Tensor
    p_c: Tensor
    g_c: Tensor
    # per-transition scalars
    h0: Tensor
    log_u: Tensor
    n_valid: Tensor
    sum_alpha: Tensor
    n_steps: Tensor       # steps taken in the current trajectory
    depth: Tensor         # current subtree depth
    steps_left: Tensor    # leapfrogs left in the current subtree
    direction: Tensor     # position dtype, +/-1
    diverged: Tensor      # any divergent subtree endpoint this transition
    needs_start: Tensor   # start a fresh transition this iteration
    # accumulators (across transitions)
    transitions: Tensor
    divergences: Tensor
    alpha_acc: Tensor     # sum of per-transition mean alpha
    depth_acc: Tensor     # sum of terminal depths
    # snapshot reservoir: a uniformly chosen completed transition of the
    # current window (k_res completions so far)
    q_res: Tensor
    lp_res: Tensor
    k_res: Tensor
    # leapfrogs executed (every slot at W = 1; fewer with masked W > 1 slots)
    n_exec: Tensor
    # multinomial scheme: the subtree's weighted reservoir and log weights
    q_sub: Optional[Tensor] = None
    lp_sub: Optional[Tensor] = None
    g_sub: Optional[Tensor] = None
    lw_tree: Optional[Tensor] = None   # log sum of e^{h0 - h} over the tree
    lw_sub: Optional[Tensor] = None    # ... over the current subtree
    div_sub: Optional[Tensor] = None   # any divergent LEAF this subtree
    turn_sub: Optional[Tensor] = None  # any internal U-turn this subtree
    # checkpoint stacks (C, max_tree_depth, D): the state of every live
    # aligned-block start within the current subtree
    q_stk: Optional[Tensor] = None
    p_stk: Optional[Tensor] = None


def _init_pstate(q: Tensor, lp: Tensor, grad: Tensor, e_dtype: torch.dtype,
                 multinomial: bool = False, max_tree_depth: int = 10) -> _PState:
    """Fresh machine state at (q, lp, grad), with the multinomial fields
    when `multinomial`. Every field gets its own buffer and none is the
    caller's, because the fused window writes the state in place."""
    C, D = q.shape
    lp = lp.to(e_dtype)

    def z(dtype=e_dtype):
        return torch.zeros(C, dtype=dtype, device=q.device)
    extra = {}
    if multinomial:
        def stack():
            return torch.zeros((C, max_tree_depth, D), dtype=q.dtype, device=q.device)
        extra = dict(q_sub=q.clone(), lp_sub=lp.clone(), g_sub=grad.clone(),
                     lw_tree=z(), lw_sub=z(), div_sub=z(torch.bool),
                     turn_sub=z(torch.bool), q_stk=stack(), p_stk=stack())
    return _PState(
        q=q.clone(), lp=lp.clone(), grad=grad.clone(),
        q_l=q.clone(), p_l=torch.zeros_like(q), g_l=grad.clone(),
        q_r=q.clone(), p_r=torch.zeros_like(q), g_r=grad.clone(),
        q_prop=q.clone(), lp_prop=lp.clone(), g_prop=grad.clone(),
        q_c=q.clone(), p_c=torch.zeros_like(q), g_c=grad.clone(),
        h0=z(), log_u=z(), n_valid=z(torch.int32), sum_alpha=z(),
        n_steps=z(torch.int32), depth=z(torch.int32), steps_left=z(torch.int32),
        direction=torch.ones(C, dtype=q.dtype, device=q.device),
        diverged=z(torch.bool),
        needs_start=torch.ones(C, dtype=torch.bool, device=q.device),
        transitions=z(torch.int32), divergences=z(torch.int32), alpha_acc=z(),
        depth_acc=z(torch.int32), q_res=q.clone(), lp_res=lp.clone(),
        k_res=z(torch.int32), n_exec=z(torch.int32), **extra,
    )


def _sign(bit: Tensor, dtype: torch.dtype) -> Tensor:
    return torch.where(bit, 1.0, -1.0).to(dtype)


def _lse(a: Tensor, b: Tensor) -> Tensor:
    """log(e^a + e^b) as the kernels compute it, max + log1p(exp(min - max)),
    and -inf when both are -inf (where that form gives NaN)."""
    mx, mn = torch.maximum(a, b), torch.minimum(a, b)
    return torch.where(mx == -torch.inf, mx, mx + torch.log1p(torch.exp(mn - mx)))


def _popcount(x: Tensor, n_bits: int) -> Tensor:
    return sum((x >> b) & 1 for b in range(n_bits))


def _leaf(s: _PState, live, qn, p, lp_n, grad_n, h, su, steps_left,
          delta_max) -> _PState:
    """The multinomial scheme's update of s's subtree fields by a slot's
    leaf (qn, p, h), on the `live` chains: the weighted reservoir, the
    divergent-leaf flag and the checkpoint stacks. Leaf i (0-based) of the
    subtree STORES its state at stack slot popcount(i >> 1) when even; when
    odd it CHECKS the U-turn criterion against slots popcount(i >> 1) -
    trailing_ones(i) + 1 .. popcount(i >> 1), the recursion's check set
    (block [k 2^j, (k+1) 2^j - 1] fires at its last leaf against its
    first), the displacement oriented by the subtree's direction."""
    def w(m, a, b):
        return torch.where(m[:, None], a, b)
    fin = torch.isfinite(h)
    lw_leaf = torch.where(fin, s.h0 - h, -torch.inf)
    div_leaf = ~fin | ((h - s.h0) > delta_max)
    lse = _lse(s.lw_sub, lw_leaf)
    # both weights -inf: lw_leaf - lse is NaN, and no dead leaf is taken
    dead = (lw_leaf == -torch.inf) & (s.lw_sub == -torch.inf)
    take = live & ~dead & (su < torch.exp(lw_leaf - lse))

    n_slots = s.q_stk.shape[1]
    i_leaf = (torch.ones_like(s.depth) << s.depth) - steps_left - 1
    even = (i_leaf & 1) == 0
    slot = _popcount(i_leaf >> 1, n_slots + 1)
    t_ones = _popcount(i_leaf ^ (i_leaf + 1), n_slots + 1) - 1
    srange = torch.arange(n_slots, device=qn.device)[None, :]
    store = (live & even)[:, None] & (srange == slot[:, None])
    q_stk = torch.where(store[..., None], qn[:, None, :], s.q_stk)
    p_stk = torch.where(store[..., None], p[:, None, :], s.p_stk)
    check = ((live & ~even)[:, None] & (srange >= (slot - t_ones + 1)[:, None])
             & (srange <= slot[:, None]))
    dq = (qn[:, None, :] - q_stk) * s.direction[:, None, None]
    turning = check & ((torch.sum(dq * p_stk, dim=-1) < 0)
                       | (torch.sum(dq * p[:, None, :], dim=-1) < 0))
    return s._replace(
        q_sub=w(take, qn, s.q_sub), g_sub=w(take, grad_n, s.g_sub),
        lp_sub=torch.where(take, lp_n, s.lp_sub),
        lw_sub=torch.where(live, lse, s.lw_sub),
        div_sub=s.div_sub | (live & div_leaf),
        turn_sub=s.turn_sub | turning.any(dim=1), q_stk=q_stk, p_stk=p_stk)


def _machine_iteration(s: _PState, draws, vag: Callable, step_size: Tensor,
                       inv_mass: Tensor, max_tree_depth: int, delta_max,
                       slots: int = 1, l_inv: Optional[Tensor] = None,
                       matmul: Callable = torch.matmul) -> _PState:
    """One machine iteration of every chain: fresh-transition start, `slots`
    leapfrog slots (slot 0 always live; a later slot only for chains whose
    subtree is still open), then the subtree-boundary bookkeeping once.

    draws: (z (C, D) standard normals, dir_bit (C,) bool, dir2_bit (C,)
    bool, swap_u, slice_u, res_u (C,)); under the multinomial scheme (the
    state carries q_sub) slice_u holds one uniform per slot, (slots, C) or
    (C,) at one slot, slot 0's doubling as the start's slice variable.
    inv_mass is (D,) or (D, D); a dense one needs its l_inv (L^{-1}), and
    its products go through `matmul` (the kernel's plain version passes
    trajectory.ordered_matmul, the kernel's summation order).
    slots = 1 is the JAX XLA machine (`_make_window_step`), slots = W the
    fused window kernel's iteration (`ops/fused_nuts.py:_make_kernel`)."""
    z, dir_bit, dir2_bit, swap_u, slice_u, res_u = draws
    pos_dtype, e_dtype = s.q.dtype, s.lp.dtype
    multinomial = s.q_sub is not None
    su_all = slice_u.reshape(slots, -1) if multinomial else slice_u[None]

    def w(m, a, b):
        return torch.where(m[:, None], a, b)

    # --- 1. fresh-transition start (chains flagged needs_start) -----------
    st = s.needs_start
    p0 = matmul(z, l_inv) if inv_mass.ndim == 2 else z / torch.sqrt(inv_mass)
    h0_new = -s.lp + kinetic_energy(p0, inv_mass, matmul).to(e_dtype)
    log_u_new = torch.log(su_all[0]).to(e_dtype) - h0_new
    s = s._replace(
        q_l=w(st, s.q, s.q_l), p_l=w(st, p0, s.p_l), g_l=w(st, s.grad, s.g_l),
        q_r=w(st, s.q, s.q_r), p_r=w(st, p0, s.p_r), g_r=w(st, s.grad, s.g_r),
        q_prop=w(st, s.q, s.q_prop), lp_prop=torch.where(st, s.lp, s.lp_prop),
        g_prop=w(st, s.grad, s.g_prop),
        q_c=w(st, s.q, s.q_c), p_c=w(st, p0, s.p_c), g_c=w(st, s.grad, s.g_c),
        h0=torch.where(st, h0_new, s.h0),
        log_u=torch.where(st, log_u_new, s.log_u),
        n_valid=torch.where(st, 1, s.n_valid),
        sum_alpha=torch.where(st, 0.0, s.sum_alpha),
        n_steps=torch.where(st, 0, s.n_steps),
        depth=torch.where(st, 0, s.depth),
        steps_left=torch.where(st, 1, s.steps_left),
        direction=torch.where(st, _sign(dir_bit, pos_dtype), s.direction),
        diverged=s.diverged & ~st,
        needs_start=torch.zeros_like(st),
    )
    if multinomial:
        # the initial state is the root tree with weight e^0 = 1; the
        # subtree reservoir starts empty
        s = s._replace(
            q_sub=w(st, s.q, s.q_sub), lp_sub=torch.where(st, s.lp, s.lp_sub),
            g_sub=w(st, s.grad, s.g_sub),
            lw_tree=torch.where(st, 0.0, s.lw_tree),
            lw_sub=torch.where(st, -torch.inf, s.lw_sub),
            div_sub=s.div_sub & ~st, turn_sub=s.turn_sub & ~st)

    # --- 2. leapfrog slots --------------------------------------------------
    eps = (s.direction * step_size)[:, None]
    q_c, p_c, g_c = s.q_c, s.p_c, s.g_c
    lp_c, h_c = s.lp, s.h0
    sum_alpha, n_steps, n_exec, steps_left = (s.sum_alpha, s.n_steps, s.n_exec,
                                              s.steps_left)
    for k in range(slots):
        p = p_c + 0.5 * eps * g_c
        qn = q_c + eps * velocity(p, inv_mass, matmul)
        lp_n, grad_n = vag(qn)
        lp_n = lp_n.to(e_dtype)
        grad_n = grad_n.to(pos_dtype)
        p = p + 0.5 * eps * grad_n
        h = -lp_n + kinetic_energy(p, inv_mass, matmul).to(e_dtype)
        alpha = torch.exp(torch.clamp(s.h0 - h, max=0.0))
        if k == 0:
            q_c, p_c, g_c, lp_c, h_c = qn, p, grad_n, lp_n, h
            live = torch.ones_like(st)
            sum_alpha = sum_alpha + alpha
        else:
            live = steps_left > 0
            q_c, p_c, g_c = w(live, qn, q_c), w(live, p, p_c), w(live, grad_n, g_c)
            lp_c = torch.where(live, lp_n, lp_c)
            h_c = torch.where(live, h, h_c)
            sum_alpha = sum_alpha + torch.where(live, alpha, 0.0)
        step = live.to(torch.int32)
        n_steps, n_exec, steps_left = n_steps + step, n_exec + step, steps_left - step
        if multinomial:
            s = _leaf(s, live, qn, p, lp_n, grad_n, h, su_all[k], steps_left,
                      delta_max)

    # --- 3. subtree-boundary bookkeeping -------------------------------------
    bd = steps_left <= 0
    go_right = s.direction > 0
    left, right = bd & ~go_right, bd & go_right
    q_l, p_l, g_l = w(left, q_c, s.q_l), w(left, p_c, s.p_l), w(left, g_c, s.g_l)
    q_r, p_r, g_r = w(right, q_c, s.q_r), w(right, p_c, s.p_r), w(right, g_c, s.g_r)

    if multinomial:
        # biased progressive subtree merge (Stan): the finished subtree
        # replaces the proposal w.p. min(1, W_sub / W_tree); a subtree with
        # a divergent leaf or an internal U-turn is discarded whole
        sub_ok = bd & ~s.div_sub & ~s.turn_sub & torch.isfinite(s.lw_sub)
        ratio = torch.exp(torch.clamp(s.lw_sub - s.lw_tree, max=0.0))
        take = sub_ok & (swap_u < ratio)
        q_prop = w(take, s.q_sub, s.q_prop)
        lp_prop = torch.where(take, s.lp_sub, s.lp_prop)
        g_prop = w(take, s.g_sub, s.g_prop)
        lw_tree = torch.where(sub_ok, _lse(s.lw_tree, s.lw_sub), s.lw_tree)
        diverged = s.diverged | (bd & s.div_sub)
        total = s.n_valid
    else:
        # endpoint-validity proposal swap (reference NUTS.py:319-336)
        in_slice = s.log_u <= -h_c
        div_new = (h_c - s.h0) > delta_max
        valid = bd & in_slice & ~div_new
        n_new = torch.where(valid, torch.ones_like(s.depth) << s.depth, 0)
        total = s.n_valid + torch.where(bd, n_new, 0)
        swap_prob = torch.where(
            valid & (total > 0),
            n_new.to(torch.float32) / torch.clamp(total, min=1).to(torch.float32),
            0.0)
        take = bd & (swap_u < swap_prob)
        q_prop = w(take, q_c, s.q_prop)
        lp_prop = torch.where(take, lp_c, s.lp_prop)
        g_prop = w(take, g_c, s.g_prop)
        diverged = s.diverged | (bd & div_new)

    # termination, evaluated after the doubling (reference while cond); the
    # raw-momentum test for both metrics
    dq = q_r - q_l
    u_turn = (torch.sum(dq * p_l, dim=-1) < 0) | (torch.sum(dq * p_r, dim=-1) < 0)
    stop = (s.depth + 1 >= max_tree_depth) | u_turn | diverged
    if multinomial:
        stop = stop | s.turn_sub          # invalid subtree: stop here
    term = bd & stop
    cont = bd & ~term

    # transition completes: adopt the proposal, log stats, flag a fresh start
    mean_alpha = sum_alpha / torch.clamp(n_steps, min=1).to(e_dtype)
    mean_alpha = torch.where(torch.isfinite(mean_alpha), mean_alpha,
                             NAN_ACCEPT_FALLBACK)
    term_i = term.to(torch.int32)
    k_res = s.k_res + term_i
    # the k-th completion of the window replaces the reservoir w.p. 1/k
    take_res = term & (res_u * k_res.to(torch.float32) < 1.0)

    # trajectory continues: next doubling from the chosen end
    new_dir = _sign(dir2_bit, pos_dtype)
    nxt_right, nxt_left = cont & (new_dir > 0), cont & (new_dir <= 0)
    depth = torch.where(cont, s.depth + 1, s.depth)
    s = s._replace(
        q=w(term, q_prop, s.q), lp=torch.where(term, lp_prop, s.lp),
        grad=w(term, g_prop, s.grad),
        q_l=q_l, p_l=p_l, g_l=g_l, q_r=q_r, p_r=p_r, g_r=g_r,
        q_prop=q_prop, lp_prop=lp_prop, g_prop=g_prop,
        q_c=w(nxt_right, q_r, w(nxt_left, q_l, q_c)),
        p_c=w(nxt_right, p_r, w(nxt_left, p_l, p_c)),
        g_c=w(nxt_right, g_r, w(nxt_left, g_l, g_c)),
        n_valid=total, sum_alpha=sum_alpha, n_steps=n_steps, depth=depth,
        steps_left=torch.where(cont, torch.ones_like(depth) << depth, steps_left),
        direction=torch.where(cont, new_dir, s.direction),
        diverged=diverged, needs_start=term,
        transitions=s.transitions + term_i,
        divergences=s.divergences + (term & diverged).to(torch.int32),
        alpha_acc=s.alpha_acc + torch.where(term, mean_alpha, 0.0),
        depth_acc=s.depth_acc + torch.where(term, s.depth + 1, 0),
        q_res=w(take_res, q_prop, s.q_res),
        lp_res=torch.where(take_res, lp_prop, s.lp_res),
        k_res=k_res, n_exec=n_exec,
    )
    if multinomial:
        # fresh subtree: an empty weight reservoir (its first leaf always
        # replaces q_sub, so the stale contents are never observable)
        s = s._replace(lw_tree=lw_tree,
                       lw_sub=torch.where(cont, -torch.inf, s.lw_sub),
                       div_sub=s.div_sub & ~cont, turn_sub=s.turn_sub & ~cont)
    return s


def _make_window_step(value_and_grad_batched: Callable, step_size,
                      inv_mass: Tensor, max_tree_depth: int, delta_max,
                      proposal_scheme: str = "endpoint") -> Callable:
    """One global iteration of the eager machine: step(state, xs) -> state
    with xs = (p0_row (C, D) standard normals, dir_bit, dir2_bit, swap_u,
    slice_u, res_u (C,)) -- the JAX XLA machine's step, one leapfrog per
    iteration. value_and_grad_batched: (C, D) -> ((C,), (C, D)). The energy
    dtype is the state's own (the JAX step's e_dtype argument); the state
    must carry the scheme's fields (_init_pstate(multinomial=...)). A dense
    inv_mass is factored here, once."""
    _check_scheme(proposal_scheme)
    multinomial = proposal_scheme == "multinomial"
    l_inv = dense_unwhitening(inv_mass) if inv_mass.ndim == 2 else None

    def step(s: _PState, xs) -> _PState:
        if (s.q_sub is not None) != multinomial:
            raise ValueError(f"the state does not carry the {proposal_scheme} "
                             f"scheme's fields")
        eps = as_scalar(step_size, s.q.dtype, s.q.device)
        return _machine_iteration(s, xs, value_and_grad_batched, eps, inv_mass,
                                  max_tree_depth, delta_max, slots=1, l_inv=l_inv)
    return step


def _check_scheme(proposal_scheme: str) -> None:
    if proposal_scheme not in PROPOSAL_SCHEMES:
        raise ValueError(f"unknown proposal_scheme: {proposal_scheme!r}")


def draw_window(generator: torch.Generator, n: int, n_chains: int, dim: int,
                pos_dtype: torch.dtype):
    """The eager machine's randomness for n iterations, in the JAX xs layout
    (`nuts_persistent.py:588-596` there): p0 (n, C, D) normals, two
    (n, C) direction bit streams, swap, slice (never 0) and reservoir
    uniforms (n, C). At one slot per iteration the slice stream is also the
    multinomial scheme's per-slot leaf uniform."""
    kw = dict(generator=generator, device=generator.device)
    p0 = torch.randn((n, n_chains, dim), dtype=pos_dtype, **kw)
    dirs = torch.rand((n, n_chains), **kw) < 0.5
    dirs2 = torch.rand((n, n_chains), **kw) < 0.5
    swaps = torch.rand((n, n_chains), **kw)
    slices = torch.rand((n, n_chains), **kw).clamp_min(torch.finfo(torch.float32).tiny)
    ress = torch.rand((n, n_chains), **kw)
    return p0, dirs, dirs2, swaps, slices, ress


def _resolve_backend(backend: str, value_and_grad_fn, device) -> str:
    """"auto" -> "fused" for CUDA tensors and a target kernel 4 dispatches
    on, else "eager". An explicit "fused" with an untagged target raises
    TypeError, with a family kernel 4 lacks KeyError."""
    from mcmc_tpu_torch.ops.padded_targets import KERNEL_FAMILIES, kernel_info
    if backend == "auto":
        info = getattr(value_and_grad_fn, "kernel_info", None)
        if (torch.device(device).type == "cuda" and info is not None
                and info["family"] in KERNEL_FAMILIES["nuts"]):
            return "fused"
        return "eager"
    if backend == "fused":
        if value_and_grad_fn is None:
            raise TypeError("the fused backend requires an analytic "
                            "value_and_grad_fn from mcmc_tpu_torch.targets")
        kernel_info(value_and_grad_fn, "nuts")
        return backend
    if backend == "eager":
        return backend
    raise ValueError(f"unknown backend {backend!r}; use 'auto', 'eager' or 'fused'")


def _reset_counters(ps: _PState) -> _PState:
    return ps._replace(**{f: torch.zeros_like(getattr(ps, f)) for f in (
        "transitions", "divergences", "alpha_acc", "depth_acc", "k_res")})


def nuts_run_persistent(
    generator: torch.Generator,
    log_prob_fn,
    init_position: Tensor,
    step_size,
    num_samples: int,
    steps_per_sample: int = 64,
    burn_in_steps: int = 0,
    inv_mass_matrix: Optional[Tensor] = None,
    max_tree_depth: int = 10,
    delta_max=1000.0,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
    steps_per_iter: Optional[int] = None,
    snapshot_mode: str = "uniform",
    proposal_scheme: str = "endpoint",
) -> RunResult:
    """Asynchronous NUTS: `num_samples` snapshots, one every
    `steps_per_sample` global leapfrog iterations (slots).

    info carries per-chain transition counts, mean accept prob, mean
    terminal depth and divergence stats with the JAX package's keys;
    n_leapfrogs is the int64 total of leapfrogs executed, n_leapfrog_slots
    the slots run ((burn_in_steps + num_samples * steps_per_sample) * C).

    inv_mass_matrix: None (unit), a (D,) diagonal or a (D, D) dense M^{-1},
    factored once per run. proposal_scheme: "endpoint" (reference semantics)
    or "multinomial" (Stan's); both schemes and both metrics run on both
    backends.

    backend: "eager" (any target, a Python loop of one-leapfrog iterations),
    "fused" (one kernel 4 call per window; a tagged target), or "auto"
    (fused for CUDA tensors and a tagged target). steps_per_iter (fused
    only): leapfrog slots per machine iteration W, a runtime kernel
    argument; steps_per_sample and burn_in_steps must be divisible by it;
    None picks the largest of (4, 2, 1) that divides both. The step size may
    be a device tensor: nothing in the run reads it back on the host.

    `generator` must live on the positions' device; the fused backend draws
    its two Philox key words from it once per run. Unlike the JAX function,
    there is no `chain_tile`: the CUDA kernel runs one warp per chain.
    """
    if snapshot_mode not in ("uniform", "last"):
        raise ValueError(f"unknown snapshot_mode: {snapshot_mode!r}")
    _check_scheme(proposal_scheme)
    pos = init_position if init_position.ndim == 2 else init_position[None]
    resolved = _resolve_backend(backend, value_and_grad_fn, pos.device)
    if resolved == "eager" and steps_per_iter not in (None, 1):
        raise ValueError("steps_per_iter > 1 requires the fused backend")
    if resolved == "fused":
        if steps_per_iter is None:
            steps_per_iter = next(w for w in STEPS_PER_ITER
                                  if steps_per_sample % w == 0
                                  and burn_in_steps % w == 0)
        if steps_per_sample % steps_per_iter or burn_in_steps % steps_per_iter:
            raise ValueError("steps_per_sample and burn_in_steps must be "
                             "divisible by steps_per_iter")

    state0 = init_chain_state(pos, log_prob_fn, value_and_grad_fn,
                              needs_grad=True)
    C, D = state0.position.shape
    pos_dtype = state0.position.dtype
    e_dtype = precision.energy_dtype(pos_dtype)
    device = state0.position.device
    if inv_mass_matrix is None:
        inv_mass_matrix = torch.ones(D, dtype=pos_dtype, device=device)

    if resolved == "fused":
        from mcmc_tpu_torch.ops.fused_nuts import make_fused_nuts_window
        window = make_fused_nuts_window(
            value_and_grad_fn, generator, step_size, inv_mass_matrix,
            max_tree_depth, delta_max, steps_per_iter, device)
        m_dtype = torch.float32
    else:
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
        inv_mass = inv_mass_matrix.to(device=device, dtype=pos_dtype)
        step = _make_window_step(vag, step_size, inv_mass, max_tree_depth,
                                 delta_max, proposal_scheme)

        def window(ps, n):
            for xs in zip(*draw_window(generator, n, C, D, pos_dtype)):
                ps = step(ps, xs)
            return ps
        m_dtype = pos_dtype

    ps = _init_pstate(state0.position.to(m_dtype), state0.log_prob,
                      state0.grad_log_prob.to(m_dtype),
                      precision.energy_dtype(m_dtype),
                      multinomial=proposal_scheme == "multinomial",
                      max_tree_depth=max_tree_depth)
    if burn_in_steps > 0:
        ps = _reset_counters(window(ps, burn_in_steps))

    n_collect = collect_chains or C
    samples = torch.empty((num_samples, n_collect, D), dtype=pos_dtype, device=device)
    lps = torch.empty((num_samples, n_collect), dtype=e_dtype, device=device)
    for i in range(num_samples):
        ps = window(ps, steps_per_sample)
        if snapshot_mode == "uniform":
            # a uniformly chosen completed transition of this window; a
            # window with no completion falls back to the last completed state
            got = ps.k_res[:n_collect] > 0
            samples[i] = torch.where(got[:, None], ps.q_res[:n_collect],
                                     ps.q[:n_collect])
            lps[i] = torch.where(got, ps.lp_res[:n_collect], ps.lp[:n_collect])
            ps = ps._replace(k_res=torch.zeros_like(ps.k_res))
        else:
            samples[i] = ps.q[:n_collect]
            lps[i] = ps.lp[:n_collect]
    return _finalize(ps, samples, lps, pos_dtype, e_dtype,
                     (burn_in_steps + num_samples * steps_per_sample) * C)


def _finalize(ps: _PState, samples, lps, pos_dtype, e_dtype,
              n_slots: int) -> RunResult:
    trans = torch.clamp(ps.transitions, min=1)
    mean_accept = (ps.alpha_acc / trans.to(ps.alpha_acc.dtype)).to(e_dtype)
    total_div = torch.sum(ps.divergences, dtype=torch.int64)
    total_trans = torch.sum(ps.transitions, dtype=torch.int64)
    final_q = ps.q.to(pos_dtype)
    info = {
        "divergence_count": ps.divergences,
        "total_divergences": total_div,
        "divergence_rate": total_div.to(torch.float32)
        / torch.clamp(total_trans, min=1).to(torch.float32),
        "transitions": ps.transitions,
        "mean_accept_probs": mean_accept,
        "mean_tree_depth": ps.depth_acc.to(torch.float32) / trans,
        "n_leapfrogs": torch.sum(ps.n_exec, dtype=torch.int64),
        "n_leapfrogs_per_chain": ps.n_exec,
        "n_leapfrog_slots": torch.full((), n_slots, dtype=torch.int64,
                                       device=ps.q.device),
        "final_positions": final_q,
    }
    final_state = ChainState(
        position=final_q, log_prob=ps.lp.to(e_dtype),
        grad_log_prob=ps.grad.to(pos_dtype), accept_count=ps.transitions,
        divergence_count=ps.divergences)
    return RunResult(samples, lps, mean_accept.to(torch.float32), final_state,
                     info)
