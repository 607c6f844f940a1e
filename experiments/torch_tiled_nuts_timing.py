"""Kernel 4's block-tiled data-carrying variant 4c (and its multinomial
form, 4a's data form) against the warp-per-chain kernel it replaces, with
the dense variants 4b and 4a+4b (warp per chain) and kernel 3's
block-tiled 3a beside them, on one CUDA card.

    python experiments/torch_tiled_nuts_timing.py [--parent DIR] [--tree .]
        [--variant LABEL=DIR ...] [--patched NAME[+NAME...] ...]
        [--skip-lockstep] [--out _archive/tiled_nuts_out]
        [--work _archive/tiled_nuts] [--skip-timing]

DIR is an unpacked tree of the commit before the redesign (`git archive`);
--tree the tree under test; each --variant another tree (a copy of the tree
with another constant, say chains a block) timed in the same turns. Each
--patched adds the variant NAME: a copy of the tree under --work with the
edits PATCHES[NAME] applied (several joined by "+"): "tile-skip", the
tiled products keeping each chain in its own column and skipping the
chain tiles of RC chains with no live chain instead of compacting the live
chains' rows into the first tiles (the two ways a slot's products can take
only the live chains); "sums-2", the warp-per-chain dense products
(metric.cuh:DenseMetric) as two interleaved partial sums joined at the
end; "k1-reordered", those products at K = 1 (D <= 32) in the four-term
steps of the other K instead of the loop over i alone; "k1-common-bound",
4b at K = 1 under the warp window's common launch bound instead of its
own; "dense-3-blocks", the warp window under the dense
metric and the endpoint scheme held to 3 resident blocks an SM (85
registers a thread). Every tree's kernel-4 and 3a outputs are compared bit
for bit with the parent's, or without --parent with the tree's, but a
variant that changes the products' order ("sums-2") has its warp windows
under the dense metric left out. The script

1. builds every tree's kernel library, one process per tree, at once;
2. prints each kernel instance's ptxas line (registers, shared memory,
   spills) that differs between the parent and the tree, every instance the
   tree adds or drops, and the new instances' lines;
3. (unless --skip-lockstep) measures the lockstep (in the tree; any
   tree's kernel gives the same counts): the windows chip_smoke.py's [6b] and [6f] time -- 4b and 4a+4b
   at 65,536 x 50 (the rho = 0.9 correlated Gaussian, its oracle metric, the
   [5c] row's tuned step), 4c and 4a's data form at 8,192 x 100 (config 5
   after its warmup, the NUTS step tuned as [5k] tunes it), each two windows
   in -- run one iteration a call with the window's own draws injected, the
   slots each chain ran and its starts read per iteration; for blocks of 8,
   16 and 32 chains, the share of the blocks' warp-slots whose chain was
   live and the (block, iteration) pairs with a start (ops/fused_nuts.py:
   lockstep_counts);
4. runs kernel 4 in the parent and in the tree on the same inputs, two
   windows (8 iterations x W = 4) from a fresh state, and compares every
   output bit for bit: 4b and 4a+4b on each family at D 10 and 100 (the
   2- and 3-D families at theirs), at D 1, 32, 33, 64, 65 and 128 at ragged
   chain counts (1, 7, 9,
   31, 33, 8,191), at 65,536 x 50 (the correlated Gaussian with its oracle
   metric) and 65,536 x 100; 4c and 4a's data form with either metric
   at dim 9, 20 and 100 x n_data 50, 256 and 1,000, and at 8,192 x 100 x
   256; 3a (T = 8) at dim 9, 20 and 100 x n_data 50, 256 and 1,000 at
   1,000 chains, at 100 x 256 at 1, 7, 33 and 8,191 chains, and at 8,192
   x 100 x 256 with T = 32; injected draws and Philox;
5. times, in turns (parent, tree and variants, then back), 4b and 4a+4b at
   65,536 x 50 and 4c and 4a's data form at 8,192 x 100 (the windows of
   step 3, 16 iterations x W = 4, depth 10), 4b at Rosenbrock's 1,024 x 10
   (step 0.02, a random dense metric) and at 65,536 x 100 (the rho = 0.9
   Gaussian's oracle metric at the [5c] step), and as controls that no tree
   changes kernel 4 (the 50-D funnel, 65,536 chains) and kernel 1 (the same,
   L = 16) -- 4b and 4a+4b run the warp kernel in every tree (PERF.md
   section 6) --, 2a (the rho = 0.9 Gaussian's oracle metric, 4,096 x 50,
   T = 8, L = 16; Rosenbrock's 1,024 x 10, a random dense metric, L = 64),
   3a at 8,192 x 100 x 256 (config 5's warmed positions, T = 32) and at
   1,024 x 20 x 256 (T = 32), and kernel 3 at the RWMH row's 65,536 x 10
   (T = 32) as a control: CUDA events around bursts enqueued while the
   card sleeps, as
   chip_smoke.py's _event_ms; with the yardsticks: the window's dense
   products as torch.matmul(p, M^{-1}) calls (TF32 off), as many full
   batches as the window ran rows of them, config 5's eager
   value_and_grad, and 3a's 32 z-products as torch.matmul(q, X^T).

Step 2 needs --parent. Each measurement runs in a process of its own,
in the tree it measures. Prints the card's name and power limit; writes
the build logs, the lockstep counts and the times under --out, the trees'
compared outputs and the tuned inputs under --work (both gitignored).
Exits 1 if an output differs.
"""

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HOLD_CYCLES = 5_000_000
OUTPUT_WORKERS = 3        # trees whose outputs are computed at once (the host has 8 cores)
BUILD_TREES = 5           # trees built at once (each runs one nvcc a source)
# The tile-skipping form of the tiled products, as (file, text, replacement)
# on a copy of the tree: live_tile leaves each live chain in its own column
# and returns the mask of chain tiles (RC chains each) holding a live chain;
# TiledDenseMetric's and TiledHierarchical's live loops run over those tiles
# only (nth_tile maps the i-th of them to its chains), and a G tile is
# computed when its chains' tile is live.
TILE_SKIP = (
    ("metric.cuh", "struct LiveTile {\n  int col, n;\n};",
     "struct LiveTile {\n  int col, n;\n  unsigned tiles;\n};"),
    ("tiled_step.cuh",
     "  return LiveTile{flag ? __popc(mask & ((1u << warp) - 1u)) : -1, __popc(mask)};",
     "  unsigned tiles = 0;\n"
     "  for (int t = 0; t < C / RC; ++t) tiles |= ((mask >> (t * RC)) & 15u) ? 1u << t : 0u;\n"
     "  return LiveTile{flag ? warp : -1, RC * __popc(tiles), tiles};"),
    ("tiled_step.cuh", "// Rows c0.. of `out` (stride os), column j, from a register tile.",
     "__device__ __forceinline__ int nth_tile(unsigned m, int i) {\n"
     "  for (; i > 0; --i) m &= m - 1u;\n  return __ffs(m) - 1;\n}\n\n"
     "// Rows c0.. of `out` (stride os), column j, from a register tile."),
    ("tiled_step.cuh", "      const int c0 = (t / dp) * RC;",
     "      const int c0 = (LIVE ? nth_tile(live.tiles, t / dp) : t / dp) * RC;"),
    ("tiled_step.cuh", "        const int c0 = (t / rows) * RC;",
     "        const int c0 = (LIVE ? nth_tile(live.tiles, t / rows) : t / rows) * RC;"),
    ("tiled_step.cuh", "    const bool g_tile = GRAD && g_owner && (!LIVE || g_c0 < live.n);",
     "    const bool g_tile = GRAD && g_owner && (!LIVE || ((live.tiles >> (g_c0 / RC)) & 1u));"),
)
# The warp metric's products at K = 1 (D <= 32) in the four-term steps of
# the other K, as (file, text, replacement) on a copy of the tree: the
# reorder where no register shares its row loads.
K1_REORDERED = (
    ("metric.cuh", """    if constexpr (K == 1) {
      // one register""", """    if constexpr (false) {
      // one register"""),
)
# The warp metric's products as two partial sums at every K: term i into
# partial i % 2 (the steps start on multiples of 4), the two joined once.
SUMS_2 = K1_REORDERED + (
    ("metric.cuh", """    float acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = -0.f;""", """    float acc[K][2];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r][0] = acc[r][1] = -0.f;"""),
    ("metric.cuh", "out[r] = lane + 32 * r < dim ? acc[r] : 0.f;",
     "out[r] = lane + 32 * r < dim ? __fadd_rn(acc[r][0], acc[r][1]) : 0.f;"),
    ("metric.cuh", "void terms(int ib, const float* A, float (&acc)[K]) const {",
     "void terms(int ib, const float* A, float (&acc)[K][2]) const {"),
    ("metric.cuh", "          acc[r] = __fadd_rn(acc[r], __fmul_rn(xs[j], A[i * dim + d]));",
     "          acc[r][j & 1] = __fadd_rn(acc[r][j & 1], __fmul_rn(xs[j], A[i * dim + d]));"),
)
# The dense endpoint warp window at 3 resident blocks of 8 warps an SM.
DENSE_3_BLOCKS = (
    ("nuts_window.cuh", """__global__ void __launch_bounds__(WARPS_PER_BLOCK<DENSE> * 32)
    nuts_window_kernel(const Args a) {""",
     """__global__ void __launch_bounds__(WARPS_PER_BLOCK<DENSE> * 32, DENSE && !MULTI ? 3 : 1)
    nuts_window_kernel(const Args a) {"""),
)
# 4b at K = 1 under the warp window's common launch bound (the compiler's
# own register count) instead of its own.
K1_COMMON_BOUND = (
    ("nuts_window.cuh", "  if constexpr (DENSE && !MULTI && K == 1) {",
     "  if constexpr (false) {"),
)
# The L1 functors' shells one after another in every layout, as kernel 3's
# lane groups run them (the axes still computed once).
SHELLS_SERIAL = (
    ("targets.cuh", "constexpr bool LANE_SHELLS = G == 32 && !BLOCKED;",
     "constexpr bool LANE_SHELLS = false;"),
)
# The shells one after another without branches: every one of MAX_SHELLS
# computed, a shell past n_shells masked by a select; the nested functor's
# MAX_SHELLS group sums independent, so they may overlap.
SHELLS_SELECT = SHELLS_SERIAL + (
    ("targets.cuh", """      mx = shell_term(u, radius[0], sig2);
#pragma unroll
      for (int k = 1; k < MAX_SHELLS; ++k) {
        if (k < n) mx = fmaxf(mx, shell_term(u, radius[k], sig2));
      }
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        if (k < n) {
          const float e = expf(__fsub_rn(shell_term(u, radius[k], sig2), mx));
          lse = __fadd_rn(lse, e);
          du = __fadd_rn(du, __fmul_rn(e, shell_slope(u, radius[k], sig2)));
        }
      }""", """      float term[MAX_SHELLS];
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) term[k] = shell_term(u, radius[k], sig2);
      mx = term[0];
#pragma unroll
      for (int k = 1; k < MAX_SHELLS; ++k) mx = k < n ? fmaxf(mx, term[k]) : mx;
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        const float e = expf(__fsub_rn(term[k], mx));
        const float lse_k = __fadd_rn(lse, e);
        const float du_k = __fadd_rn(du, __fmul_rn(e, shell_slope(u, radius[k], sig2)));
        lse = k < n ? lse_k : lse;
        du = k < n ? du_k : du;
      }"""),
    ("targets.cuh", """      for (int k = 0; k < MAX_SHELLS; ++k) {
        u[k] = 0.f;
        if (k < n) u[k] = group_sum<G>(partial(q, lane, k));
      }
      mx = shell_term(u[0], radius[0], sig2);
#pragma unroll
      for (int k = 1; k < MAX_SHELLS; ++k) {
        if (k < n) mx = fmaxf(mx, shell_term(u[k], radius[k], sig2));
      }
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        if (k < n) {
          const float e = expf(__fsub_rn(shell_term(u[k], radius[k], sig2), mx));
          lse = __fadd_rn(lse, e);
          add_grad(q, g, lane, k, __fmul_rn(e, shell_slope(u[k], radius[k], sig2)), true);
        }
      }""", """      float term[MAX_SHELLS];
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        u[k] = group_sum<G>(partial(q, lane, k));
        term[k] = shell_term(u[k], radius[k], sig2);
      }
      mx = term[0];
#pragma unroll
      for (int k = 1; k < MAX_SHELLS; ++k) mx = k < n ? fmaxf(mx, term[k]) : mx;
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        const float e = expf(__fsub_rn(term[k], mx));
        const float lse_k = __fadd_rn(lse, e);
        lse = k < n ? lse_k : lse;
        add_grad(q, g, lane, k, __fmul_rn(e, shell_slope(u[k], radius[k], sig2)), k < n);
      }"""),
)
# The warp window's termination test with its two dot products one after
# the other (the || short-circuits), as before the redesign.
UTURN_SERIAL = (
    ("nuts_window.cuh", """    const float2 ends = dot2(dq, p_l, p_r);
    const bool u_turn = ends.x < 0.f || ends.y < 0.f;""",
     "    const bool u_turn = (dot(dq, p_l) < 0.f) || (dot(dq, p_r) < 0.f);"),
)
# The multinomial scheme's odd-leaf checks after the first, as the tree
# makes them: every later slot's rows loaded when its check starts.
CHECKS_TREE = """          float qs[K], ps[K];
          copy(qs, q_prev), copy(ps, p_prev);
          for (int si = sslot; si >= lo; --si) {
            float dq[K];
            if (si < sslot) {
              const size_t at = static_cast<size_t>(si) * dim;
              load_row(q_stk, at, lane, dim, qs);
              load_row(p_stk, at, lane, dim, ps);
            }
#pragma unroll
            for (int r = 0; r < K; ++r) dq[r] = (q_c[r] - qs[r]) * direction;
            const float2 d = dot2(dq, ps, p_c);
            if (d.x < 0.f || d.y < 0.f) {
              turn_sub = true;
              break;
            }
          }"""
# The odd-leaf checks as before the redesign: every slot's rows loaded from
# the stacks when its check starts, the two dot products one after the
# other.
CHECKS_SERIAL = (
    ("nuts_window.cuh", CHECKS_TREE, """          for (int si = sslot; si >= lo; --si) {
            float qs[K], ps[K], dq[K];
            const size_t at = static_cast<size_t>(si) * dim;
            load_row(q_stk, at, lane, dim, qs);
            load_row(p_stk, at, lane, dim, ps);
#pragma unroll
            for (int r = 0; r < K; ++r) dq[r] = (q_c[r] - qs[r]) * direction;
            if (dot(dq, ps) < 0.f || dot(dq, p_c) < 0.f) {
              turn_sub = true;
              break;
            }
          }"""),
)
# The later checks' rows loaded ahead: each slot's rows while the slot
# before is checked (two more rows of registers).
CHECKS_PREFETCH_LOOP = """          float qs[K], ps[K];
          copy(qs, q_prev), copy(ps, p_prev);
          for (int si = sslot;; --si) {
            const bool more = si > lo;
            float q_next[K], p_next[K], dq[K];
            if (more) {
              const size_t at = static_cast<size_t>(si - 1) * dim;
              load_row(q_stk, at, lane, dim, q_next);
              load_row(p_stk, at, lane, dim, p_next);
            }
#pragma unroll
            for (int r = 0; r < K; ++r) dq[r] = (q_c[r] - qs[r]) * direction;
            const float2 d = dot2(dq, ps, p_c);
            if (d.x < 0.f || d.y < 0.f) {
              turn_sub = true;
              break;
            }
            if (!more) break;
            copy(qs, q_next), copy(ps, p_next);
          }"""
CHECKS_PREFETCH = (("nuts_window.cuh", CHECKS_TREE, CHECKS_PREFETCH_LOOP),)
# An odd leaf's first check made right after its leapfrog, from the old and
# the new (q_c, p_c) before they move on, so no copy of the previous leaf's
# state stays live; the later checks' rows loaded ahead.
CHECKS_EARLY = (
    ("nuts_window.cuh", """      // the previous leaf's state, the multinomial scheme's first check
      float q_prev[MULTI ? K : 1], p_prev[MULTI ? K : 1];
      if constexpr (MULTI) copy(q_prev, q_c), copy(p_prev, p_c);""",
     """      // an odd leaf's first check, against the previous leaf's state
      float2 first = make_float2(0.f, 0.f);
      if constexpr (MULTI) {
        if ((((1 << depth) - steps_left) & 1) && !turn_sub) {
          float dq[K];
#pragma unroll
          for (int r = 0; r < K; ++r) dq[r] = (qn[r] - q_c[r]) * direction;
          first = dot2(dq, p_c, p);
        }
      }"""),
    ("nuts_window.cuh", CHECKS_TREE, """          bool turn = first.x < 0.f || first.y < 0.f;
          float qs[K], ps[K];
          if (!turn && sslot > lo) {
            load_row(q_stk, static_cast<size_t>(sslot - 1) * dim, lane, dim, qs);
            load_row(p_stk, static_cast<size_t>(sslot - 1) * dim, lane, dim, ps);
          }
          for (int si = sslot - 1; si >= lo && !turn; --si) {
            const bool more = si > lo;
            float q_next[K], p_next[K], dq[K];
            if (more) {
              const size_t at = static_cast<size_t>(si - 1) * dim;
              load_row(q_stk, at, lane, dim, q_next);
              load_row(p_stk, at, lane, dim, p_next);
            }
#pragma unroll
            for (int r = 0; r < K; ++r) dq[r] = (q_c[r] - qs[r]) * direction;
            const float2 d = dot2(dq, ps, p_c);
            turn = d.x < 0.f || d.y < 0.f;
            if (more) copy(qs, q_next), copy(ps, p_next);
          }
          turn_sub = turn;"""),
)
# The multinomial diagonal warp window held to 5 resident blocks of 4 warps
# an SM (at most 96 registers a thread).
MULTI_BOUND = (
    ("nuts_window.cuh", """__global__ void __launch_bounds__(WARPS_PER_BLOCK<DENSE> * 32)
    nuts_window_kernel(const Args a) {""",
     """__global__ void __launch_bounds__(WARPS_PER_BLOCK<DENSE> * 32, MULTI && !DENSE ? 5 : 1)
    nuts_window_kernel(const Args a) {"""),
)
# A probe of what the leaf reservoir's transcendentals cost: log_add_exp's
# log1pf and expf and the leaf's expf as the fast intrinsics (other bits:
# the multinomial windows are left out of the comparison).
RESERVOIR_FAST = (
    ("nuts_window.cuh", "return mx == -INFINITY ? mx : mx + log1pf(expf(mn - mx));",
     "return mx == -INFINITY ? mx : mx + __logf(1.f + __expf(mn - mx));"),
    ("nuts_window.cuh",
     "        if (!dead && su < expf(lw_leaf - lse)) {\n          copy(q_sub, q_c)",
     "        if (!dead && su < __expf(lw_leaf - lse)) {\n          copy(q_sub, q_c)"),
)
# A probe of what the warp sums' butterfly depth costs at D <= 4: three
# shuffle levels instead of five (xor 2, xor 1, then lane 0's total to every
# lane), the same bits there (lanes past dim hold +0); windows past D = 4
# are left out of the comparison.
BUTTERFLY_4 = (
    ("targets.cuh", """__device__ __forceinline__ float group_sum(float v) {
#pragma unroll""", """__device__ __forceinline__ float group_sum(float v) {
  if constexpr (G == 32) {
    v += __shfl_xor_sync(FULL_MASK, v, 2);
    v += __shfl_xor_sync(FULL_MASK, v, 1);
    return __shfl_sync(FULL_MASK, v, 0);
  }
#pragma unroll"""),
)
# 4a at K = 2 under the warp window's common launch bound (the compiler's
# own register count) instead of its own.
MULTI_COMMON_BOUND = (
    ("nuts_window.cuh", "  } else if constexpr (MULTI && !DENSE && K == 2) {",
     "  } else if constexpr (false) {"),
)
PATCHES = {"tile-skip": TILE_SKIP, "k1-reordered": K1_REORDERED, "sums-2": SUMS_2,
           "dense-3-blocks": DENSE_3_BLOCKS, "k1-common-bound": K1_COMMON_BOUND,
           "shells-serial": SHELLS_SERIAL, "shells-select": SHELLS_SELECT,
           "uturn-serial": UTURN_SERIAL, "checks-serial": CHECKS_SERIAL,
           "checks-prefetch": CHECKS_PREFETCH, "checks-early": CHECKS_EARLY,
           "multi-bound": MULTI_BOUND, "multi-common-bound": MULTI_COMMON_BOUND,
           "reservoir-fast": RESERVOIR_FAST,
           "butterfly-4": BUTTERFLY_4}


def _dim_of(label):
    return int(label.split(" D", 1)[1].split()[0])


# The outputs a patch changes on purpose, left out of its comparison: the
# warp windows' dense products in another order ("sums-2"), the probes'
# other bits.
LEFT_OUT = {
    "sums-2": lambda k: " dense " in k and not k.startswith(HIER) and not k.startswith("3a"),
    "reservoir-fast": lambda k: " multinomial " in k,
    "butterfly-4": lambda k: _dim_of(k) > 4,
}
BLOCK_CHAINS = (8, 16, 32)
FAMILIES_2D = {"multimodal_funnel_2d": (2,), "concentric_l1_2d": (2,), "concentric_l1_3d": (3,),
               "nested_l1_2d": (2,), "nested_l1_3d": (3,)}
FAMILIES = ("standard_normal", "neals_funnel", "correlated_gaussian", "gaussian_mixture",
            "neals_funnel_noncentered", "ill_conditioned_gaussian", "student_t", "log_gamma",
            "log_gamma_unconstrained", "rosenbrock")
STEP = {"neals_funnel": 0.1, "rosenbrock": 0.02, "log_gamma": 0.1, "student_t": 0.3}
HIER = "hierarchical_logistic"
# The L1 families at every shell count the redesign's selects mask (a
# family name with ":n", the shell count) and at D across the layouts
L1_SHELLS = (1, 2, 3, 5, 8)
L1_DIMS = (1, 2, 3, 10, 32, 50)
L1_RADII = (4.0, 8.0, 16.0, 24.0, 32.0, 40.0, 48.0, 56.0)


def _get_target(family, dim, n_data=0):
    """get_target, or an L1 family at a shell count ("concentric_l1:3")."""
    from mcmc_tpu_torch.targets import get_target, rahmc_paper
    if ":" in family:
        name, n = family.split(":")
        if name == "concentric_l1":
            return rahmc_paper.concentric_l1_balls(dim=dim, radii=L1_RADII[:int(n)])
        return rahmc_paper.nested_l1_balls(dim=dim, n_inner=int(n) - 1)
    return get_target(family, dim=dim, **({"n_data": n_data} if n_data else {}))


def cases():
    """(label, family, dim, chains, multinomial, dense, n_data) compared:
    the warp windows under either metric on every family without data, at
    ragged counts and D 1-128, the L1 families at every shell count, and
    the tiled data windows."""
    out = []
    for multi in (False, True):
        for dense in (False, True):
            for family in FAMILIES:
                out += [(family, d, 1200, multi, dense, 0) for d in (10, 100)]
            for family, dims in FAMILIES_2D.items():
                out += [(family, d, 1200, multi, dense, 0) for d in dims]
        for name in ("concentric_l1", "nested_l1"):
            out += [(f"{name}:{n}", d, 257, multi, False, 0) for n in L1_SHELLS for d in L1_DIMS]
        out += [("neals_funnel", d, n, multi, False, 0)
                for d, n in ((1, 1), (32, 7), (33, 9), (64, 31), (65, 33), (128, 8191))]
        out.append(("neals_funnel", 50, 65536, multi, False, 0))
        out += [("correlated_gaussian", d, n, multi, True, 0)
                for d, n in ((1, 1), (32, 7), (33, 9), (64, 31), (65, 33), (128, 8191))]
        out += [("correlated_gaussian", d, 65536, multi, True, 0) for d in (50, 100)]
        for dense in (False, True):
            out += [(HIER, d, n, multi, dense, m)
                    for d, n, m in ((9, 7, 50), (20, 33, 256), (100, 31, 1000),
                                    (9, 1000, 1000), (20, 100, 50), (100, 1, 256))]
        out.append((HIER, 100, 8192, multi, False, 256))
    return [(f"{f} D{d} C{n} {'multinomial' if m else 'endpoint'} "
             f"{'dense' if dense else 'diagonal'} n_data{k}", f, d, n, m, dense, k)
            for f, d, n, m, dense, k in out]


def rwmh_cases():
    """(label, dim, chains, n_data, transitions) of 3a compared."""
    out = [(d, 1000, m, 8) for d in (9, 20, 100) for m in (50, 256, 1000)]
    out += [(100, n, 256, 8) for n in (1, 7, 33, 8191)] + [(100, 8192, 256, 32)]
    return [(f"3a D{d} C{n} n_data{m} T{k}", d, n, m, k) for d, n, m, k in out]


def _draws(torch, g, n_iters, n, dim, slots, dev):
    return (torch.randn((n_iters, n, dim), generator=g, device=dev),
            torch.rand((n_iters, n), generator=g, device=dev) < 0.5,
            torch.rand((n_iters, n), generator=g, device=dev) < 0.5,
            torch.rand((n_iters, n), generator=g, device=dev),
            torch.rand((n_iters * slots, n), generator=g, device=dev).clamp_min(2.0 ** -25),
            torch.rand((n_iters, n), generator=g, device=dev))


def digest(torch, x):
    """A tensor's bytes as a sha256 hex digest (None for None), every NaN
    written as one NaN: two trees' outputs are compared by their digests,
    any NaN equal to any NaN, so no tree's outputs touch the disk."""
    if x is None:
        return None
    if x.is_floating_point():
        x = torch.where(x.isnan(), torch.full_like(x, float("nan")), x)
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def worker_outputs(torch, save):
    """Two windows of kernel 4 on every case, injected and Philox, from a
    fresh state, and 3a's calls; every output's digest saved to `save`."""
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    dev = torch.device("cuda", 0)
    key = torch.tensor([11, -12], dtype=torch.int32, device=dev)
    out = {}
    for i, (label, family, dim, n, multi, dense, n_data) in enumerate(cases()):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        t = _get_target(family, dim, n_data)
        if family == HIER:
            q = t.init_sampler(g, n) * 2.0
        elif family == "log_gamma":
            q = torch.rand((n, dim), generator=g, device=dev) * 2.0 + 0.5
        elif t.init_sampler is not None:
            q = t.init_sampler(g, n)
        else:
            q = torch.randn((n, dim), generator=g, device=dev) * 0.5
        q = q.float().contiguous()
        lp, grad = t.value_and_grad_fn(q)
        if family == "correlated_gaussian" and n == 65536 and dim == 50:
            metric = t.true_cov.to(dev, torch.float64)
        elif dense:
            a = torch.randn((dim, dim), generator=g, device=dev, dtype=torch.float64)
            metric = a @ a.T / dim + 0.5 * torch.eye(dim, device=dev, dtype=torch.float64)
            metric = metric * 0.1 if family == HIER else metric
        else:
            metric = torch.rand(dim, generator=g, device=dev) * 0.05 + 0.02
        inv_mass, l_inv = ft.kernel_metric(metric)
        step = (0.05 if dense else 0.15) if family == HIER else STEP.get(family, 0.2)
        scalars = fn.nuts_scalars(step, 1000.0, dev)
        args = (t.value_and_grad_fn.kernel_info, 8, 4, 10)
        draws = _draws(torch, g, 8, n, dim, 4 if multi else 1, dev)
        for mode in ("injected", "philox"):
            st = tn._init_pstate(q, lp.float(), grad.float(), torch.float32, multinomial=multi)
            for call in range(2):
                rand = dict(draws=draws) if mode == "injected" else dict(key=key, call=call)
                st = fn.nuts_window_kernel(*args, st, scalars, inv_mass, l_inv=l_inv, **rand)
                out[f"{label} {mode} window {call}"] = [digest(torch, x) for x in st]
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.targets import get_target
    out.update(l1_outputs(torch, key))
    for i, (label, dim, n, n_data, steps) in enumerate(rwmh_cases()):
        g = torch.Generator(device=dev).manual_seed(5000 + i)
        t = get_target(HIER, dim=dim, n_data=n_data)
        q = (t.init_sampler(g, n) * 2.0).float().contiguous()
        lp = t.log_prob_fn(q).float().contiguous()
        scale = fr.rwmh_scale(0.3 / dim ** 0.5, dev)
        noise = torch.randn((steps, n, dim), generator=g, device=dev)
        u = torch.rand((steps, n), generator=g, device=dev).clamp_min(2.0 ** -25)
        for mode, rand in (("injected", dict(noise=noise, u=u)), ("philox", dict(key=key, call=3))):
            res = fr.rwmh_multistep_kernel(t.value_and_grad_fn.kernel_info, steps, q, lp, scale,
                                           min(n, 37), **rand)
            out[f"{label} {mode}"] = [digest(torch, x) for x in res]
    Path(save).write_text(json.dumps(out))
    print(f"{len(out)} outputs' digests saved")


def l1_outputs(torch, key):
    """Kernels 1, 1b, 1c, 2 and 3 on the L1 families (their functors are
    every kernel's), injected and Philox: {label: output digests}."""
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.ops.padded_targets import device_lp
    dev = torch.device("cuda", 0)
    out = {}
    for i, (name, n_shells, dim) in enumerate(
            (name, n, d) for name in ("concentric_l1", "nested_l1") for n in L1_SHELLS
            for d in L1_DIMS):
        g = torch.Generator(device=dev).manual_seed(9000 + i)
        t = _get_target(f"{name}:{n_shells}", dim)
        n = 999                   # three rungs of 333 for 1b
        q = t.init_sampler(g, n).float().contiguous()
        lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
        info = t.value_and_grad_fn.kernel_info
        invm = torch.rand(dim, generator=g, device=dev) + 0.5
        label = f"{name}:{n_shells} D{dim} C{n}"
        args = (info, 8, ft.SCHEDULE_IDS["tanh"], q, lp, grad,
                ft.kernel_scalars(0.1, 0.3, 2.0, dev), invm)
        p0 = torch.randn((n, dim), generator=g, device=dev)
        u = torch.rand(n, generator=g, device=dev).clamp_min(2.0 ** -25)
        for mode, rand in (("injected", dict(p0=p0, u=u)), ("philox", dict(key=key, call=1))):
            out[f"k1 {label} {mode}"] = [digest(torch, x) for x in
                                         ft.grahmc_step_kernel(*args, **rand)]
        betas = torch.tensor([1.0, 0.3, 0.05], device=dev)
        beta_row = betas.repeat_interleave(n // 3)
        sargs = args[:4] + ((beta_row * lp).contiguous(), (beta_row[:, None] * grad).contiguous(),
                            ft.rung_table(0.1 / torch.sqrt(betas), 0.3, 2.0, betas, dev), invm)
        out[f"k1b {label} philox"] = [digest(torch, x) for x in
                                      ft.grahmc_scaled_kernel(*sargs, key=key, call=1)]
        base = ft.bridge_base(0.5, 2.0, dim, dev)
        bridge = ft.bridged_vag(ft.device_vag(info), torch.tensor(0.5, device=dev),
                                torch.tensor(base.log_norm, dtype=torch.float32, device=dev),
                                base.mean, base.inv_scale)
        blp, bgrad = bridge(q)
        bargs = (info, 8, 0, q, blp.contiguous(), bgrad.contiguous(),
                 ft.bridge_scalars(0.1, 0.0, 1.0, 0.5, base.log_norm, dev), base.mean,
                 base.inv_scale, invm)
        out[f"k1c {label} philox"] = [digest(torch, x) for x in
                                      ft.grahmc_bridged_kernel(*bargs, key=key, call=1)]
        margs = args[:3] + (4,) + args[3:]
        out[f"k2 {label} philox"] = [digest(torch, x) for x in
                                     ft.grahmc_multistep_kernel(*margs, key=key, call=2)]
        rlp = device_lp(info)(q).contiguous()
        noise = torch.randn((8, n, dim), generator=g, device=dev)
        ru = torch.rand((8, n), generator=g, device=dev).clamp_min(2.0 ** -25)
        for mode, rand in (("injected", dict(noise=noise, u=ru)),
                           ("philox", dict(key=key, call=3))):
            out[f"k3 {label} {mode}"] = [digest(torch, x) for x in fr.rwmh_multistep_kernel(
                info, 8, q, rlp, fr.rwmh_scale(0.05, dev), 37, **rand)]
    return out


def _event_ms(torch, fn, burst):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(burst):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / burst


def worker_inputs(torch, save):
    """The tuned inputs of chip_smoke.py's [6b] dense windows and [6f] data
    windows, by its own protocol and seeds: the [5c] row's NUTS step on the
    correlated Gaussian with its oracle metric; config 5's warmup (kernel
    1d) and its NUTS step ([5k]). Saved to `save`."""
    import chip_smoke as cs
    from mcmc_tpu_torch import samplers, targets, tuning
    dev = torch.device("cuda", 0)
    t = cs._target(targets, "correlated_gaussian")
    dense_step, _ = cs._da_tune_nuts(torch, tuning, samplers, dev, t, cs.NUTS_CHAINS,
                                     inv_mass_matrix=t.true_cov.to(dev))
    h = cs._hier_target(targets)
    init = h.init_sampler(cs._gen(torch, dev, 110), cs.HIER_CHAINS)
    step, inv_mass, pos, info = tuning.run_adaptive_warmup(
        "grahmc", h.log_prob_fn, None, init, cs._gen(torch, dev, 111),
        num_warmup=cs.WARMUP_STEPS, learn_mass_matrix=True, backend="fused",
        num_steps=cs.HIER_L, schedule_type="tanh", value_and_grad_fn=h.value_and_grad_fn)
    hier_step, _ = cs._da_tune_nuts(torch, tuning, samplers, dev, h, cs.HIER_CHAINS, init=pos,
                                    inv_mass_matrix=inv_mass)
    torch.save({"dense_step": float(dense_step), "hier_step": float(hier_step),
                "hier_pos": pos.cpu(), "hier_inv_mass": inv_mass.cpu()}, save)
    print(f"dense NUTS step {float(dense_step):.6f}, config-5 GRAHMC step {step:.6f}, "
          f"config-5 NUTS step {float(hier_step):.6f}")


def _windows(torch, inputs):
    """{name: (args, state, scalars, inv_mass, l_inv, key)}: the four
    redesigned variants' windows two windows in, as [6b] and [6f] build
    them (the same generators, drawn in the same order)."""
    import chip_smoke as cs
    from mcmc_tpu_torch import targets
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    dev = torch.device("cuda", 0)
    out = {}
    g = cs._gen(torch, dev, 41)                       # [6b]
    key = ft.PhiloxStream.from_generator(g, dev).key
    torch.randn((cs.RWMH_CHAINS, cs.RWMH_DIM), generator=g, device=dev)
    t = cs._target(targets, "correlated_gaussian")
    for multi in (False, True):
        torch.randn((cs.NUTS_CHAINS, cs.DIM), generator=g, device=dev)   # the funnel's
    for multi in (False, True):
        q = torch.randn((cs.NUTS_CHAINS, cs.DIM), generator=g, device=dev) * 0.5
        lp, grad = t.value_and_grad_fn(q)
        out[("4a+4b" if multi else "4b")] = (t.value_and_grad_fn.kernel_info, q, lp, grad,
                                             inputs["dense_step"], t.true_cov.to(dev), multi,
                                             key)
    h = cs._hier_target(targets)
    key = ft.PhiloxStream.from_generator(cs._gen(torch, dev, 46), dev).key   # [6f]
    q = inputs["hier_pos"].to(dev).float().contiguous()
    lp, grad = (x.contiguous() for x in h.value_and_grad_fn(q))
    for multi in (False, True):
        out["4a, data" if multi else "4c"] = (h.value_and_grad_fn.kernel_info, q, lp, grad,
                                              inputs["hier_step"], inputs["hier_inv_mass"].to(dev),
                                              multi, key)
    windows = {}
    for name, (info, q, lp, grad, step, metric, multi, key) in out.items():
        inv_mass, l_inv = ft.kernel_metric(metric)
        scalars = fn.nuts_scalars(step, 1000.0, dev)
        args = (info, cs.NUTS_ITERS, cs.NUTS_W, cs.NUTS_DEPTH)
        st = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multi,
                             max_tree_depth=cs.NUTS_DEPTH)
        for call in range(2):
            st = fn.nuts_window_kernel(*args, st, scalars, inv_mass, key=key, call=call,
                                       l_inv=l_inv)
        windows[name] = (args, st, scalars, inv_mass, l_inv, key)
    return windows


def worker_lockstep(torch, inputs, save):
    """Step 3: each window one iteration a call, its own draws injected."""
    from mcmc_tpu_torch.ops import fused_nuts as fn
    dev = torch.device("cuda", 0)
    result = {}
    for name, (args, st, scalars, inv_mass, l_inv, key) in _windows(torch, inputs).items():
        info, n_iters, slots, depth = args
        n, dim = st.q.shape
        multi = st.q_sub is not None
        live, starts = [], []
        for it in range(n_iters):
            d = fn.philox_nuts_draws(key, 2, it, n, dim, dev, slots if multi else None)
            draws = tuple(x[None].contiguous() for x in d[:4]) + (
                (d[4] if multi else d[4][None]).contiguous(), d[5][None].contiguous())
            before, start = st.n_exec.clone(), st.needs_start.clone()
            st = fn.nuts_window_kernel(info, 1, slots, depth, st, scalars, inv_mass,
                                       draws=draws, l_inv=l_inv)
            live.append(st.n_exec - before)
            starts.append(start)
        live, starts = torch.stack(live).cpu(), torch.stack(starts).cpu()
        result[name] = {}
        for c in BLOCK_CHAINS:
            k = fn.lockstep_counts(live, starts, c)
            result[name][c] = k._asdict()
            print(f"[lockstep] {name} ({n} x {dim}, {n_iters} iterations x W = {slots}), "
                  f"{c} chains a block: {k.chain_slots} chain slots of {k.block_slots} block "
                  f"warp-slots (share {k.slot_share:.4f}); {k.chain_starts} starts in "
                  f"{k.start_blocks} (block, iteration) pairs of {n_iters * -(-n // c)} "
                  f"({k.chain_starts / max(k.start_blocks * c, 1):.4f} of their warps)",
                  flush=True)
    Path(save).write_text(json.dumps(result))


# Kernel 4's small windows, as chip_smoke.py's [6h] and [6i] run them:
# (family, dim, step) at 1,024 chains, 16 iterations x W = 4, depth 10, the
# [5o] and [5n] cells' tuned steps (H100 runs of chip_smoke.py); the
# inverse metric the positions' variance, as the cells learn one.
SMALL_WINDOWS = (("nested_l1_2d", 2, 0.16884), ("concentric_l1_2d", 2, 0.12101),
                 ("multimodal_funnel_2d", 2, 0.22771), ("standard_normal", 2, 0.9),
                 ("neals_funnel_noncentered", 10, 1.12239),
                 ("ill_conditioned_gaussian", 10, 1.12021), ("student_t", 10, 0.58272),
                 ("log_gamma", 10, 0.14341), ("log_gamma_unconstrained", 10, 0.68463))
SMALL_CHAINS = 1024


def _small_window(torch, t, step, key, g, multinomial=False, n=SMALL_CHAINS, dim=None):
    """(run, state): a window of t at n chains two windows in, its inverse
    metric the positions' variance."""
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    dev = torch.device("cuda", 0)
    if t.init_sampler is not None:
        q = t.init_sampler(g, n).float().contiguous()
    else:
        q = (torch.randn((n, dim), generator=g, device=dev) * 0.5 + 1.0).contiguous()
    lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
    inv_mass = q.var(dim=0).clamp_min(0.05).contiguous()
    args = (t.value_and_grad_fn.kernel_info, 16, 4, 10)
    scalars = fn.nuts_scalars(step, 1000.0, dev)
    st = tn._init_pstate(q, lp, grad, torch.float32, multinomial=multinomial)
    for call in range(2):
        st = fn.nuts_window_kernel(*args, st, scalars, inv_mass, key=key, call=call)
    return (lambda: fn.nuts_window_kernel(*args, st, scalars, inv_mass, key=key, call=2)), st


def small_windows(torch, key, g):
    """{name: (run, state)}: kernel 4 on SMALL_WINDOWS, on the concentric
    shells at 1-8 shells (radii 4, 8, ..., 32) at 1,024 x 2, and kernel 1
    and 2 on the nested shells at 1,024 x 2 (L = 16; T = 8), whose functor
    they share."""
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.targets import get_target, rahmc_paper
    dev = torch.device("cuda", 0)
    out = {}
    for family, dim, step in SMALL_WINDOWS:
        t = get_target(family, dim=dim)
        out[f"4 1,024 x {dim} ({family})"] = _small_window(torch, t, step, key, g, dim=dim)
    for n_shells in range(1, 9):
        t = rahmc_paper.concentric_l1_balls(dim=2, radii=L1_RADII[:n_shells])
        out[f"4 1,024 x 2 (concentric, {n_shells} shells)"] = _small_window(
            torch, t, 0.12101, key, g)
    t = get_target("nested_l1_2d", dim=2)
    q = t.init_sampler(g, SMALL_CHAINS).float().contiguous()
    lp, grad = (x.float().contiguous() for x in t.value_and_grad_fn(q))
    invm = q.var(dim=0).contiguous()
    info = t.value_and_grad_fn.kernel_info
    sc = ft.kernel_scalars(0.17, 1.0, 1.0, dev)
    a1 = (info, 16, ft.SCHEDULE_IDS["constant"], q, lp, grad, sc, invm)
    out["1 1,024 x 2 (nested_l1_2d)"] = (lambda: ft.grahmc_step_kernel(*a1, key=key, call=0),
                                         None)
    a2 = (info, 16, ft.SCHEDULE_IDS["constant"], 8, q, lp, grad, sc, invm)
    out["2 1,024 x 2 (nested_l1_2d)"] = (
        lambda: ft.grahmc_multistep_kernel(*a2, key=key, call=0), None)
    return out


def worker_time(torch, inputs, reps=10, burst=10):
    """Per-call ms of `reps` bursts of each timed kernel and shape, Philox
    mode, and the yardsticks; prints one JSON line."""
    from mcmc_tpu_torch.ops import fused_nuts as fn
    from mcmc_tpu_torch.ops import fused_trajectory as ft
    from mcmc_tpu_torch.samplers import nuts_persistent as tn
    from mcmc_tpu_torch.targets import get_target
    dev = torch.device("cuda", 0)
    key = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    fns, per_call = {}, {}
    windows = _windows(torch, inputs)
    for name, (args, st, scalars, inv_mass, l_inv, wkey) in windows.items():
        fns[name] = (lambda a=args, s=st, sc=scalars, m=inv_mass, li=l_inv, k=wkey:
                     fn.nuts_window_kernel(*a, s, sc, m, key=k, call=2, l_inv=li))
        per_call[name] = st
    r = get_target("rosenbrock", dim=10)
    rq = (torch.randn((1024, 10), generator=g, device=dev) * 0.3 + 1.0).contiguous()
    rlp, rgrad = r.value_and_grad_fn(rq)
    m = torch.randn((10, 10), generator=g, device=dev, dtype=torch.float64)
    r_invm, r_linv = ft.prepare_dense_metric(m @ m.T / 10 + 0.5 * torch.eye(10, device=dev,
                                                                             dtype=torch.float64))
    r_args = (r.value_and_grad_fn.kernel_info, 16, 4, 10)
    r_st = tn._init_pstate(rq, rlp, rgrad, torch.float32)
    r_sc = fn.nuts_scalars(0.02, 1000.0, dev)
    for call in range(2):
        r_st = fn.nuts_window_kernel(*r_args, r_st, r_sc, r_invm, key=key, call=call,
                                     l_inv=r_linv)
    fns["4b 1,024 x 10 (rosenbrock)"] = lambda: fn.nuts_window_kernel(
        *r_args, r_st, r_sc, r_invm, key=key, call=2, l_inv=r_linv)
    c = get_target("correlated_gaussian", dim=100, correlation=0.9)
    cq = torch.randn((65536, 100), generator=g, device=dev) * 0.5
    clp, cgrad = c.value_and_grad_fn(cq)
    c_invm, c_linv = ft.prepare_dense_metric(c.true_cov.to(dev, torch.float64))
    c_args = (c.value_and_grad_fn.kernel_info, 16, 4, 10)
    c_st = tn._init_pstate(cq, clp, cgrad, torch.float32)
    c_sc = fn.nuts_scalars(inputs["dense_step"], 1000.0, dev)
    for call in range(2):
        c_st = fn.nuts_window_kernel(*c_args, c_st, c_sc, c_invm, key=key, call=call,
                                     l_inv=c_linv)
    fns["4b 65,536 x 100"] = lambda: fn.nuts_window_kernel(
        *c_args, c_st, c_sc, c_invm, key=key, call=2, l_inv=c_linv)
    f = get_target("neals_funnel", dim=50)
    fq = torch.randn((65536, 50), generator=g, device=dev) * 0.5
    flp, fgrad = f.value_and_grad_fn(fq)
    ones = torch.ones(50, device=dev)
    f_args = (f.value_and_grad_fn.kernel_info, 16, 4, 10)
    f_st = tn._init_pstate(fq, flp, fgrad, torch.float32)
    f_sc = fn.nuts_scalars(0.2, 1000.0, dev)
    for call in range(2):
        f_st = fn.nuts_window_kernel(*f_args, f_st, f_sc, ones, key=key, call=call)
    fns["4 65,536 x 50 (control)"] = lambda: fn.nuts_window_kernel(*f_args, f_st, f_sc, ones,
                                                                   key=key, call=2)
    per_call["4 65,536 x 50 (control)"] = f_st
    m_st = tn._init_pstate(fq, flp, fgrad, torch.float32, multinomial=True)
    for call in range(2):
        m_st = fn.nuts_window_kernel(*f_args, m_st, f_sc, ones, key=key, call=call)
    fns["4a 65,536 x 50"] = lambda: fn.nuts_window_kernel(*f_args, m_st, f_sc, ones, key=key,
                                                          call=2)
    per_call["4a 65,536 x 50"] = m_st
    rb = get_target("rosenbrock", dim=50)
    rbq = (1.0 + 0.05 * torch.randn((65536, 50), generator=g, device=dev)).contiguous()
    rb_lp, rb_grad = rb.value_and_grad_fn(rbq)
    rb_args = (rb.value_and_grad_fn.kernel_info, 16, 4, 10)
    rb_sc = fn.nuts_scalars(0.02, 1000.0, dev)
    rb_st = tn._init_pstate(rbq, rb_lp, rb_grad, torch.float32, multinomial=True)
    for call in range(2):
        rb_st = fn.nuts_window_kernel(*rb_args, rb_st, rb_sc, ones, key=key, call=call)
    fns["4a 65,536 x 50 (rosenbrock)"] = lambda: fn.nuts_window_kernel(
        *rb_args, rb_st, rb_sc, ones, key=key, call=2)
    per_call["4a 65,536 x 50 (rosenbrock)"] = rb_st
    for name, (run, st) in small_windows(torch, key, g).items():
        fns[name] = run
        if st is not None:
            per_call[name] = st
    k_args = (f.value_and_grad_fn.kernel_info, 16, ft.SCHEDULE_IDS["constant"], fq,
              flp.contiguous(), fgrad.contiguous(), ft.kernel_scalars(0.024, 1.0, 1.0, dev), ones)
    fns["1 (control)"] = lambda: ft.grahmc_step_kernel(*k_args, key=key, call=0)
    # 2a at the dense-warmup row's 4,096 x 50 and Rosenbrock's 1,024 x 10
    invm50, linv50 = ft.prepare_dense_metric(
        get_target("correlated_gaussian", dim=50).true_cov.to(dev, torch.float64))
    a_q = torch.randn((4096, 50), generator=g, device=dev) * 0.5
    a_lp, a_grad = get_target("correlated_gaussian", dim=50).value_and_grad_fn(a_q)
    a_args = (get_target("correlated_gaussian", dim=50).value_and_grad_fn.kernel_info, 16,
              ft.SCHEDULE_IDS["constant"], 8, a_q, a_lp.contiguous(), a_grad.contiguous(),
              ft.kernel_scalars(0.3, 1.0, 1.0, dev), invm50)
    fns["2a 4,096 x 50"] = lambda: ft.grahmc_multistep_kernel(*a_args, key=key, call=0,
                                                              l_inv=linv50)
    ra_args = (r.value_and_grad_fn.kernel_info, 64, ft.SCHEDULE_IDS["linear"], 8, rq,
               rlp.contiguous(), rgrad.contiguous(), ft.kernel_scalars(0.02, 1.0, 1.0, dev),
               r_invm)
    fns["2a 1,024 x 10 (rosenbrock)"] = lambda: ft.grahmc_multistep_kernel(
        *ra_args, key=key, call=0, l_inv=r_linv)
    # 3a at config 5's warmed positions and at a small dim
    from mcmc_tpu_torch.ops import fused_rwmh as fr
    import chip_smoke as cs
    from mcmc_tpu_torch import targets
    h = cs._hier_target(targets)
    hq = inputs["hier_pos"].to(dev).float().contiguous()
    h_args = (h.value_and_grad_fn.kernel_info, 32, hq, h.log_prob_fn(hq).float().contiguous(),
              fr.rwmh_scale(0.05, dev), 256)
    fns["3a 8,192 x 100 x 256"] = lambda: fr.rwmh_multistep_kernel(*h_args, key=key, call=0)
    s = get_target(HIER, dim=20, n_data=256)
    sq = (s.init_sampler(g, 1024)).float().contiguous()
    s_args = (s.value_and_grad_fn.kernel_info, 32, sq, s.log_prob_fn(sq).float().contiguous(),
              fr.rwmh_scale(0.1, dev), 256)
    fns["3a 1,024 x 20 x 256"] = lambda: fr.rwmh_multistep_kernel(*s_args, key=key, call=0)
    # kernel 3's lane groups as a control: the RWMH row's 65,536 x 10, T = 32
    n3 = get_target("standard_normal", dim=cs.RWMH_DIM)
    q3 = (torch.randn((cs.RWMH_CHAINS, cs.RWMH_DIM), generator=g, device=dev) * 0.3).contiguous()
    k3_args = (n3.value_and_grad_fn.kernel_info, cs.RWMH_T, q3, n3.log_prob_fn(q3).contiguous(),
               fr.rwmh_scale(cs.RWMH_SCALE, dev), cs.RWMH_COLLECT)
    fns["3 (control)"] = lambda: fr.rwmh_multistep_kernel(*k3_args, key=key, call=0)
    ms, counts = {}, {}
    for name, run in fns.items():
        if name in per_call:
            before = (int(per_call[name].n_exec.sum()), int(per_call[name].transitions.sum()))
        run()
        ms[name] = [_event_ms(torch, run, burst) for _ in range(reps)]
        if name in per_call:
            st = per_call[name]
            calls = 1 + reps * burst
            counts[name] = {"leapfrogs": (int(st.n_exec.sum()) - before[0]) / calls,
                            "transitions": (int(st.transitions.sum()) - before[1]) / calls,
                            "chains": st.q.shape[0]}
    # yardsticks: 4b's dense products as full-batch torch.matmul(p, M^{-1})
    # calls, one a leapfrog's velocity and kinetic energy and a start's
    # unwhitening and kinetic energy (starts ~ transitions completed),
    # config 5's eager value_and_grad, and 3a's z-products
    torch.backends.cuda.matmul.allow_tf32 = False
    n, dim = per_call["4b"].q.shape
    inv_mass = windows["4b"][3]
    p = torch.randn((n, dim), generator=g, device=dev)
    c = counts["4b"]
    n_mm = max(1, round(2 * (c["leapfrogs"] + c["transitions"]) / n))
    ms["4b yardstick"] = [_event_ms(torch, lambda: [torch.matmul(p, inv_mass)
                                                   for _ in range(n_mm)], 1) for _ in range(reps)]
    counts["4b yardstick"] = {"matmuls": n_mm}
    h.value_and_grad_fn(hq)
    ms["config-5 eager value_and_grad"] = [_event_ms(torch, lambda: h.value_and_grad_fn(hq),
                                                     burst) for _ in range(reps)]
    from mcmc_tpu_torch.ops.padded_targets import device_data
    xt = device_data(h.value_and_grad_fn.kernel_info, dev)[1]
    ms["3a yardstick"] = [_event_ms(torch, lambda: [torch.matmul(hq, xt) for _ in range(32)], 1)
                          for _ in range(reps)]
    print("TIMES " + json.dumps({"ms": ms, "counts": counts}))


def worker(args):
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))   # chip_smoke.py's protocol
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if args.worker == "build":
        from mcmc_tpu_torch.ops import _cuda
        lib = _cuda.load_library()
        Path(args.save).write_text(lib.build_log)
        print(f"built {lib.path.name} in {lib.build_seconds:.1f} s")
        return
    if args.worker == "outputs":
        return worker_outputs(torch, args.save)
    if args.worker == "inputs":
        return worker_inputs(torch, args.save)
    inputs = torch.load(args.inputs)
    if args.worker == "lockstep":
        return worker_lockstep(torch, inputs, args.save)
    return worker_time(torch, inputs)


def run_worker(kind, root, save="", inputs=""):
    cmd = [sys.executable, __file__, "--worker", kind, "--root", str(root), "--save", str(save),
           "--inputs", str(inputs)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if proc.returncode:
        sys.exit(f"{kind} worker in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout


def make_patched(tree, dst, names):
    """A copy of tree's mcmc_tpu_torch under dst with the edits of each of
    `names` (PATCHES) applied."""
    import shutil
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(tree) / "mcmc_tpu_torch", dst / "mcmc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for patch in names:
        for name, old, new in PATCHES[patch]:
            path = dst / "mcmc_tpu_torch" / "csrc" / name
            text = path.read_text()
            if text.count(old) != 1:
                sys.exit(f"{patch}: {old!r} is not once in {name}")
            path.write_text(text.replace(old, new))
    return dst


def ptxas_lines(log):
    """{kernel's mangled name: its ptxas resource line and spill line}."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spill = entry.group(1), ""
        elif "spill" in line and name:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            out[name] = f"{line.split(':', 1)[-1].strip()}; {spill}"
            name = None
    return out


def compare_ptxas(lines):
    """Print the ptxas lines the parent and the tree disagree on; returns
    the changed instances."""
    old, new = lines["parent"], lines["tree"]
    changed = sorted(k for k in set(old) & set(new) if old[k] != new[k])
    print(f"[ptxas] parent {len(old)} instances, tree {len(new)}; {len(set(old) & set(new))} in "
          f"both, {len(changed)} of them changed", flush=True)
    for k in changed:
        print(f"  changed {k}: {old[k]} -> {new[k]}")
    for k in sorted(set(old) - set(new)):
        print(f"  drops {k}: {old[k]}")
    for k in sorted(set(new) - set(old)):
        print(f"  adds {k}: {new[k]}")
    return changed


def compare_outputs(trees, work):
    """Kernel 4's outputs of every tree against the parent's (the tree's
    without one), bit for bit; returns the differing (tree, window)s."""
    t0 = time.perf_counter()
    labels = list(trees)
    for i in range(0, len(labels), OUTPUT_WORKERS):   # a few trees' workers at once
        procs = {label: subprocess.Popen(
            [sys.executable, __file__, "--worker", "outputs", "--root", str(trees[label]),
             "--save", str(work / f"outputs_{label}.json")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for label in labels[i:i + OUTPUT_WORKERS]}
        for label, proc in procs.items():
            text = proc.communicate(timeout=1800)[0]
            if proc.returncode:
                sys.exit(f"outputs worker in {trees[label]} failed:\n{text[-8000:]}")
    ref = "parent" if "parent" in trees else "tree"
    a = json.loads((work / f"outputs_{ref}.json").read_text())
    differ = []
    for label in trees:
        if label == ref:
            continue
        b = json.loads((work / f"outputs_{label}.json").read_text())
        keys = list(a)
        for patch in set(label.split("+")) & set(LEFT_OUT):
            kept = [k for k in keys if not LEFT_OUT[patch](k)]
            print(f"[outputs] {label}: {len(keys) - len(kept)} outputs left out ({patch} "
                  f"changes them on purpose)", flush=True)
            keys = kept
        bad = [k for k in keys if a[k] != b[k]]
        print(f"[outputs] {label} against {ref}: {len(keys)} kernel-4 windows, kernel 1-3 "
              f"calls on the L1 families and 3a calls compared bit for bit: "
              f"{len(keys) - len(bad)} equal, {len(bad)} differ", flush=True)
        differ += [(label, k) for k in bad]
        for k in bad:
            print(f"  differs: {k}")
    print(f"[outputs] compared in {time.perf_counter() - t0:.1f} s", flush=True)
    return differ


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", default="_archive/tiled_nuts_out")
    ap.add_argument("--work", default="_archive/tiled_nuts")
    ap.add_argument("--patched", action="append", default=[], help="+".join(PATCHES))
    ap.add_argument("--skip-lockstep", action="store_true")
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--worker", choices=("build", "outputs", "inputs", "lockstep", "time"))
    ap.add_argument("--root")
    ap.add_argument("--save", default="")
    ap.add_argument("--inputs", default="")
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    out, work = Path(args.out).resolve(), Path(args.work).resolve()
    out.mkdir(parents=True, exist_ok=True)
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": Path(args.parent).resolve()} if args.parent else {}
    trees["tree"] = Path(args.tree).resolve()
    for v in args.variant:
        label, root = v.split("=", 1)
        trees[label] = Path(root).resolve()
    for label in args.patched:
        if not set(label.split("+")) <= set(PATCHES):
            sys.exit(f"--patched {label}: not among {sorted(PATCHES)}")
        trees[label] = make_patched(trees["tree"], work / label.replace("+", "_"),
                                    label.split("+"))
    t0 = time.perf_counter()
    procs = {}
    for label, root in list(trees.items()):
        while sum(q.poll() is None for q in procs.values()) >= BUILD_TREES:
            time.sleep(1)         # nvcc's memory: a few trees' builds at once
        procs[label] = subprocess.Popen(
            [sys.executable, __file__, "--worker", "build", "--root", str(root), "--save",
             str(out / f"build_{label}.log")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for label, proc in procs.items():
        text = proc.communicate(timeout=1800)[0]
        if proc.returncode:
            if label in ("parent", "tree"):
                sys.exit(f"build of {label} failed:\n{text[-8000:]}")
            print(f"[build] {label} failed, left out:\n{text[-3000:]}", flush=True)
            del trees[label]
            continue
        print(f"[build] {label}: {text.strip().splitlines()[-1]}", flush=True)
    print(f"[build] all trees in {time.perf_counter() - t0:.1f} s", flush=True)

    lines = {label: ptxas_lines((out / f"build_{label}.log").read_text()) for label in trees}
    for label in trees:
        if label == "parent":
            continue
        tiled = sorted((k, v) for k, v in lines[label].items() if "tiled_window" in k)
        print(f"[ptxas] {label}: {len(tiled)} nuts_tiled_window_kernel instances; "
              "registers/spill stores: "
              + ", ".join(sorted({re.sub(r"Used (\d+) registers.*?(\d+) bytes spill stores.*",
                                        r"\1/\2", v) for _, v in tiled})))
    inputs = work / "inputs.pt"
    print(run_worker("inputs", trees["tree"], inputs).strip(), flush=True)
    if not args.skip_lockstep:
        print(run_worker("lockstep", trees["tree"], out / "lockstep.json", inputs).strip(),
              flush=True)
    changed = compare_ptxas(lines) if "parent" in trees else []
    differ = compare_outputs(trees, work) if len(trees) > 1 else []
    if args.skip_timing:
        return 1 if differ else 0

    results = {label: {} for label in trees}
    counts_of = {label: {} for label in trees}
    order = list(trees)
    for label in order + order[::-1]:
        text = run_worker("time", trees[label], inputs=inputs)
        got = json.loads(text.split("TIMES ", 1)[1].splitlines()[0])
        for k, v in got["ms"].items():
            results[label].setdefault(k, []).extend(v)
        counts_of[label].update(got["counts"])
        print(f"[time] {label}: " + ", ".join(
            f"{k} median {statistics.median(v):.4f} ms ({min(v):.4f}-{max(v):.4f})"
            for k, v in got["ms"].items()) + f"; per call {got['counts']}", flush=True)
    print("[time] medians over every rep of each tree (ms), min-max in brackets:")
    for label, r in results.items():
        print(f"  {label}: " + ", ".join(
            f"{k} {statistics.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]" for k, v in r.items()))
    print("[time] by window: each tree's median (min-max) ms, and us per executed "
          "chain-leapfrog (the tree's own leapfrogs a call):")
    for k in results["tree"]:
        cells = []
        for label, r in results.items():
            if k not in r:
                continue
            c = counts_of[label].get(k)
            per = (f", {1000 * statistics.median(r[k]) / (c['leapfrogs'] / c['chains']):.3f} us"
                   if c and c.get("chains") else "")
            cells.append(f"{label} {statistics.median(r[k]):.4f} ({min(r[k]):.4f}-"
                         f"{max(r[k]):.4f}){per}")
        print(f"  {k}: " + "; ".join(cells))
    (out / "times.json").write_text(json.dumps({"card": smi, "times": results,
                                                "counts": counts_of}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
