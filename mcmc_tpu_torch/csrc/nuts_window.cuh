// Fused persistent-NUTS window for NVIDIA Hopper (sm_90a): both proposal
// schemes (endpoint, multinomial) and both metrics (diagonal, dense).
//
// Replaces mcmc_tpu/ops/fused_nuts.py:_make_kernel (built by _build_call for
// make_fused_nuts_window), with its `multinomial` and `dense` flags as the
// template flags MULTI and DENSE: one snapshot window -- n_iters machine
// iterations of up to W leapfrog slots each -- of the persistent-NUTS state
// machine. Per iteration and chain: a fresh transition's start (momentum,
// h0, slice variable, direction); the slots, slot 0 always live and a later
// one only while the subtree is open; at a subtree's end the endpoint store,
// the proposal update, divergence and U-turn tests; then either the
// transition's completion (1/k snapshot reservoir) or the next doubling.
// The plain PyTorch version is mcmc_tpu_torch/ops/fused_nuts.py:
// nuts_window_plain (samplers/nuts_persistent.py:_machine_iteration).
//
// Endpoint scheme: the endpoint-validity proposal swap at each subtree end.
// Multinomial scheme (MULTI): every live leaf enters the subtree's weighted
// reservoir (q_sub, g_sub, lp_sub; log weight lw_sub) with weight
// e^{h0 - h}, a divergent leaf poisons its subtree, and the full recursive
// sub-U-turn check set runs from two checkpoint stacks: leaf i of the
// subtree stores (q, p) at stack slot popcount(i >> 1) when even, and when
// odd checks slots popcount(i >> 1) - trailing_ones(i) + 1 .. popcount(i >> 1)
// (two warp-reduced dot products each). At the subtree's end a valid
// subtree replaces the proposal w.p. min(1, W_sub / W_tree).
// Dense metric (DENSE, variant 4b): v = M^{-1} p and p0 = z @ L^{-1}. The
// U-turn test uses the raw momentum for both metrics. The family
// HIERARCHICAL_LOGISTIC is the TPU kernel's data-carrying form (variant 4c, the
// `data_arrays` refs): the posterior reads X and y from device memory (struct
// TargetData), and its two products with X per leapfrog, not the state traffic,
// set the time.
//
// Two kernels (WARP_WINDOW picks by family). nuts_window_kernel, warp per
// chain, runs every family without data in either metric (4, 4a, 4b,
// 4a+4b; 4b at D <= 32 and 4a at D 33-64 under launch bounds of their own,
// nuts_window_k1_dense_kernel and nuts_window_multi_k2_kernel), M^{-1} and
// L^{-1} in shared memory (metric.cuh:DenseMetric).
// nuts_tiled_window_kernel runs the data-carrying target in either scheme
// and metric (4c, 4a's and 4b's data forms): its products with a matrix
// every chain shares (X, M^{-1}, L^{-1}) are block-tiled as kernel 1's 1d
// is (tiled_step.cuh). At D = 50 a tiled 4b, a warp-per-chain 4b with
// M^{-1} in registers and one with M^{-1} transposed for 16-byte loads were
// all slower than the warp kernel on an H100 (PERF.md section 6).
//
// What bounds it on an H100: each chain's state (14 position-like rows and
// 19 scalars, ~5.8 kB at D = 50; +2 rows and 5 scalars under MULTI) crosses
// device memory once per window, 0.4 GB at 65,536 chains -- ~0.12 ms at
// 3.35 TB/s -- against 64 leapfrogs per chain in a bench window. Each
// leapfrog is the target (one expf and a warp reduction on the funnel), the
// kinetic energy (a second reduction) and the accept expf; a subtree's end
// adds the U-turn test's two reductions, issued together (dot2). Instruction
// issue and the latency of those dependent shuffles, not device memory, set
// the time: 16.5 us a chain-leapfrog at 65,536 x 50 (20 warps an SM). At
// 1,024 chains (~8 warps an SM) each chain's dependent stream alone sets
// it: 0.66 us at D = 2 on N(0, I), 0.9-1.9 us on the L1 shells once their
// functors spread the shells over the lanes (targets.cuh; 1.0-4.2 us with
// the shells in sequence). A probe that cut every butterfly to 3 levels at
// D <= 4 took 2-17% off those windows: lane groups sized to D are not taken
// (PERF.md section 6).
// MULTI adds per leaf a log1pf/expf pair (~5% of 4a at 65,536 x 50), a
// stack store or up to depth checks of two reductions each. An odd leaf's
// first check is against the leaf before it, whose state is still in
// registers, so it waits on no load; with 4a's own launch bound at K = 2
// (nuts_window_multi_k2_kernel) that took 4a from 2.07 to 1.81 ms at 65,536
// x 50. DENSE adds per leapfrog two D x D products (velocity and kinetic
// energy), 2 D^2 multiply-adds per chain: at D = 50 these, not the target,
// set the time. Each multiply-add reads two shared words, and the
// load/store unit sets the pace.
//
// Design of nuts_window_kernel: one warp per chain, as kernels 1 and 2. Lane j
// holds coordinates j, j+32, ... of all rows (K = ceil(D / 32) registers each),
// which stay in registers for the whole window; the per-chain scalars sit in
// every lane's registers, identical across the warp. Every per-chain mask of
// the TPU kernel (jnp.where on needs_start, a live slot, a boundary, term or
// cont) is a warp-uniform branch here, so a chain skips what it does not need:
// masked slots are not computed at all, and a chain draws its momentum and
// flags only when it starts or reaches a boundary. Counters are int32, not the
// TPU kernel's f32 rows. The public (C, D) row-major layout is read and written
// as is. The checkpoint stacks (C, max_tree_depth, D) x 2, 4 kB per chain at D
// = 50, are state that outlives the window: the kernel stores and checks them
// in place in device memory rather than in registers (a data-dependent slot
// would make every access an unrolled select over all slots, 2 S K more
// registers) or in shared memory (a copy in and out of the whole stacks every
// window). A lane touches only its own coordinates; the stacks of the resident
// chains, ~2,000 x 4 kB, stay in the 50 MB L2.
//
// Design of nuts_tiled_window_kernel: a block owns WINDOW_TILE_CHAINS
// chains, one warp each, and runs the machine above with block-uniform control and per-chain state.
// Each iteration the block decides together whether any chain starts
// (live_tile, one barrier) and runs the start's unwhitening and kinetic
// products for the starting chains only; then, slot by slot, whether any chain
// is live in slot k, runs that slot's velocity, target and kinetic products for
// the live chains only (their rows compacted into the tile's first columns:
// ceil(live / 4) chain tiles), and leaves the slot loop when none is. A warp
// whose chain is not live does no arithmetic of its own (its threads still take
// their share of the live chains' product tiles) and waits at the barriers, so
// the lockstep costs latency, not issue slots. Everything per chain stays in
// its warp with no barrier: Philox, flags, the MH sums, the reservoir, the
// stacks, the subtree-boundary bookkeeping and the U-turn dot products. A warp
// past n_chains is never live and stores nothing. Registers (at 32 chains a
// block a thread has 64): only the trajectory's current state q_c, p_c, g_c
// stays in registers across the window; the rows that only starts and subtree
// ends touch (q, grad, q_l, p_l, g_l, q_r, p_r, g_r, q_prop, g_prop, q_res, and
// under MULTI q_sub, g_sub) are read and written in place in device memory at
// those points, as the checkpoint stacks are. Every sum runs in the warp
// kernel's order, each product rounded before it is added, so the outputs equal
// the warp kernel's bit for bit (tiled_step.cuh: the tile only decides which
// thread computes which output).
//
// Randomness: injected (draws non-null: p0 (n_iters, C, D), dir, dir2 bool,
// swap, res float (n_iters, C), slice (n_iters, C), or (n_iters * W, C)
// under MULTI with slot k of iteration i at row i * W + k) or Philox4x32-10
// with counter (chain, call, iteration, draw): the momentum from draws
// 0..31 as in philox.cuh, (dir, dir2, swap, slice) from the four words of
// FLAGS_DRAW, the reservoir uniform from word x0 of RES_DRAW, and under
// MULTI slot k's leaf uniform from word k % 4 of draw SLICE_DRAW + k / 4;
// slot 0's leaf uniform is also the start's slice variable there.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "chain_rows.cuh"
#include "metric.cuh"
#include "philox.cuh"
#include "targets.cuh"
#include "tiled_step.cuh"

namespace mcmc {
namespace nuts {

constexpr uint32_t FLAGS_DRAW = 32;
constexpr uint32_t RES_DRAW = 33;
constexpr uint32_t SLICE_DRAW = 34;
constexpr float NAN_ACCEPT_FALLBACK = 0.65f;

// The dense variant shares its block's M^{-1} and L^{-1} among more warps.
template <bool DENSE>
constexpr int WARPS_PER_BLOCK = DENSE ? 8 : 4;
static_assert(WARPS_PER_BLOCK<true> <= TARGET_MAX_WARPS, "targets.cuh stages one row per warp");

// Chains a block of the tiled window (one warp each): as many as a block
// can hold, each load of X from L2 serving 32 chains, as in kernel 1's 1d
// (tiled_step.cuh:TiledHierarchical, whose chains these are).
constexpr int WINDOW_TILE_CHAINS = HIER_TILE_CHAINS;
// the live-chain flags (live_tile's two buffers), static shared memory
constexpr int WINDOW_FLAG_BYTES = 2 * WINDOW_TILE_CHAINS * static_cast<int>(sizeof(int));
static_assert(tile_layout(32 * MAX_K, true, TILE_MIN_ROWS, WINDOW_TILE_CHAINS).bytes +
                      WINDOW_FLAG_BYTES <= MAX_TILE_SMEM,
              "the smallest row tile fits at the largest D, with the dense metric");

// The tiled window's geometry: kernel 1's tile layout (tiled_step.cuh) at
// the window's chains a block, the largest row tile that fits beside the
// live-chain flags. ops/fused_nuts.py:tile_geometry mirrors it.
__host__ __device__ inline TileGeometry window_tile_geometry(int dim, bool dense) {
  for (int rows = TILE_MAX_ROWS; rows >= TILE_MIN_ROWS; rows /= 2) {
    const TileGeometry g = tile_layout(dim, dense, rows, WINDOW_TILE_CHAINS);
    if (g.bytes + WINDOW_FLAG_BYTES <= MAX_TILE_SMEM) return g;
  }
  return TileGeometry{};
}

// Field order must match KERNEL_FIELDS in mcmc_tpu_torch/ops/fused_nuts.py.
struct State {
  float *q, *grad, *q_l, *p_l, *g_l, *q_r, *p_r, *g_r, *q_prop, *g_prop, *q_c, *p_c, *g_c,
      *q_res;                                                                // (C, D)
  float *lp, *lp_prop, *h0, *log_u, *sum_alpha, *direction, *alpha_acc, *lp_res;  // (C,)
  int *n_valid, *n_steps, *depth, *steps_left, *transitions, *divergences, *depth_acc,
      *n_exec, *k_res;                                                       // (C,)
  bool *diverged, *needs_start;                                              // (C,)
  // multinomial scheme only (null otherwise)
  float *q_sub, *g_sub;              // (C, D)
  float *lp_sub, *lw_tree, *lw_sub;  // (C,)
  bool *div_sub, *turn_sub;          // (C,)
  float *q_stk, *p_stk;              // (C, max_tree_depth, D)
};
constexpr size_t N_STATE_FIELDS = 42;
static_assert(sizeof(State) == N_STATE_FIELDS * sizeof(void*), "State is a pointer array");

struct Draws {
  const float* p0;
  const bool *dir, *dir2;
  const float *swap, *slice, *res;
};
static_assert(sizeof(Draws) == 6 * sizeof(void*), "Draws is a pointer array");

struct Args {
  int dim, n_chains, n_iters, slots, max_tree_depth;
  TargetParams params;
  TargetData data;
  const float* scalars;  // (step size, delta_max), device
  const float* inv_mass;  // (D,) or, DENSE, (D, D)
  const float* l_inv;     // DENSE: (D, D) L^{-1}
  const uint32_t* key;
  uint32_t call;
  State s;
  Draws d;  // d.p0 null: Philox
};

struct Flags {
  bool dir, dir2;
  float swap, slice;
};

__device__ __forceinline__ Flags load_flags(const Args& a, size_t slot, uint32_t chain,
                                            uint32_t it, uint32_t k0, uint32_t k1) {
  if (a.d.p0 != nullptr) return {a.d.dir[slot], a.d.dir2[slot], a.d.swap[slot], a.d.slice[slot]};
  const uint4 x = philox4x32_10(make_uint4(chain, a.call, it, FLAGS_DRAW), k0, k1);
  return {bits_to_uniform(x.x) < 0.5f, bits_to_uniform(x.y) < 0.5f, bits_to_uniform(x.z),
          bits_to_uniform(x.w)};
}

// The multinomial scheme's per-slot leaf uniforms of one iteration; a
// Philox block serves four slots.
struct SliceStream {
  uint4 block;
  int block_idx = -1;

  __device__ __forceinline__ float get(const Args& a, int k, uint32_t chain, uint32_t it,
                                       uint32_t k0, uint32_t k1) {
    if (a.d.p0 != nullptr) {
      return a.d.slice[(static_cast<size_t>(it) * a.slots + k) * a.n_chains + chain];
    }
    if (k / 4 != block_idx) {
      block_idx = k / 4;
      block = philox4x32_10(
          make_uint4(chain, a.call, it, SLICE_DRAW + static_cast<uint32_t>(block_idx)), k0, k1);
    }
    switch (k % 4) {
      case 0: return bits_to_uniform(block.x);
      case 1: return bits_to_uniform(block.y);
      case 2: return bits_to_uniform(block.z);
      default: return bits_to_uniform(block.w);
    }
  }
};

template <int K>
__device__ __forceinline__ void copy(float (&dst)[K], const float (&src)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) dst[r] = src[r];
}

// Per-chain dot product; every lane gets it.
template <int K>
__device__ __forceinline__ float dot(const float (&a)[K], const float (&b)[K]) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) s += a[r] * b[r];
  return warp_sum(s);
}

// Two per-chain dot products, a . b and a . c, their butterflies issued
// together: each equals dot()'s bits, in one butterfly's latency.
template <int K>
__device__ __forceinline__ float2 dot2(const float (&a)[K], const float (&b)[K],
                                       const float (&c)[K]) {
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    s += a[r] * b[r];
    t += a[r] * c[r];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    s += __shfl_xor_sync(FULL_MASK, s, offset);
    t += __shfl_xor_sync(FULL_MASK, t, offset);
  }
  return make_float2(s, t);
}

// log(e^a + e^b) as max + log1p(exp(min - max)); -inf when both are -inf.
__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float mx = fmaxf(a, b), mn = fminf(a, b);
  return mx == -INFINITY ? mx : mx + log1pf(expf(mn - mx));
}

// Which kernel runs a family (the design notes at the top of this file):
// nuts_window_kernel, warp per chain, every family without data (4, 4a, 4b,
// 4a+4b); nuts_tiled_window_kernel the data set (4c, 4a's and 4b's data
// forms).
template <int FAMILY>
constexpr bool WARP_WINDOW = FAMILY != HIERARCHICAL_LOGISTIC;

// The warp-per-chain window (WARP_WINDOW): 4, 4a, 4b and 4a+4b, the body of
// nuts_window_kernel and nuts_window_k1_dense_kernel (below).
template <int FAMILY, int K, bool MULTI, bool DENSE>
__device__ __forceinline__ void warp_window(const Args& a) {
  static_assert(WARP_WINDOW<FAMILY>, "4c runs nuts_tiled_window_kernel");
  constexpr int WARPS = WARPS_PER_BLOCK<DENSE>;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * WARPS + warp;
  const int lane = threadIdx.x & 31;
  const int dim = a.dim;

  extern __shared__ __align__(16) float smem[];
  const Metric<K, DENSE> metric =
      make_metric<K, DENSE>(a.inv_mass, a.l_inv, dim, smem, warp, lane);
  if (chain >= a.n_chains) return;  // uniform across the warp

  const size_t row = static_cast<size_t>(chain) * dim;
  const Target<FAMILY, K> target(dim, a.params, a.data);
  const float step = a.scalars[0];
  const float delta_max = a.scalars[1];
  const bool philox = a.d.p0 == nullptr;
  const uint32_t k0 = philox ? a.key[0] : 0u, k1 = philox ? a.key[1] : 0u;

  const State& S = a.s;
  float q[K], grad[K], q_l[K], p_l[K], g_l[K], q_r[K], p_r[K], g_r[K], q_prop[K], g_prop[K],
      q_c[K], p_c[K], g_c[K], q_res[K];
  load_row(S.q, row, lane, dim, q);
  load_row(S.grad, row, lane, dim, grad);
  load_row(S.q_l, row, lane, dim, q_l);
  load_row(S.p_l, row, lane, dim, p_l);
  load_row(S.g_l, row, lane, dim, g_l);
  load_row(S.q_r, row, lane, dim, q_r);
  load_row(S.p_r, row, lane, dim, p_r);
  load_row(S.g_r, row, lane, dim, g_r);
  load_row(S.q_prop, row, lane, dim, q_prop);
  load_row(S.g_prop, row, lane, dim, g_prop);
  load_row(S.q_c, row, lane, dim, q_c);
  load_row(S.p_c, row, lane, dim, p_c);
  load_row(S.g_c, row, lane, dim, g_c);
  load_row(S.q_res, row, lane, dim, q_res);
  float lp = S.lp[chain], lp_prop = S.lp_prop[chain], h0 = S.h0[chain],
        log_u = S.log_u[chain], sum_alpha = S.sum_alpha[chain],
        direction = S.direction[chain], alpha_acc = S.alpha_acc[chain],
        lp_res = S.lp_res[chain];
  int n_valid = S.n_valid[chain], n_steps = S.n_steps[chain], depth = S.depth[chain],
      steps_left = S.steps_left[chain], transitions = S.transitions[chain],
      divergences = S.divergences[chain], depth_acc = S.depth_acc[chain],
      n_exec = S.n_exec[chain], k_res = S.k_res[chain];
  bool diverged = S.diverged[chain], needs_start = S.needs_start[chain];

  // multinomial scheme: the subtree's reservoir and this chain's stacks
  float q_sub[MULTI ? K : 1], g_sub[MULTI ? K : 1];
  float lp_sub = 0.f, lw_tree = 0.f, lw_sub = 0.f;
  bool div_sub = false, turn_sub = false;
  float *q_stk = nullptr, *p_stk = nullptr;
  if constexpr (MULTI) {
    load_row(S.q_sub, row, lane, dim, q_sub);
    load_row(S.g_sub, row, lane, dim, g_sub);
    lp_sub = S.lp_sub[chain], lw_tree = S.lw_tree[chain], lw_sub = S.lw_sub[chain];
    div_sub = S.div_sub[chain], turn_sub = S.turn_sub[chain];
    const size_t stk = static_cast<size_t>(chain) * a.max_tree_depth * dim;
    q_stk = S.q_stk + stk;
    p_stk = S.p_stk + stk;
  }

  for (int it = 0; it < a.n_iters; ++it) {
    const size_t slot = static_cast<size_t>(it) * a.n_chains + chain;  // (n_iters, C) index
    const uint32_t uit = static_cast<uint32_t>(it);
    Flags f{};
    bool have_flags = false;
    SliceStream slices;

    // --- 1. fresh-transition start ---------------------------------------
    if (needs_start) {
      float p0[K];
      if (philox) {
        philox_normal_row(p0, lane, dim, chain, a.call, uit, k0, k1);
      } else {
        load_row(a.d.p0, slot * dim, lane, dim, p0);
      }
      metric.unwhiten(p0);
      f = load_flags(a, slot, chain, uit, k0, k1);
      have_flags = true;
      h0 = -lp + metric.kinetic(p0);
      const float slice_u = MULTI ? slices.get(a, 0, chain, uit, k0, k1) : f.slice;
      log_u = logf(slice_u) - h0;
      copy(q_l, q), copy(p_l, p0), copy(g_l, grad);
      copy(q_r, q), copy(p_r, p0), copy(g_r, grad);
      copy(q_prop, q), copy(g_prop, grad);
      copy(q_c, q), copy(p_c, p0), copy(g_c, grad);
      lp_prop = lp;
      n_valid = 1;
      sum_alpha = 0.f;
      n_steps = 0;
      depth = 0;
      steps_left = 1;
      direction = f.dir ? 1.f : -1.f;
      diverged = false;
      needs_start = false;
      if constexpr (MULTI) {
        // the root tree: the initial state with weight e^0 = 1; the
        // subtree reservoir starts empty
        copy(q_sub, q), copy(g_sub, grad);
        lp_sub = lp;
        lw_tree = 0.f;
        lw_sub = -INFINITY;
        div_sub = false;
        turn_sub = false;
      }
    }

    // --- 2. leapfrog slots: slot 0 always, later ones while the subtree
    // is open (a closed subtree's remaining slots are skipped) -------------
    const float eps = direction * step;
    const float half = 0.5f * eps;
    constexpr bool ROUNDED = DENSE || ROUNDED_LEAPFROG<FAMILY>;
    float lp_c = lp, h_c = h0;
    for (int k = 0; k < a.slots; ++k) {
      if (k > 0 && steps_left <= 0) break;
      float p[K], qn[K], gn[K], v[K];
#pragma unroll
      for (int r = 0; r < K; ++r) p[r] = add_scaled<ROUNDED>(p_c[r], half, g_c[r]);
      metric.velocity(p, v);
#pragma unroll
      for (int r = 0; r < K; ++r) qn[r] = add_scaled<ROUNDED>(q_c[r], eps, v[r]);
      lp_c = target(qn, gn, lane);
#pragma unroll
      for (int r = 0; r < K; ++r) p[r] = add_scaled<ROUNDED>(p[r], half, gn[r]);
      h_c = -lp_c + metric.kinetic(p);
      const float dh = h0 - h_c;
      sum_alpha += expf(dh > 0.f ? 0.f : dh);  // min(0, dh), NaN kept
      // the previous leaf's state, the multinomial scheme's first check
      float q_prev[MULTI ? K : 1], p_prev[MULTI ? K : 1];
      if constexpr (MULTI) copy(q_prev, q_c), copy(p_prev, p_c);
      copy(q_c, qn), copy(p_c, p), copy(g_c, gn);
      ++n_steps;
      ++n_exec;
      --steps_left;

      if constexpr (MULTI) {
        // the leaf's weighted reservoir; both weights -inf: no take
        const float su = slices.get(a, k, chain, uit, k0, k1);
        const bool fin = isfinite(h_c);
        const float lw_leaf = fin ? h0 - h_c : -INFINITY;
        const float lse = log_add_exp(lw_sub, lw_leaf);
        const bool dead = lw_leaf == -INFINITY && lw_sub == -INFINITY;
        if (!dead && su < expf(lw_leaf - lse)) {
          copy(q_sub, q_c), copy(g_sub, g_c);
          lp_sub = lp_c;
        }
        lw_sub = lse;
        div_sub = div_sub || !fin || (h_c - h0) > delta_max;

        // checkpoint stacks: even leaves store, odd leaves check
        const int i_leaf = (1 << depth) - steps_left - 1;
        const int sslot = __popc(i_leaf >> 1);
        if ((i_leaf & 1) == 0) {
          const size_t at = static_cast<size_t>(sslot) * dim;
          store_row(q_stk, at, lane, dim, q_c);
          store_row(p_stk, at, lane, dim, p_c);
        } else if (!turn_sub) {  // a set flag stays set: the checks would change nothing
          // Slot sslot holds leaf i_leaf - 1 of this subtree, the previous
          // leapfrog's state, still in registers; a later slot's rows are
          // loaded when its check starts.
          const int lo = sslot - (__popc(i_leaf ^ (i_leaf + 1)) - 1) + 1;
          float qs[K], ps[K];
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
          }
        }
      }
    }

    // --- 3. subtree-boundary bookkeeping ----------------------------------
    if (steps_left > 0) continue;
    if (direction > 0.f) {
      copy(q_r, q_c), copy(p_r, p_c), copy(g_r, g_c);
    } else {
      copy(q_l, q_c), copy(p_l, p_c), copy(g_l, g_c);
    }
    if (!have_flags) f = load_flags(a, slot, chain, uit, k0, k1);
    if constexpr (MULTI) {
      // biased progressive subtree merge (Stan): a valid subtree replaces
      // the proposal w.p. min(1, W_sub / W_tree)
      const bool sub_ok = !div_sub && !turn_sub && isfinite(lw_sub);
      const float dl = lw_sub - lw_tree;
      if (sub_ok && f.swap < expf(dl > 0.f ? 0.f : dl)) {
        copy(q_prop, q_sub), copy(g_prop, g_sub);
        lp_prop = lp_sub;
      }
      if (sub_ok) lw_tree = log_add_exp(lw_tree, lw_sub);
      diverged = diverged || div_sub;
    } else {
      // endpoint-validity proposal swap (reference NUTS.py:319-336)
      const bool div_new = (h_c - h0) > delta_max;
      const bool valid = (log_u <= -h_c) && !div_new;
      const int n_new = valid ? (1 << depth) : 0;
      const int total = n_valid + n_new;
      const float swap_prob =
          (valid && total > 0) ? static_cast<float>(n_new) / static_cast<float>(max(total, 1))
                               : 0.f;
      if (f.swap < swap_prob) {
        copy(q_prop, q_c), copy(g_prop, g_c);
        lp_prop = lp_c;
      }
      n_valid = total;
      diverged = diverged || div_new;
    }

    // termination, evaluated after the doubling (reference while cond); a
    // subtree with an internal U-turn ends the trajectory as well
    float dq[K];
#pragma unroll
    for (int r = 0; r < K; ++r) dq[r] = q_r[r] - q_l[r];
    const float2 ends = dot2(dq, p_l, p_r);
    const bool u_turn = ends.x < 0.f || ends.y < 0.f;
    if (depth + 1 >= a.max_tree_depth || u_turn || diverged || (MULTI && turn_sub)) {
      // the transition completes: adopt the proposal, log its statistics
      float mean_alpha = sum_alpha / static_cast<float>(max(n_steps, 1));
      if (!isfinite(mean_alpha)) mean_alpha = NAN_ACCEPT_FALLBACK;
      copy(q, q_prop), copy(grad, g_prop);
      lp = lp_prop;
      ++transitions;
      divergences += diverged ? 1 : 0;
      alpha_acc += mean_alpha;
      depth_acc += depth + 1;
      needs_start = true;
      // the k-th completion of the window replaces the reservoir w.p. 1/k
      ++k_res;
      const float res_u =
          philox ? bits_to_uniform(philox4x32_10(make_uint4(chain, a.call, uit, RES_DRAW), k0, k1).x)
                 : a.d.res[slot];
      if (res_u * static_cast<float>(k_res) < 1.f) {
        copy(q_res, q_prop);
        lp_res = lp_prop;
      }
    } else {
      // the trajectory continues: next doubling from the chosen end
      ++depth;
      steps_left = 1 << depth;
      direction = f.dir2 ? 1.f : -1.f;
      if (f.dir2) {
        copy(q_c, q_r), copy(p_c, p_r), copy(g_c, g_r);
      } else {
        copy(q_c, q_l), copy(p_c, p_l), copy(g_c, g_l);
      }
      if constexpr (MULTI) {  // a fresh subtree: an empty reservoir
        lw_sub = -INFINITY;
        div_sub = false;
        turn_sub = false;
      }
    }
  }

  store_row(S.q, row, lane, dim, q);
  store_row(S.grad, row, lane, dim, grad);
  store_row(S.q_l, row, lane, dim, q_l);
  store_row(S.p_l, row, lane, dim, p_l);
  store_row(S.g_l, row, lane, dim, g_l);
  store_row(S.q_r, row, lane, dim, q_r);
  store_row(S.p_r, row, lane, dim, p_r);
  store_row(S.g_r, row, lane, dim, g_r);
  store_row(S.q_prop, row, lane, dim, q_prop);
  store_row(S.g_prop, row, lane, dim, g_prop);
  store_row(S.q_c, row, lane, dim, q_c);
  store_row(S.p_c, row, lane, dim, p_c);
  store_row(S.g_c, row, lane, dim, g_c);
  store_row(S.q_res, row, lane, dim, q_res);
  if constexpr (MULTI) {
    store_row(S.q_sub, row, lane, dim, q_sub);
    store_row(S.g_sub, row, lane, dim, g_sub);
  }
  if (lane == 0) {
    S.lp[chain] = lp, S.lp_prop[chain] = lp_prop, S.h0[chain] = h0, S.log_u[chain] = log_u;
    S.sum_alpha[chain] = sum_alpha, S.direction[chain] = direction;
    S.alpha_acc[chain] = alpha_acc, S.lp_res[chain] = lp_res;
    S.n_valid[chain] = n_valid, S.n_steps[chain] = n_steps, S.depth[chain] = depth;
    S.steps_left[chain] = steps_left, S.transitions[chain] = transitions;
    S.divergences[chain] = divergences, S.depth_acc[chain] = depth_acc;
    S.n_exec[chain] = n_exec, S.k_res[chain] = k_res;
    S.diverged[chain] = diverged, S.needs_start[chain] = needs_start;
    if constexpr (MULTI) {
      S.lp_sub[chain] = lp_sub, S.lw_tree[chain] = lw_tree, S.lw_sub[chain] = lw_sub;
      S.div_sub[chain] = div_sub, S.turn_sub[chain] = turn_sub;
    }
  }
}

template <int FAMILY, int K, bool MULTI, bool DENSE>
__global__ void __launch_bounds__(WARPS_PER_BLOCK<DENSE> * 32)
    nuts_window_kernel(const Args a) {
  warp_window<FAMILY, K, MULTI, DENSE>(a);
}

// 4b at K = 1 (D <= 32), asking the compiler for 3 blocks of 8 warps an SM
// (85 registers a thread). Its own choice, 64, made Rosenbrock's 1,024 x
// 10 window 14% slower after the products' reorder; 80 registers under
// this bound took it back below its time before (PERF.md section 6). Few
// blocks run at such a shape, so occupancy does not bind; at K = 2 the
// bound gained nothing, and at K = 4 it spilled.
template <int FAMILY>
__global__ void __launch_bounds__(WARPS_PER_BLOCK<true> * 32, 3)
    nuts_window_k1_dense_kernel(const Args a) {
  warp_window<FAMILY, 1, false, true>(a);
}

// 4a at K = 2 (D 33-64; the NUTS-multinomial row's 50-D funnel), asking
// the compiler for 5 blocks of 4 warps an SM (96 registers a thread, 40
// bytes spilled). Its own choice, 110 registers and 4 blocks, was 7% slower
// at 65,536 x 50; a minimum of blocks on every instance gave the others
// more registers and made kernel 4 13% slower there (PERF.md section 6).
template <int FAMILY>
__global__ void __launch_bounds__(WARPS_PER_BLOCK<false> * 32, 5)
    nuts_window_multi_k2_kernel(const Args a) {
  warp_window<FAMILY, 2, true, false>(a);
}

// The warp window's kernel for an instance.
template <int FAMILY, int K, bool MULTI, bool DENSE>
auto warp_window_kernel() {
  if constexpr (DENSE && !MULTI && K == 1) {
    return nuts_window_k1_dense_kernel<FAMILY>;
  } else if constexpr (MULTI && !DENSE && K == 2) {
    return nuts_window_multi_k2_kernel<FAMILY>;
  } else {
    return nuts_window_kernel<FAMILY, K, MULTI, DENSE>;
  }
}

// A row of a chain's state in device memory, copied in place (the tiled
// window's rows that only starts and subtree ends touch).
template <int K>
__device__ __forceinline__ void copy_row(float* dst, const float* src, size_t row, int lane,
                                         int dim) {
  float v[K];
  load_row(src, row, lane, dim, v);
  store_row(dst, row, lane, dim, v);
}

// Variant 4c (the hierarchical family, either metric) in either scheme: C
// chains a block, one warp each (the design at the top of this file). The
// machine is nuts_window_kernel's, step for step; the block-wide calls
// (live_tile, the metric's products, the target) are made by every warp at
// block-uniform points.
template <int K, bool MULTI, bool DENSE>
__global__ void __launch_bounds__(32 * WINDOW_TILE_CHAINS)
    nuts_tiled_window_kernel(const Args a, const TileGeometry geo) {
  constexpr int C = WINDOW_TILE_CHAINS;
  extern __shared__ float4 tile_smem[];
  __shared__ int live_flags[2][C];
  float* smem = reinterpret_cast<float*>(tile_smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * C + warp;
  const bool real = chain < a.n_chains;  // a warp past n_chains is never live
  const int dim = a.dim;
  const TileMetric<K, DENSE, C> metric = make_tile_metric<K, DENSE, C>(a, geo, smem, warp, lane);
  const TiledHierarchical<K> target(a.data, geo, smem, warp);

  const size_t row = static_cast<size_t>(real ? chain : 0) * dim;
  const float step = a.scalars[0];
  const float delta_max = a.scalars[1];
  const bool philox = a.d.p0 == nullptr;
  const uint32_t k0 = philox ? a.key[0] : 0u, k1 = philox ? a.key[1] : 0u;

  const State& S = a.s;
  float q_c[K], p_c[K], g_c[K];
#pragma unroll
  for (int r = 0; r < K; ++r) q_c[r] = p_c[r] = g_c[r] = 0.f;
  float lp = 0.f, lp_prop = 0.f, h0 = 0.f, log_u = 0.f, sum_alpha = 0.f, direction = 1.f,
        alpha_acc = 0.f, lp_res = 0.f;
  int n_valid = 0, n_steps = 0, depth = 0, steps_left = 0, transitions = 0, divergences = 0,
      depth_acc = 0, n_exec = 0, k_res = 0;
  bool diverged = false, needs_start = false;
  // multinomial scheme: the subtree's reservoir weights and this chain's stacks
  float lp_sub = 0.f, lw_tree = 0.f, lw_sub = 0.f;
  bool div_sub = false, turn_sub = false;
  float *q_stk = nullptr, *p_stk = nullptr;
  if (real) {
    load_row(S.q_c, row, lane, dim, q_c);
    load_row(S.p_c, row, lane, dim, p_c);
    load_row(S.g_c, row, lane, dim, g_c);
    lp = S.lp[chain], lp_prop = S.lp_prop[chain], h0 = S.h0[chain], log_u = S.log_u[chain];
    sum_alpha = S.sum_alpha[chain], direction = S.direction[chain];
    alpha_acc = S.alpha_acc[chain], lp_res = S.lp_res[chain];
    n_valid = S.n_valid[chain], n_steps = S.n_steps[chain], depth = S.depth[chain];
    steps_left = S.steps_left[chain], transitions = S.transitions[chain];
    divergences = S.divergences[chain], depth_acc = S.depth_acc[chain];
    n_exec = S.n_exec[chain], k_res = S.k_res[chain];
    diverged = S.diverged[chain], needs_start = S.needs_start[chain];
    if constexpr (MULTI) {
      lp_sub = S.lp_sub[chain], lw_tree = S.lw_tree[chain], lw_sub = S.lw_sub[chain];
      div_sub = S.div_sub[chain], turn_sub = S.turn_sub[chain];
      const size_t stk = static_cast<size_t>(chain) * a.max_tree_depth * dim;
      q_stk = S.q_stk + stk;
      p_stk = S.p_stk + stk;
    }
  }

  int calls = 0;  // live_tile calls so far: their buffers take turns
  for (int it = 0; it < a.n_iters; ++it) {
    const size_t slot = static_cast<size_t>(it) * a.n_chains + chain;  // (n_iters, C) index
    const uint32_t uit = static_cast<uint32_t>(it);
    Flags f{};
    bool have_flags = false;
    SliceStream slices;

    // --- 1. fresh-transition start, its products over the starting chains
    const bool starting = real && needs_start;
    const LiveTile st = live_tile<C>(starting, live_flags[calls++ & 1], warp, lane);
    if (st.n > 0) {
      float p0[K];
#pragma unroll
      for (int r = 0; r < K; ++r) p0[r] = 0.f;
      if (starting) {
        if (philox) {
          philox_normal_row(p0, lane, dim, chain, a.call, uit, k0, k1);
        } else {
          load_row(a.d.p0, slot * dim, lane, dim, p0);
        }
      }
      metric.unwhiten(p0, st);
      const float ke = metric.kinetic(p0, st);
      if (starting) {
        f = load_flags(a, slot, chain, uit, k0, k1);
        have_flags = true;
        h0 = -lp + ke;
        const float slice_u = MULTI ? slices.get(a, 0, chain, uit, k0, k1) : f.slice;
        log_u = logf(slice_u) - h0;
        load_row(S.q, row, lane, dim, q_c);
        load_row(S.grad, row, lane, dim, g_c);
        copy(p_c, p0);
        store_row(S.q_l, row, lane, dim, q_c), store_row(S.p_l, row, lane, dim, p_c);
        store_row(S.g_l, row, lane, dim, g_c);
        store_row(S.q_r, row, lane, dim, q_c), store_row(S.p_r, row, lane, dim, p_c);
        store_row(S.g_r, row, lane, dim, g_c);
        store_row(S.q_prop, row, lane, dim, q_c), store_row(S.g_prop, row, lane, dim, g_c);
        lp_prop = lp;
        n_valid = 1;
        sum_alpha = 0.f;
        n_steps = 0;
        depth = 0;
        steps_left = 1;
        direction = f.dir ? 1.f : -1.f;
        diverged = false;
        needs_start = false;
        if constexpr (MULTI) {
          // the root tree: the initial state with weight e^0 = 1; the
          // subtree reservoir starts empty
          store_row(S.q_sub, row, lane, dim, q_c), store_row(S.g_sub, row, lane, dim, g_c);
          lp_sub = lp;
          lw_tree = 0.f;
          lw_sub = -INFINITY;
          div_sub = false;
          turn_sub = false;
        }
      }
    }

    // --- 2. leapfrog slots: slot 0 of every chain, a later one while the
    // chain's subtree is open; the block runs a slot while any chain is live
    const float eps = direction * step;
    const float half = 0.5f * eps;
    constexpr bool ROUNDED = DENSE || ROUNDED_LEAPFROG<HIERARCHICAL_LOGISTIC>;
    float lp_c = lp, h_c = h0;
    for (int k = 0; k < a.slots; ++k) {
      const bool live = real && (k == 0 || steps_left > 0);
      const LiveTile lt = live_tile<C>(live, live_flags[calls++ & 1], warp, lane);
      if (lt.n == 0) break;  // uniform across the block
      float p[K], qn[K], gn[K], v[K];
      if (live) {
#pragma unroll
        for (int r = 0; r < K; ++r) p[r] = add_scaled<ROUNDED>(p_c[r], half, g_c[r]);
      }
      metric.velocity(p, v, lt);
      if (live) {
#pragma unroll
        for (int r = 0; r < K; ++r) qn[r] = add_scaled<ROUNDED>(q_c[r], eps, v[r]);
      }
      const float lp_n = target(qn, gn, lane, lt);
      if (live) {
#pragma unroll
        for (int r = 0; r < K; ++r) p[r] = add_scaled<ROUNDED>(p[r], half, gn[r]);
      }
      const float ke = metric.kinetic(p, lt);
      if (!live) continue;
      lp_c = lp_n;
      h_c = -lp_c + ke;
      const float dh = h0 - h_c;
      sum_alpha += expf(dh > 0.f ? 0.f : dh);  // min(0, dh), NaN kept
      copy(q_c, qn), copy(p_c, p), copy(g_c, gn);
      ++n_steps;
      ++n_exec;
      --steps_left;

      if constexpr (MULTI) {
        // the leaf's weighted reservoir; both weights -inf: no take
        const float su = slices.get(a, k, chain, uit, k0, k1);
        const bool fin = isfinite(h_c);
        const float lw_leaf = fin ? h0 - h_c : -INFINITY;
        const float lse = log_add_exp(lw_sub, lw_leaf);
        const bool dead = lw_leaf == -INFINITY && lw_sub == -INFINITY;
        if (!dead && su < expf(lw_leaf - lse)) {
          store_row(S.q_sub, row, lane, dim, q_c), store_row(S.g_sub, row, lane, dim, g_c);
          lp_sub = lp_c;
        }
        lw_sub = lse;
        div_sub = div_sub || !fin || (h_c - h0) > delta_max;

        // checkpoint stacks: even leaves store, odd leaves check
        const int i_leaf = (1 << depth) - steps_left - 1;
        const int sslot = __popc(i_leaf >> 1);
        if ((i_leaf & 1) == 0) {
          const size_t at = static_cast<size_t>(sslot) * dim;
          store_row(q_stk, at, lane, dim, q_c);
          store_row(p_stk, at, lane, dim, p_c);
        } else if (!turn_sub) {  // a set flag stays set: the checks would change nothing
          const int lo = sslot - (__popc(i_leaf ^ (i_leaf + 1)) - 1) + 1;
          for (int si = sslot; si >= lo; --si) {
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
          }
        }
      }
    }

    // --- 3. subtree-boundary bookkeeping, per chain ------------------------
    if (!real || steps_left > 0) continue;
    if (direction > 0.f) {
      store_row(S.q_r, row, lane, dim, q_c), store_row(S.p_r, row, lane, dim, p_c);
      store_row(S.g_r, row, lane, dim, g_c);
    } else {
      store_row(S.q_l, row, lane, dim, q_c), store_row(S.p_l, row, lane, dim, p_c);
      store_row(S.g_l, row, lane, dim, g_c);
    }
    if (!have_flags) f = load_flags(a, slot, chain, uit, k0, k1);
    if constexpr (MULTI) {
      // biased progressive subtree merge (Stan): a valid subtree replaces
      // the proposal w.p. min(1, W_sub / W_tree)
      const bool sub_ok = !div_sub && !turn_sub && isfinite(lw_sub);
      const float dl = lw_sub - lw_tree;
      if (sub_ok && f.swap < expf(dl > 0.f ? 0.f : dl)) {
        copy_row<K>(S.q_prop, S.q_sub, row, lane, dim);
        copy_row<K>(S.g_prop, S.g_sub, row, lane, dim);
        lp_prop = lp_sub;
      }
      if (sub_ok) lw_tree = log_add_exp(lw_tree, lw_sub);
      diverged = diverged || div_sub;
    } else {
      // endpoint-validity proposal swap (reference NUTS.py:319-336)
      const bool div_new = (h_c - h0) > delta_max;
      const bool valid = (log_u <= -h_c) && !div_new;
      const int n_new = valid ? (1 << depth) : 0;
      const int total = n_valid + n_new;
      const float swap_prob =
          (valid && total > 0) ? static_cast<float>(n_new) / static_cast<float>(max(total, 1))
                               : 0.f;
      if (f.swap < swap_prob) {
        store_row(S.q_prop, row, lane, dim, q_c), store_row(S.g_prop, row, lane, dim, g_c);
        lp_prop = lp_c;
      }
      n_valid = total;
      diverged = diverged || div_new;
    }

    // termination, evaluated after the doubling (reference while cond); a
    // subtree with an internal U-turn ends the trajectory as well
    float q_l[K], p_l[K], q_r[K], p_r[K], dq[K];
    load_row(S.q_l, row, lane, dim, q_l), load_row(S.p_l, row, lane, dim, p_l);
    load_row(S.q_r, row, lane, dim, q_r), load_row(S.p_r, row, lane, dim, p_r);
#pragma unroll
    for (int r = 0; r < K; ++r) dq[r] = q_r[r] - q_l[r];
    const bool u_turn = (dot(dq, p_l) < 0.f) || (dot(dq, p_r) < 0.f);
    if (depth + 1 >= a.max_tree_depth || u_turn || diverged || (MULTI && turn_sub)) {
      // the transition completes: adopt the proposal, log its statistics
      float mean_alpha = sum_alpha / static_cast<float>(max(n_steps, 1));
      if (!isfinite(mean_alpha)) mean_alpha = NAN_ACCEPT_FALLBACK;
      copy_row<K>(S.q, S.q_prop, row, lane, dim);
      copy_row<K>(S.grad, S.g_prop, row, lane, dim);
      lp = lp_prop;
      ++transitions;
      divergences += diverged ? 1 : 0;
      alpha_acc += mean_alpha;
      depth_acc += depth + 1;
      needs_start = true;
      // the k-th completion of the window replaces the reservoir w.p. 1/k
      ++k_res;
      const float res_u =
          philox ? bits_to_uniform(philox4x32_10(make_uint4(chain, a.call, uit, RES_DRAW), k0, k1).x)
                 : a.d.res[slot];
      if (res_u * static_cast<float>(k_res) < 1.f) {
        copy_row<K>(S.q_res, S.q_prop, row, lane, dim);
        lp_res = lp_prop;
      }
    } else {
      // the trajectory continues: next doubling from the chosen end
      ++depth;
      steps_left = 1 << depth;
      direction = f.dir2 ? 1.f : -1.f;
      if (f.dir2) {
        copy(q_c, q_r), copy(p_c, p_r);
        load_row(S.g_r, row, lane, dim, g_c);
      } else {
        copy(q_c, q_l), copy(p_c, p_l);
        load_row(S.g_l, row, lane, dim, g_c);
      }
      if constexpr (MULTI) {  // a fresh subtree: an empty reservoir
        lw_sub = -INFINITY;
        div_sub = false;
        turn_sub = false;
      }
    }
  }

  if (!real) return;
  store_row(S.q_c, row, lane, dim, q_c);
  store_row(S.p_c, row, lane, dim, p_c);
  store_row(S.g_c, row, lane, dim, g_c);
  if (lane == 0) {
    S.lp[chain] = lp, S.lp_prop[chain] = lp_prop, S.h0[chain] = h0, S.log_u[chain] = log_u;
    S.sum_alpha[chain] = sum_alpha, S.direction[chain] = direction;
    S.alpha_acc[chain] = alpha_acc, S.lp_res[chain] = lp_res;
    S.n_valid[chain] = n_valid, S.n_steps[chain] = n_steps, S.depth[chain] = depth;
    S.steps_left[chain] = steps_left, S.transitions[chain] = transitions;
    S.divergences[chain] = divergences, S.depth_acc[chain] = depth_acc;
    S.n_exec[chain] = n_exec, S.k_res[chain] = k_res;
    S.diverged[chain] = diverged, S.needs_start[chain] = needs_start;
    if constexpr (MULTI) {
      S.lp_sub[chain] = lp_sub, S.lw_tree[chain] = lw_tree, S.lw_sub[chain] = lw_sub;
      S.div_sub[chain] = div_sub, S.turn_sub[chain] = turn_sub;
    }
  }
}

template <int FAMILY, int K, bool MULTI, bool DENSE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (WARP_WINDOW<FAMILY>) {
    constexpr int WARPS = WARPS_PER_BLOCK<DENSE>;
    const unsigned blocks = static_cast<unsigned>((a.n_chains + WARPS - 1) / WARPS);
    const size_t smem = metric_smem_bytes<K, DENSE>(a.dim, WARPS);
    const auto kernel = warp_window_kernel<FAMILY, K, MULTI, DENSE>();
    if constexpr (DENSE) {
      // above 48 kB only after opting in (D > 74); up to 139 kB at D = 128
      const cudaError_t err = cudaFuncSetAttribute(kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, WARPS * 32, smem, stream>>>(a);
  } else {
    // ceil(n_chains / C) blocks, the geometry's shared memory (above 48 kB
    // after opting in)
    constexpr int C = WINDOW_TILE_CHAINS;
    const TileGeometry geo = window_tile_geometry(a.dim, DENSE);
    if (geo.bytes == 0) return cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(nuts_tiled_window_kernel<K, MULTI, DENSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((a.n_chains + C - 1) / C);
    nuts_tiled_window_kernel<K, MULTI, DENSE><<<blocks, 32 * C, geo.bytes, stream>>>(a, geo);
  }
  return cudaGetLastError();
}

template <int FAMILY, bool MULTI, bool DENSE>
cudaError_t dispatch_k(const Args& a, cudaStream_t stream) {
  switch ((a.dim + 31) / 32) {
    case 1: return launch<FAMILY, 1, MULTI, DENSE>(a, stream);
    case 2: return launch<FAMILY, 2, MULTI, DENSE>(a, stream);
    case 3: return launch<FAMILY, 3, MULTI, DENSE>(a, stream);
    case 4: return launch<FAMILY, 4, MULTI, DENSE>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int FAMILY>
cudaError_t dispatch_variant(const Args& a, bool multi, bool dense, cudaStream_t stream) {
  if (multi) {
    return dense ? dispatch_k<FAMILY, true, true>(a, stream)
                 : dispatch_k<FAMILY, true, false>(a, stream);
  }
  return dense ? dispatch_k<FAMILY, false, true>(a, stream)
               : dispatch_k<FAMILY, false, false>(a, stream);
}

// Families whose dispatch_variant the launcher takes from the other
// translation units (fused_nuts_families_1.cu, _2.cu, _3.cu), each
// instantiating its share there so the four sources compile in parallel.
#define MCMC_NUTS_FAMILIES_1(X) X(HIERARCHICAL_LOGISTIC) X(NEALS_FUNNEL_NONCENTERED) \
  X(ILL_CONDITIONED_GAUSSIAN)
#define MCMC_NUTS_FAMILIES_2(X) X(STUDENT_T) X(LOG_GAMMA) X(LOG_GAMMA_UNCONSTRAINED)
#define MCMC_NUTS_FAMILIES_3(X) X(ROSENBROCK) X(MULTIMODAL_FUNNEL_2D) X(CONCENTRIC_L1) \
  X(NESTED_L1)
#define MCMC_NUTS_DISPATCH(F) \
  cudaError_t dispatch_variant<F>(const Args&, bool, bool, cudaStream_t);

}  // namespace nuts
}  // namespace mcmc

