// Fused persistent-NUTS window for NVIDIA Hopper (sm_90a), endpoint scheme,
// diagonal metric.
//
// Replaces mcmc_tpu/ops/fused_nuts.py:_make_kernel (built by _build_call for
// make_fused_nuts_window): one snapshot window -- n_iters machine iterations
// of up to W leapfrog slots each -- of the persistent-NUTS state machine.
// Per iteration and chain: a fresh transition's start (momentum, h0, slice
// variable, direction); the slots, slot 0 always live and a later one only
// while the subtree is open; at a subtree's end the endpoint store, the
// endpoint-validity proposal swap, divergence and U-turn tests; then either
// the transition's completion (1/k snapshot reservoir) or the next doubling.
// The plain PyTorch version is mcmc_tpu_torch/ops/fused_nuts.py:
// nuts_window_plain (samplers/nuts_persistent.py:_machine_iteration).
//
// What bounds it on an H100: each chain's state (14 position-like rows and
// 19 scalars, ~5.8 kB at D = 50) crosses device memory once per window, 0.4
// GB at 65,536 chains -- ~0.12 ms at 3.35 TB/s -- against 64 leapfrogs per
// chain in a bench window. Each leapfrog is the target (one expf and a warp
// reduction on the funnel), the kinetic energy (a second reduction) and the
// accept expf; a subtree's end adds two reductions for the U-turn test.
// Instruction issue and the latency of those dependent shuffles, not device
// memory, set the time.
//
// Design: one warp per chain, as kernels 1 and 2. Lane j holds coordinates
// j, j+32, ... of all 14 rows (K = ceil(D / 32) registers each), which stay
// in registers for the whole window; the per-chain scalars sit in every
// lane's registers, identical across the warp. Every per-chain mask of the
// TPU kernel (jnp.where on needs_start, a live slot, a boundary, term or
// cont) is a warp-uniform branch here, so a chain skips what it does not
// need: masked slots are not computed at all, and a chain draws its
// momentum and flags only when it starts or reaches a boundary. Counters
// are int32, not the TPU kernel's f32 rows. The public (C, D) row-major
// layout is read and written as is.
//
// Randomness: injected (draws non-null: p0 (n_iters, C, D), dir, dir2 bool,
// swap, slice, res float (n_iters, C)) or Philox4x32-10 with counter (chain,
// call, iteration, draw): the momentum from draws 0..31 as in philox.cuh,
// (dir, dir2, swap, slice) from the four words of FLAGS_DRAW, the reservoir
// uniform from word x0 of RES_DRAW.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "chain_rows.cuh"
#include "philox.cuh"
#include "targets.cuh"

namespace mcmc {
namespace nuts {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int MAX_K = 4;  // dim <= 128
constexpr uint32_t FLAGS_DRAW = 32;
constexpr uint32_t RES_DRAW = 33;
constexpr float NAN_ACCEPT_FALLBACK = 0.65f;

// Field order must match KERNEL_FIELDS in mcmc_tpu_torch/ops/fused_nuts.py.
struct State {
  float *q, *grad, *q_l, *p_l, *g_l, *q_r, *p_r, *g_r, *q_prop, *g_prop, *q_c, *p_c, *g_c,
      *q_res;                                                                // (C, D)
  float *lp, *lp_prop, *h0, *log_u, *sum_alpha, *direction, *alpha_acc, *lp_res;  // (C,)
  int *n_valid, *n_steps, *depth, *steps_left, *transitions, *divergences, *depth_acc,
      *n_exec, *k_res;                                                       // (C,)
  bool *diverged, *needs_start;                                              // (C,)
};
constexpr size_t N_STATE_FIELDS = 33;
static_assert(sizeof(State) == N_STATE_FIELDS * sizeof(void*), "State is a pointer array");

struct Draws {
  const float* p0;
  const bool *dir, *dir2;
  const float *swap, *slice, *res;
};
static_assert(sizeof(Draws) == 6 * sizeof(void*), "Draws is a pointer array");

struct Args {
  int dim, n_chains, n_iters, slots, max_tree_depth;
  const float* scalars;  // (step size, delta_max), device
  const float* inv_mass;
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

// 0.5 p . M^{-1} p, the plain version's kinetic_energy term for term.
template <int K>
__device__ __forceinline__ float kinetic(const float (&p)[K], const float (&invm)[K]) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) s += p[r] * (p[r] * invm[r]);
  return 0.5f * warp_sum(s);
}

template <int FAMILY, int K>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) nuts_window_kernel(const Args a) {
  const int chain = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= a.n_chains) return;  // uniform across the warp

  const int dim = a.dim;
  const size_t row = static_cast<size_t>(chain) * dim;
  const Target<FAMILY, K> target(dim);
  const float step = a.scalars[0];
  const float delta_max = a.scalars[1];
  const bool philox = a.d.p0 == nullptr;
  const uint32_t k0 = philox ? a.key[0] : 0u, k1 = philox ? a.key[1] : 0u;
  float invm[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    invm[r] = d < dim ? a.inv_mass[d] : 1.f;
  }

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

  for (int it = 0; it < a.n_iters; ++it) {
    const size_t slot = static_cast<size_t>(it) * a.n_chains + chain;  // (n_iters, C) index
    const uint32_t uit = static_cast<uint32_t>(it);
    Flags f{};
    bool have_flags = false;

    // --- 1. fresh-transition start ---------------------------------------
    if (needs_start) {
      float p0[K];
      if (philox) {
        philox_momentum(p0, invm, lane, dim, chain, a.call, uit, k0, k1);
      } else {
        load_row(a.d.p0, slot * dim, lane, dim, p0);
#pragma unroll
        for (int r = 0; r < K; ++r) p0[r] = p0[r] / sqrtf(invm[r]);
      }
      f = load_flags(a, slot, chain, uit, k0, k1);
      have_flags = true;
      h0 = -lp + kinetic(p0, invm);
      log_u = logf(f.slice) - h0;
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
    }

    // --- 2. leapfrog slots: slot 0 always, later ones while the subtree
    // is open (a closed subtree's remaining slots are skipped) -------------
    const float eps = direction * step;
    const float half = 0.5f * eps;
    float lp_c = lp, h_c = h0;
    for (int k = 0; k < a.slots; ++k) {
      if (k > 0 && steps_left <= 0) break;
      float p[K], qn[K], gn[K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        p[r] = p_c[r] + half * g_c[r];
        qn[r] = q_c[r] + eps * (p[r] * invm[r]);
      }
      lp_c = target(qn, gn, lane);
#pragma unroll
      for (int r = 0; r < K; ++r) p[r] = p[r] + half * gn[r];
      h_c = -lp_c + kinetic(p, invm);
      const float dh = h0 - h_c;
      sum_alpha += expf(dh > 0.f ? 0.f : dh);  // min(0, dh), NaN kept
      copy(q_c, qn), copy(p_c, p), copy(g_c, gn);
      ++n_steps;
      ++n_exec;
      --steps_left;
    }

    // --- 3. subtree-boundary bookkeeping ----------------------------------
    if (steps_left > 0) continue;
    if (direction > 0.f) {
      copy(q_r, q_c), copy(p_r, p_c), copy(g_r, g_c);
    } else {
      copy(q_l, q_c), copy(p_l, p_c), copy(g_l, g_c);
    }
    // endpoint-validity proposal swap (reference NUTS.py:319-336)
    const bool div_new = (h_c - h0) > delta_max;
    const bool valid = (log_u <= -h_c) && !div_new;
    const int n_new = valid ? (1 << depth) : 0;
    const int total = n_valid + n_new;
    const float swap_prob =
        (valid && total > 0) ? static_cast<float>(n_new) / static_cast<float>(max(total, 1))
                             : 0.f;
    if (!have_flags) f = load_flags(a, slot, chain, uit, k0, k1);
    if (f.swap < swap_prob) {
      copy(q_prop, q_c), copy(g_prop, g_c);
      lp_prop = lp_c;
    }
    n_valid = total;
    diverged = diverged || div_new;

    // termination, evaluated after the doubling (reference while cond)
    float dq[K];
#pragma unroll
    for (int r = 0; r < K; ++r) dq[r] = q_r[r] - q_l[r];
    const bool u_turn = (dot(dq, p_l) < 0.f) || (dot(dq, p_r) < 0.f);
    if (depth + 1 >= a.max_tree_depth || u_turn || diverged) {
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
  if (lane == 0) {
    S.lp[chain] = lp, S.lp_prop[chain] = lp_prop, S.h0[chain] = h0, S.log_u[chain] = log_u;
    S.sum_alpha[chain] = sum_alpha, S.direction[chain] = direction;
    S.alpha_acc[chain] = alpha_acc, S.lp_res[chain] = lp_res;
    S.n_valid[chain] = n_valid, S.n_steps[chain] = n_steps, S.depth[chain] = depth;
    S.steps_left[chain] = steps_left, S.transitions[chain] = transitions;
    S.divergences[chain] = divergences, S.depth_acc[chain] = depth_acc;
    S.n_exec[chain] = n_exec, S.k_res[chain] = k_res;
    S.diverged[chain] = diverged, S.needs_start[chain] = needs_start;
  }
}

template <int FAMILY, int K>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((a.n_chains + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  nuts_window_kernel<FAMILY, K><<<blocks, WARPS_PER_BLOCK * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int FAMILY>
cudaError_t dispatch_k(const Args& a, cudaStream_t stream) {
  switch ((a.dim + 31) / 32) {
    case 1: return launch<FAMILY, 1>(a, stream);
    case 2: return launch<FAMILY, 2>(a, stream);
    case 3: return launch<FAMILY, 3>(a, stream);
    case 4: return launch<FAMILY, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace nuts
}  // namespace mcmc

// Plain C entry point, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// `state` is a host array of the 33 device pointers of struct State, in its
// order; `draws` a host array of the 6 injected draw pointers, or null for
// the in-kernel Philox draws (then key must be non-null). The kernel updates
// the state in place. Returns the launch's cudaError_t.
extern "C" int nuts_window_launch(int family, int dim, int n_chains, int n_iters, int slots,
                                  int max_tree_depth, const float* scalars,
                                  const float* inv_mass, const uint32_t* key, unsigned int call,
                                  void* const* state, void* const* draws, void* stream) {
  using namespace mcmc;
  if (state == nullptr || (draws == nullptr && key == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim < 1 || dim > 32 * nuts::MAX_K || n_chains < 1 || n_iters < 1 || slots < 1 ||
      max_tree_depth < 1 || max_tree_depth > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nuts::Args a{};
  a.dim = dim, a.n_chains = n_chains, a.n_iters = n_iters, a.slots = slots;
  a.max_tree_depth = max_tree_depth, a.scalars = scalars, a.inv_mass = inv_mass;
  a.key = key, a.call = call;
  std::memcpy(&a.s, state, sizeof(nuts::State));
  if (draws != nullptr) std::memcpy(&a.d, draws, sizeof(nuts::Draws));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case STANDARD_NORMAL: return static_cast<int>(nuts::dispatch_k<STANDARD_NORMAL>(a, s));
    case NEALS_FUNNEL: return static_cast<int>(nuts::dispatch_k<NEALS_FUNNEL>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
