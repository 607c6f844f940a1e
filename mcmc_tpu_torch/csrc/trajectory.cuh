// The GRAHMC/HMC transition shared by kernel 1 and its variants: kernels 1
// and 2 (fused_trajectory.cu), the scaled variant 1b
// (fused_trajectory_scaled.cu) and the bridged variant 1c
// (fused_trajectory_bridged.cu). Replaces the body of
// mcmc_tpu/ops/fused_trajectory.py:_make_kernel (with _integrate,
// _metric_ops, _gaussian and _bits_to_uniform). Two layouts, the template
// G: one warp per chain (G = 32), lane j holding coordinates j, j+32,
// j+64, j+96 (K = ceil(D / 32) <= 4 registers); or, in kernels 1, 1b, 1c
// and 2 on the GROUPED_FAMILY targets, lane groups of G = 4, 8 or 16 lanes,
// 32 / G chains a warp, lane j of a group holding j, j+G, ... (K 32 / G
// registers): the warp-per-chain lanes j + G m folded into one lane. Every
// sum keeps the warp-per-chain order (targets.cuh:chain_sum), each Philox
// block is drawn once a chain (philox.cuh:philox_normal_shared) and the
// friction factors once a group per G substeps (transition's
// SHARED_FRICTION), so a lane group's outputs are the warp-per-chain
// kernel's bit for bit; step_lanes picks G from D and the chain count.
//
// `transition` takes the potential as a functor, (q, g, lane) -> lp with
// the gradient written to g: a target of targets.cuh for kernels 1 and 2,
// the target wrapped in Scaled or Bridged for the variants, whose state
// machine is kernel 1's. `step_chain` is kernel 1's whole body for one
// chain: load, momentum draw, transition, store. The launch helpers pick the
// instantiation for the family, K, metric and lanes at run time.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>
#include <cuda_runtime.h>

#include "chain_rows.cuh"
#include "metric.cuh"
#include "philox.cuh"
#include "targets.cuh"

namespace mcmc {

constexpr int WARPS_PER_BLOCK = 8;
static_assert(WARPS_PER_BLOCK <= TARGET_MAX_WARPS, "targets.cuh stages one row per warp");
constexpr int MAX_K = 4;  // registers per lane: dim <= 128
constexpr float ENERGY_OVERFLOW = 1e10f;
constexpr float PI_F = 3.141592653589793f;

// Must match SCHEDULE_IDS in mcmc_tpu_torch/ops/fused_trajectory.py.
enum Schedule { NO_FRICTION = 0, CONSTANT = 1, TANH = 2, SIGMOID = 3, LINEAR = 4, SINE = 5 };

struct Scalars {
  float eps, gamma, steep;
};

// gamma(t) of mcmc_tpu_torch/samplers/grahmc.py, same operation order.
__device__ __forceinline__ float friction(int schedule, float t, float T, float g, float s) {
  switch (schedule) {
    case CONSTANT:
      return t < T / 2.f ? -g : (t > T / 2.f ? g : 0.f);
    case TANH:
      return g * tanhf(s * (2.f * t / T - 1.f));
    case SIGMOID: {
      const float z = s * (t / T - 0.5f);
      return g * (2.f / (1.f + expf(-z)) - 1.f);
    }
    case LINEAR:
      return g * (2.f * t / T - 1.f);
    case SINE:
      return g * sinf(PI_F * (t / T - 0.5f));
    default:
      return 0.f;
  }
}

// The momentum's friction factor at substep i: exp(-gamma(t) eps / 2) on the
// midpoint grid t = (i + 1/2) eps.
__device__ __forceinline__ float friction_scale(int schedule, int i, const Scalars& sc,
                                                float total, float half) {
  const float gt =
      friction(schedule, (static_cast<float>(i) + 0.5f) * sc.eps, total, sc.gamma, sc.steep);
  return expf(-gt * half);
}

// Substep i of `transition`: the friction scaling, the two half kicks and
// the drift, the gradient at the new q1 and, WITH_LP, its log-density in
// lp1. `scales` carries the lane groups' shared friction factors.
template <bool WITH_LP, int G, bool SHARED_FRICTION, bool ROUNDED, typename P, int K, typename M>
__device__ __forceinline__ void substep(const P& potential, const M& metric, const Scalars& sc,
                                        int schedule, int i, int lane, float total, float half,
                                        float& scales, float (&p)[K], float (&q1)[K],
                                        float (&g1)[K], float& lp1) {
  float scale = 1.f, v[K];
  if (schedule != NO_FRICTION) {
    if constexpr (SHARED_FRICTION) {
      if ((i & (G - 1)) == 0) scales = friction_scale(schedule, i + lane, sc, total, half);
      scale = __shfl_sync(FULL_MASK, scales, i & (G - 1), G);
    } else {
      scale = friction_scale(schedule, i, sc, total, half);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) p[r] *= scale;
  }
#pragma unroll
  for (int r = 0; r < K; ++r) p[r] = add_scaled<ROUNDED>(p[r], half, g1[r]);
  metric.velocity(p, v);
#pragma unroll
  for (int r = 0; r < K; ++r) q1[r] = add_scaled<ROUNDED>(q1[r], sc.eps, v[r]);
  if constexpr (WITH_LP) {
    lp1 = potential(q1, g1, lane);
  } else {
    potential(q1, g1, lane, false);
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    p[r] = add_scaled<ROUNDED>(p[r], half, g1[r]);
    if (schedule != NO_FRICTION) p[r] *= scale;
  }
}

// One MH transition of the chain this warp (group of G lanes) holds, from
// momentum p0. On entry (q, g, lp) is the current state; on exit the
// selected state. (q1, lp1) is the proposal and dh = H1 - H0. Returns the
// accept decision (uniform across the group). `lane` is the lane's place in
// its group. SHARED_FRICTION (lane groups, and kernel 2): the friction
// factors depend on the chain's scalars and i alone, so the group computes
// G substeps' factors at once, lane j substep i + j, and each substep takes
// its own by a shuffle: the same function of the same inputs, so the same
// bits. (Kernel 1's and 1c's warp-per-chain instances keep a factor a
// substep on every lane: shared, it cost them 1-2% where the schedule is
// NO_FRICTION, PERF.md section 6.) LP_LAST (kernel 2 and 1c): the
// potential's log-density is asked for at the last substep alone, the only
// one the transition reads; the others compute the gradient alone
// (targets.cuh's `with_lp`, Bridged's), the last substep peeled off so that
// no substep branches on it. 1c's instances are compiled under a register
// budget that keeps the peel from spilling (fused_trajectory_bridged.cu);
// a potential whose functor takes no `with_lp` (the hierarchical one,
// TAKES_WITH_LP) keeps the unpeeled loop. Kernels 1, 1b, 1a, 1d and 2b keep
// it off: on an H100 it took 5-30% off their path shapes but made 62 of
// their instances spill anew or more at ptxas's register targets (PERF.md
// section 6), and their functors (Scaled, the hierarchical ones) take no
// `with_lp`.
template <int G = 32, bool SHARED_FRICTION = (G < 32), bool LP_LAST = false, typename P, int K,
          typename M>
__device__ __forceinline__ bool transition(const P& potential, const M& metric,
                                           const Scalars& sc, int num_steps, int schedule,
                                           int lane, const float (&p0)[K], float u,
                                           float (&q)[K], float (&g)[K], float& lp,
                                           float (&q1)[K], float& lp1, float& dh) {
  constexpr bool ROUNDED = M::DENSE || ROUNDED_LEAPFROG<family_of<P>::value>;
  float p[K], g1[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    q1[r] = q[r];
    g1[r] = g[r];
    p[r] = p0[r];
  }
  const float h0 = -lp + metric.kinetic(p);

  const float half = 0.5f * sc.eps;
  const float total = sc.eps * static_cast<float>(num_steps);
  lp1 = lp;
  float scales = 1.f;  // lane groups: substep (i & ~(G - 1)) + lane's factor
  if constexpr (LP_LAST) {
    for (int i = 0; i + 1 < num_steps; ++i) {
      substep<false, G, SHARED_FRICTION, ROUNDED>(potential, metric, sc, schedule, i, lane,
                                                  total, half, scales, p, q1, g1, lp1);
    }
    if (num_steps > 0) {
      substep<true, G, SHARED_FRICTION, ROUNDED>(potential, metric, sc, schedule,
                                                 num_steps - 1, lane, total, half, scales, p,
                                                 q1, g1, lp1);
    }
  } else {
    for (int i = 0; i < num_steps; ++i) {
      substep<true, G, SHARED_FRICTION, ROUNDED>(potential, metric, sc, schedule, i, lane,
                                                 total, half, scales, p, q1, g1, lp1);
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r) p[r] = -p[r];
  float h1 = -lp1 + metric.kinetic(p);
  if (!isfinite(h1)) h1 = ENERGY_OVERFLOW;
  dh = h1 - h0;
  const float log_alpha = h0 - h1;
  const float log_u = logf(u);
  // log u < min(0, log_alpha); a NaN log_alpha rejects, as in PyTorch
  const bool accept = (log_u < 0.f) && (log_u < log_alpha);
  if (accept) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      q[r] = q1[r];
      g[r] = g1[r];
    }
    lp = lp1;
  }
  return accept;
}

// The momentum and accept uniform of transition t: injected, or the Philox
// normals unwhitened by the metric. Lane groups (G < 32) draw each Philox
// block once (philox_normal_shared), through a row of static shared memory
// per group.
template <int K, int G = 32, typename M>
__device__ __forceinline__ void randoms(const float* p0_in, const float* u_in, size_t trow,
                                        size_t slot, const M& metric, int lane,
                                        int dim, uint32_t chain, uint32_t call, uint32_t t,
                                        const uint32_t* key, float (&p0)[K], float& u) {
  if (p0_in != nullptr) {
    load_row<K, G>(p0_in, trow, lane, dim, p0);
    u = u_in[slot];
  } else {
    if constexpr (G < 32) {
      __shared__ __align__(16) float rows[WARPS_PER_BLOCK * 32 * K];
      philox_normal_shared<K, G>(p0, rows + (threadIdx.x & ~(G - 1)) * K, lane, dim, chain,
                                 call, t, key[0], key[1]);
    } else {
      philox_normal_row(p0, lane, dim, chain, call, t, key[0], key[1]);
    }
    metric.unwhiten(p0);
    u = philox_accept_uniform(chain, call, t, key[0], key[1]);
  }
}

// Whether the functor P's call takes `with_lp` (targets.cuh): every
// target's but the hierarchical posterior's.
template <typename P, int K, typename = void>
struct takes_with_lp : std::false_type {};
template <typename P, int K>
struct takes_with_lp<P, K,
                     std::void_t<decltype(std::declval<const P&>()(
                         std::declval<const float (&)[K]>(), std::declval<float (&)[K]>(), 0,
                         false))>> : std::true_type {};
template <typename P, int K>
constexpr bool TAKES_WITH_LP = takes_with_lp<P, K>::value;

// Families whose kernels 1, 1b, 1c and 2 run in lane groups: those the main
// paths launch at chain counts that take them (the funnel's and N(0, I)'s
// 65,536 chains, the tempered mixture's 6 x 8,192, the correlated
// Gaussian's 4,096 in the dense warmup's diagonal phase, kernel 2 on the
// funnel at 4,096 x 50). Their functors sum through
// chain_sum and hold no shuffle in a branch that differs between a warp's
// chains. The others keep G = 32: the L1 shells (LANE_SHELLS), Rosenbrock
// (its neighbour exchange), the bimodal funnel, the hierarchical posterior,
// and the sweep's families, which the paths launch at 1,024-2,048 chains,
// below MIN_GROUP_WARPS in any lane group.
template <int FAMILY>
constexpr bool GROUPED_FAMILY = FAMILY == STANDARD_NORMAL || FAMILY == NEALS_FUNNEL ||
                                FAMILY == GAUSSIAN_MIXTURE || FAMILY == CORRELATED_GAUSSIAN;

// The fewest lanes a chain of kernel 1, 1b or 1c takes at K = ceil(D / 32)
// warp-per-chain registers: 32 / G chains share a warp and a lane holds
// K 32 / G registers (8 at most).
template <int FAMILY, int K>
constexpr int least_lanes() {
  if constexpr (!GROUPED_FAMILY<FAMILY>) {
    return 32;
  } else {
    return K == 1 ? 4 : (K == 2 ? 8 : 16);
  }
}

// Warps a launch in lane groups must keep (about 16 an SM): below them a
// warp's longer stream of registers waits on latency. On an H100 at 700 W,
// against the warp kernel: at 65,536 x 50 and 6 x 8,192 x 10 the fewest
// lanes won (kernel 1 -57%, 1b -80%), at 4,096 x 50 16 lanes (-35%; 8
// lanes -23%), at 2,048 x 20 and 1,024 x 10 groups of 4 lost 13% to 270%;
// kernel 2 at 4,096 x 50 -35% with 16 lanes (PERF.md section 6,
// experiments/torch_step_kernel_timing.py).
constexpr int MIN_GROUP_WARPS = 2048;

// The lanes of a chain of kernel 1, 1b or 1c: the fewest from `least` up that
// keep MIN_GROUP_WARPS warps in the launch, else 32 (warp per chain).
inline int step_lanes(int least, int n_chains) {
  for (int g = least; g < 32; g *= 2) {
    if (static_cast<long long>(n_chains) * g >= 32LL * MIN_GROUP_WARPS) return g;
  }
  return 32;
}

// Warps a block for n_chains chains of G lanes: the most of `most`, most /
// 2, ..., `least` that still give every SM of the card a block, so that a
// small launch spreads over the SMs, whose few warps each wait on their
// chains' dependent streams (kernels 2 and 3). Blocks do not interact, so
// the outputs are the same bits at any size.
inline int spread_warps(int n_chains, int G, int most, int least) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return most;  // the launch reports the runtime's error
  }
  int warps = most;
  const long long chains_per_warp = 32 / G;
  while (warps > least &&
         (n_chains + warps * chains_per_warp - 1) / (warps * chains_per_warp) < sms) {
    warps /= 2;
  }
  return warps;
}

// launch(std::integral_constant<int, G>{}) for G = `lanes`, one of LEAST,
// 2 LEAST, ..., 32.
template <int LEAST, typename Launch>
cudaError_t launch_lanes(int lanes, const Launch& launch) {
  if constexpr (LEAST < 32) {
    if (lanes == LEAST) return launch(std::integral_constant<int, LEAST>{});
    return launch_lanes<2 * LEAST>(lanes, launch);
  } else {
    return launch(std::integral_constant<int, 32>{});
  }
}

// Arguments of kernel 1 and its variants. `scalars` is (eps, gamma,
// steepness) for kernel 1, the (n_chains / rung_chains, 4) rung table for
// 1b, (eps, gamma, steepness, beta, base_log_norm) for 1c; base_mean and
// base_inv_scale are 1c's (dim,) rows; `data` the target's data set.
struct StepArgs {
  int dim, n_chains, num_steps, schedule;
  int rung_chains;
  TargetParams params;
  TargetData data;
  const float* scalars;
  const float *base_mean, *base_inv_scale;
  const uint32_t* key;
  uint32_t call;
  const float *q, *lp, *grad, *inv_mass, *l_inv, *p0, *u;
  float *q_out, *lp_out, *grad_out;
  bool* acc_out;
  float *dh_out, *prop_q, *prop_lp;
};

// Arguments of kernel 2: kernel 1's state, metric and draws, T =
// `transitions` a call (injected p0 (T, C, D) and u (T, C)), and each
// transition's accept, delta H and post-transition q and lp ((T, C), (T, C,
// D)).
struct MultiArgs {
  int dim, n_chains, num_steps, schedule, transitions;
  TargetParams params;
  TargetData data;
  const float* scalars;
  const uint32_t* key;
  uint32_t call;
  const float *q, *lp, *grad, *inv_mass, *l_inv, *p0, *u;
  float *q_out, *lp_out, *grad_out;
  bool* acc_out;
  float *dh_out, *hist_q, *hist_lp;
};

// One transition of `chain` under `potential`: kernel 1's body, for the
// group of G lanes holding the chain (`lane` its place there). The Philox
// counter's chain word is the chain's row. A group that is not `active` (past
// n_chains in a partly used warp, on a clamped chain) stores nothing.
// SHARED_FRICTION and LP_LAST as transition's.
template <int K, int G = 32, bool SHARED_FRICTION = (G < 32), bool LP_LAST = false, typename P,
          typename M>
__device__ __forceinline__ void step_chain(const StepArgs& a, const P& potential,
                                           const M& metric, const Scalars& sc, int chain,
                                           int lane, bool active = true) {
  const size_t row = static_cast<size_t>(chain) * a.dim;
  float q[K], g[K], p0[K];
  load_row<K, G>(a.q, row, lane, a.dim, q);
  load_row<K, G>(a.grad, row, lane, a.dim, g);
  float lp = a.lp[chain];
  float u;
  randoms<K, G>(a.p0, a.u, row, chain, metric, lane, a.dim, chain, a.call, 0u, a.key, p0, u);

  float q1[K], lp1, dh;
  const bool accept = transition<G, SHARED_FRICTION, LP_LAST>(
      potential, metric, sc, a.num_steps, a.schedule, lane, p0, u, q, g, lp, q1, lp1, dh);

  if (!active) return;
  store_row<K, G>(a.q_out, row, lane, a.dim, q);
  store_row<K, G>(a.grad_out, row, lane, a.dim, g);
  store_row<K, G>(a.prop_q, row, lane, a.dim, q1);
  if (lane == 0) {
    a.lp_out[chain] = lp;
    a.acc_out[chain] = accept;
    a.dh_out[chain] = dh;
    a.prop_lp[chain] = lp1;
  }
}

// Blocks of `warps` warps for n_chains chains, G lanes a chain.
inline dim3 grid_for(int n_chains, int G = 32, int warps = WARPS_PER_BLOCK) {
  const int per_block = warps * (32 / G);
  return dim3(static_cast<unsigned>((n_chains + per_block - 1) / per_block));
}

// Launch `kernel` (G lanes a chain) in blocks of `warps` warps with the
// metric's shared memory; above 48 kB (dense, D > 76) only after opting in.
template <int K, bool DENSE, int G = 32, typename Args>
cudaError_t launch(void (*kernel)(const Args), const Args& a, cudaStream_t stream,
                   int warps = WARPS_PER_BLOCK) {
  const size_t smem = metric_smem_bytes<K, DENSE>(a.dim, warps);
  if constexpr (DENSE) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid_for(a.n_chains, G, warps), warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <template <int, int, bool> class Launch, int FAMILY, bool DENSE, typename Args>
cudaError_t dispatch_k(const Args& a, cudaStream_t stream) {
  switch ((a.dim + 31) / 32) {
    case 1: return Launch<FAMILY, 1, DENSE>::run(a, stream);
    case 2: return Launch<FAMILY, 2, DENSE>::run(a, stream);
    case 3: return Launch<FAMILY, 3, DENSE>::run(a, stream);
    case 4: return Launch<FAMILY, 4, DENSE>::run(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int, bool> class Launch, int FAMILY, typename Args>
cudaError_t dispatch_metric(bool dense, const Args& a, cudaStream_t stream) {
  return dense ? dispatch_k<Launch, FAMILY, true>(a, stream)
               : dispatch_k<Launch, FAMILY, false>(a, stream);
}

// Launch<FAMILY, K, DENSE>::run for the family, K and metric of this call.
template <template <int, int, bool> class Launch, typename Args>
cudaError_t dispatch(int family, bool dense, const Args& a, cudaStream_t stream) {
  if (a.dim < 1 || a.dim > 32 * MAX_K || a.n_chains < 1 || a.num_steps < 0 ||
      !valid_data(family, a.data)) {
    return cudaErrorInvalidValue;
  }
  switch (family) {
#define MCMC_CASE(F) \
  case F: return dispatch_metric<Launch, F>(dense, a, stream);
    MCMC_FAMILIES(MCMC_CASE)
#undef MCMC_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mcmc
