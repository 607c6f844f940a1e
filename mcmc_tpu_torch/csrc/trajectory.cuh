// The GRAHMC/HMC transition shared by kernel 1 and its variants: kernels 1
// and 2 (fused_trajectory.cu), the scaled variant 1b
// (fused_trajectory_scaled.cu) and the bridged variant 1c
// (fused_trajectory_bridged.cu). Replaces the body of
// mcmc_tpu/ops/fused_trajectory.py:_make_kernel (with _integrate,
// _metric_ops, _gaussian and _bits_to_uniform), one warp per chain: lane j
// holds coordinates j, j+32, j+64, j+96 (K = ceil(D / 32) <= 4 registers).
//
// `transition` takes the potential as a functor, (q, g, lane) -> lp with
// the gradient written to g: a target of targets.cuh for kernels 1 and 2,
// the target wrapped in Scaled or Bridged for the variants, whose state
// machine is kernel 1's. `step_chain` is kernel 1's whole body for one
// chain: load, momentum draw, transition, store. The launch helpers pick the
// instantiation for the family, K and metric at run time.
#pragma once

#include <cstddef>
#include <cstdint>
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

// One MH transition of the chain this warp holds, from momentum p0. On entry
// (q, g, lp) is the current state; on exit the selected state. (q1, lp1) is
// the proposal and dh = H1 - H0. Returns the accept decision (uniform across
// the warp).
template <typename P, int K, typename M>
__device__ __forceinline__ bool transition(const P& potential, const M& metric,
                                           const Scalars& sc, int num_steps, int schedule,
                                           int lane, const float (&p0)[K], float u,
                                           float (&q)[K], float (&g)[K], float& lp,
                                           float (&q1)[K], float& lp1, float& dh) {
  constexpr bool ROUNDED = M::DENSE || ROUNDED_LEAPFROG<family_of<P>::value>;
  float p[K], g1[K], v[K];
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
  for (int i = 0; i < num_steps; ++i) {
    float scale = 1.f;
    if (schedule != NO_FRICTION) {
      // midpoint grid t = (i + 1/2) eps
      const float gt = friction(schedule, (static_cast<float>(i) + 0.5f) * sc.eps, total,
                                sc.gamma, sc.steep);
      scale = expf(-gt * half);
#pragma unroll
      for (int r = 0; r < K; ++r) p[r] *= scale;
    }
#pragma unroll
    for (int r = 0; r < K; ++r) p[r] = add_scaled<ROUNDED>(p[r], half, g1[r]);
    metric.velocity(p, v);
#pragma unroll
    for (int r = 0; r < K; ++r) q1[r] = add_scaled<ROUNDED>(q1[r], sc.eps, v[r]);
    lp1 = potential(q1, g1, lane);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      p[r] = add_scaled<ROUNDED>(p[r], half, g1[r]);
      if (schedule != NO_FRICTION) p[r] *= scale;
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
// normals unwhitened by the metric.
template <int K, typename M>
__device__ __forceinline__ void randoms(const float* p0_in, const float* u_in, size_t trow,
                                        size_t slot, const M& metric, int lane,
                                        int dim, uint32_t chain, uint32_t call, uint32_t t,
                                        const uint32_t* key, float (&p0)[K], float& u) {
  if (p0_in != nullptr) {
    load_row(p0_in, trow, lane, dim, p0);
    u = u_in[slot];
  } else {
    philox_normal_row(p0, lane, dim, chain, call, t, key[0], key[1]);
    metric.unwhiten(p0);
    u = philox_accept_uniform(chain, call, t, key[0], key[1]);
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

// One transition of `chain` under `potential`: kernel 1's body. The Philox
// counter's chain word is the chain's row.
template <int K, typename P, typename M>
__device__ __forceinline__ void step_chain(const StepArgs& a, const P& potential,
                                           const M& metric, const Scalars& sc, int chain,
                                           int lane) {
  const size_t row = static_cast<size_t>(chain) * a.dim;
  float q[K], g[K], p0[K];
  load_row(a.q, row, lane, a.dim, q);
  load_row(a.grad, row, lane, a.dim, g);
  float lp = a.lp[chain];
  float u;
  randoms(a.p0, a.u, row, chain, metric, lane, a.dim, chain, a.call, 0u, a.key, p0, u);

  float q1[K], lp1, dh;
  const bool accept = transition(potential, metric, sc, a.num_steps, a.schedule, lane, p0, u,
                                 q, g, lp, q1, lp1, dh);

  store_row(a.q_out, row, lane, a.dim, q);
  store_row(a.grad_out, row, lane, a.dim, g);
  store_row(a.prop_q, row, lane, a.dim, q1);
  if (lane == 0) {
    a.lp_out[chain] = lp;
    a.acc_out[chain] = accept;
    a.dh_out[chain] = dh;
    a.prop_lp[chain] = lp1;
  }
}

inline dim3 grid_for(int n_chains) {
  return dim3(static_cast<unsigned>((n_chains + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
}

// Launch `kernel` with the metric's shared memory; above 48 kB (dense,
// D > 76) only after opting in.
template <int K, bool DENSE, typename Args>
cudaError_t launch(void (*kernel)(const Args), const Args& a, cudaStream_t stream) {
  const size_t smem = metric_smem_bytes<K, DENSE>(a.dim, WARPS_PER_BLOCK);
  if constexpr (DENSE) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid_for(a.n_chains), WARPS_PER_BLOCK * 32, smem, stream>>>(a);
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
