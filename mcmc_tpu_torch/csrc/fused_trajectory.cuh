// Kernels 1 and 2 (grahmc_step_kernel, grahmc_multistep_kernel) and their
// launchers, for every family, K and metric. fused_trajectory.cu says what
// they replace and how they are built; it holds the plain C entry points and
// instantiates the families outside MCMC_TRAJECTORY_FAMILIES_{1,2,3}, whose
// instances fused_trajectory_families_{1,2,3}.cu compile in parallel.
// Kernel 1's dense variant 1a and its data-carrying variant 1d launch the
// block-tiled grahmc_tiled_step_kernel (tiled_step.cuh); its diagonal
// instances without data run in lane groups (G < 32, step_lanes) on the
// families of GROUPED_FAMILY and warp per chain (G = 32) on the others.
// Kernel 2's data-carrying variant 2b launches the block-tiled
// grahmc_tiled_multistep_kernel (tiled_step.cuh); its other instances, the
// dense 2a among them, are warp-per-chain.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "tiled_step.cuh"
#include "trajectory.cuh"

namespace mcmc {

// Kernel 1's chain (the warp-per-chain body at G = 32) or, in lane groups,
// the chain of this lane's group; chains past n_chains in a partly used warp
// run a clamped chain and store nothing, so every shuffle sees the full warp.
template <int FAMILY, int K, bool DENSE, int G>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) grahmc_step_kernel(const StepArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  if constexpr (G == 32) {
    const int chain = blockIdx.x * WARPS_PER_BLOCK + warp;
    extern __shared__ __align__(16) float smem[];
    const Metric<K, DENSE> metric =
        make_metric<K, DENSE>(a.inv_mass, a.l_inv, a.dim, smem, warp, lane);
    if (chain >= a.n_chains) return;  // uniform across the warp
    step_chain<K>(a, Target<FAMILY, K>(a.dim, a.params, a.data), metric, sc, chain, lane);
  } else {
    static_assert(!DENSE && GROUPED_FAMILY<FAMILY>, "lane groups: diagonal, no data");
    constexpr int N = K * 32 / G;  // registers a lane
    const int first = (blockIdx.x * WARPS_PER_BLOCK + warp) * (32 / G);
    if (first >= a.n_chains) return;  // uniform across the warp
    const int chain = first + lane / G, gl = lane & (G - 1);
    const bool active = chain < a.n_chains;
    step_chain<N, G>(a, Target<FAMILY, N, G>(a.dim, a.params, a.data),
                     DiagMetric<N, G>(a.inv_mass, gl, a.dim), sc,
                     active ? chain : a.n_chains - 1, gl, active);
  }
}

template <int FAMILY, int K, bool DENSE>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    grahmc_multistep_kernel(const MultiArgs a) {
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * WARPS_PER_BLOCK + warp;
  const int lane = threadIdx.x & 31;
  extern __shared__ __align__(16) float smem[];
  const Metric<K, DENSE> metric =
      make_metric<K, DENSE>(a.inv_mass, a.l_inv, a.dim, smem, warp, lane);
  if (chain >= a.n_chains) return;

  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  const Target<FAMILY, K> target(a.dim, a.params, a.data);
  const size_t row = static_cast<size_t>(chain) * a.dim;
  float q[K], g[K];
  load_row(a.q, row, lane, a.dim, q);
  load_row(a.grad, row, lane, a.dim, g);
  float lp = a.lp[chain];

  for (int t = 0; t < a.transitions; ++t) {
    const size_t slot = static_cast<size_t>(t) * a.n_chains + chain;  // (T, C) index
    const size_t trow = slot * a.dim;                                  // (T, C, D) row
    float p0[K], u;
    randoms(a.p0, a.u, trow, slot, metric, lane, a.dim, chain, a.call,
            static_cast<uint32_t>(t), a.key, p0, u);
    float q1[K], lp1, dh;
    const bool accept = transition<32, true>(target, metric, sc, a.num_steps, a.schedule,
                                             lane, p0, u, q, g, lp, q1, lp1, dh);
    store_row(a.hist_q, trow, lane, a.dim, q);
    if (lane == 0) {
      a.hist_lp[slot] = lp;
      a.acc_out[slot] = accept;
      a.dh_out[slot] = dh;
    }
  }
  store_row(a.q_out, row, lane, a.dim, q);
  store_row(a.grad_out, row, lane, a.dim, g);
  if (lane == 0) a.lp_out[chain] = lp;
}

// Kernel 1: 1a (DENSE) and 1d (the data-carrying family) block-tiled, the
// rest in the lanes step_lanes picks.
template <int FAMILY, int K, bool DENSE>
struct StepLaunch {
  static cudaError_t run(const StepArgs& a, cudaStream_t stream) {
    if constexpr (DENSE || FAMILY == HIERARCHICAL_LOGISTIC) {
      return launch_tiled<FAMILY, DENSE>(grahmc_tiled_step_kernel<FAMILY, K, DENSE>, a, stream);
    } else {
      constexpr int LEAST = least_lanes<FAMILY, K>();
      return launch_lanes<LEAST>(step_lanes(LEAST, a.n_chains), [&](auto lanes) {
        constexpr int G = decltype(lanes)::value;
        return launch<K, DENSE, G>(grahmc_step_kernel<FAMILY, K, DENSE, G>, a, stream);
      });
    }
  }
};

// Kernel 2: 2b (the data-carrying family, either metric) block-tiled, the
// rest (2a among them) warp per chain.
template <int FAMILY, int K, bool DENSE>
struct MultiLaunch {
  static cudaError_t run(const MultiArgs& a, cudaStream_t stream) {
    if constexpr (FAMILY == HIERARCHICAL_LOGISTIC) {
      return launch_tiled<FAMILY, DENSE>(grahmc_tiled_multistep_kernel<K, DENSE>, a, stream);
    } else {
      return launch<K, DENSE>(grahmc_multistep_kernel<FAMILY, K, DENSE>, a, stream);
    }
  }
};

// Families whose kernel 1 and 2 instances the entry points take from the
// other translation units (fused_trajectory_families_{1,2,3}.cu).
#define MCMC_TRAJECTORY_FAMILIES_1(X) X(HIERARCHICAL_LOGISTIC) X(NEALS_FUNNEL_NONCENTERED) \
  X(ILL_CONDITIONED_GAUSSIAN)
#define MCMC_TRAJECTORY_FAMILIES_2(X) X(STUDENT_T) X(LOG_GAMMA) X(LOG_GAMMA_UNCONSTRAINED) \
  X(ROSENBROCK)
#define MCMC_TRAJECTORY_FAMILIES_3(X) X(MULTIMODAL_FUNNEL_2D) X(CONCENTRIC_L1) X(NESTED_L1)
// PREFIX is `template` (instantiate) or `extern template` (take from
// another translation unit).
#define MCMC_TRAJECTORY_DISPATCH(PREFIX, F)                                                \
  PREFIX cudaError_t dispatch_metric<StepLaunch, F, StepArgs>(bool, const StepArgs&,       \
                                                              cudaStream_t);               \
  PREFIX cudaError_t dispatch_metric<MultiLaunch, F, MultiArgs>(bool, const MultiArgs&,    \
                                                                cudaStream_t);

}  // namespace mcmc
