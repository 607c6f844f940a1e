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
// grahmc_tiled_multistep_kernel (tiled_step.cuh); its diagonal instances on
// GROUPED_FAMILY take kernel 1's lane groups, the others (the dense 2a
// among them) a warp per chain, in blocks sized to the launch
// (spread_warps), and every substep but a trajectory's last computes the
// gradient alone (trajectory.cuh:transition's LP_LAST).
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

// T transitions of `chain` under `target`, for the group of G lanes holding
// it (`lane` its place there): kernel 2's body. The state stays in
// registers for the T transitions; each transition's accept, delta H and
// post-transition q and lp go to the history. A group that is not `active`
// (past n_chains in a partly used warp, on a clamped chain) stores nothing.
template <int K, int G, typename P, typename M>
__device__ __forceinline__ void multistep_chain(const MultiArgs& a, const P& target,
                                                const M& metric, const Scalars& sc, int chain,
                                                int lane, bool active = true) {
  const size_t row = static_cast<size_t>(chain) * a.dim;
  float q[K], g[K];
  load_row<K, G>(a.q, row, lane, a.dim, q);
  load_row<K, G>(a.grad, row, lane, a.dim, g);
  float lp = a.lp[chain];

  for (int t = 0; t < a.transitions; ++t) {
    const size_t slot = static_cast<size_t>(t) * a.n_chains + chain;  // (T, C) index
    const size_t trow = slot * a.dim;                                  // (T, C, D) row
    float p0[K], u;
    randoms<K, G>(a.p0, a.u, trow, slot, metric, lane, a.dim, chain, a.call,
                  static_cast<uint32_t>(t), a.key, p0, u);
    float q1[K], lp1, dh;
    const bool accept = transition<G, true, true>(target, metric, sc, a.num_steps, a.schedule,
                                                  lane, p0, u, q, g, lp, q1, lp1, dh);
    if (active) {
      store_row<K, G>(a.hist_q, trow, lane, a.dim, q);
      if (lane == 0) {
        a.hist_lp[slot] = lp;
        a.acc_out[slot] = accept;
        a.dh_out[slot] = dh;
      }
    }
  }
  if (!active) return;
  store_row<K, G>(a.q_out, row, lane, a.dim, q);
  store_row<K, G>(a.grad_out, row, lane, a.dim, g);
  if (lane == 0) a.lp_out[chain] = lp;
}

// Blocks an SM kernel 2 is compiled for where a lane holds 2 or more
// registers (K * 32 / G): 2, so 128 registers at most. Without it ptxas
// aimed at 64 registers and 28 such instances spilled 4-16 bytes. The
// instances of one register a lane (K = 1, warp per chain: the sweep, the
// 2-D shells, 2a on Rosenbrock) spill at neither and ran 0.1-1.0% faster
// without it, the bimodal funnel 0.4% slower: 5.5 ms less of [8]'s loss
// (H100 80GB HBM3 at 700 W, PERF.md section 6).
constexpr int MULTI_MIN_BLOCKS = 2;

// Kernel 2: a warp per chain (G = 32), or on the GROUPED_FAMILY targets'
// diagonal instances lane groups of G lanes as kernel 1's; blockDim.x / 32
// warps a block (spread_warps).
template <int FAMILY, int K, bool DENSE, int G>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, (K * 32 / G > 1 ? MULTI_MIN_BLOCKS : 1))
    grahmc_multistep_kernel(const MultiArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  if constexpr (G == 32) {
    const int chain = blockIdx.x * warps + warp;
    extern __shared__ __align__(16) float smem[];
    const Metric<K, DENSE> metric =
        make_metric<K, DENSE>(a.inv_mass, a.l_inv, a.dim, smem, warp, lane);
    if (chain >= a.n_chains) return;  // uniform across the warp
    multistep_chain<K, 32>(a, Target<FAMILY, K>(a.dim, a.params, a.data), metric, sc, chain,
                           lane);
  } else {
    static_assert(!DENSE && GROUPED_FAMILY<FAMILY>, "lane groups: diagonal, no data");
    constexpr int N = K * 32 / G;  // registers a lane
    const int first = (blockIdx.x * warps + warp) * (32 / G);
    if (first >= a.n_chains) return;  // uniform across the warp
    const int chain = first + lane / G, gl = lane & (G - 1);
    const bool active = chain < a.n_chains;
    multistep_chain<N, G>(a, Target<FAMILY, N, G>(a.dim, a.params, a.data),
                          DiagMetric<N, G>(a.inv_mass, gl, a.dim), sc,
                          active ? chain : a.n_chains - 1, gl, active);
  }
}

// Kernel 2's smallest block (spread_warps): at 1,024 chains, 128 blocks of
// 8 warps left 4 SMs of 132 without one; blocks of 4 took 4% off the nested
// shells (H100 80GB HBM3 at 700 W, PERF.md section 6).
constexpr int MIN_MULTI_WARPS = 2;

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
// diagonal instances on the GROUPED_FAMILY targets in the lanes step_lanes
// picks, the rest (2a among them) warp per chain.
template <int FAMILY, int K, bool DENSE>
struct MultiLaunch {
  static cudaError_t run(const MultiArgs& a, cudaStream_t stream) {
    if constexpr (FAMILY == HIERARCHICAL_LOGISTIC) {
      return launch_tiled<FAMILY, DENSE>(grahmc_tiled_multistep_kernel<K, DENSE>, a, stream);
    } else if constexpr (!DENSE) {
      constexpr int LEAST = least_lanes<FAMILY, K>();
      return launch_lanes<LEAST>(step_lanes(LEAST, a.n_chains), [&](auto lanes) {
        constexpr int G = decltype(lanes)::value;
        return launch<K, DENSE, G>(grahmc_multistep_kernel<FAMILY, K, DENSE, G>, a, stream,
                                   spread_warps(a.n_chains, G, WARPS_PER_BLOCK, MIN_MULTI_WARPS));
      });
    } else {
      return launch<K, DENSE>(grahmc_multistep_kernel<FAMILY, K, DENSE, 32>, a, stream,
                              spread_warps(a.n_chains, 32, WARPS_PER_BLOCK, MIN_MULTI_WARPS));
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
