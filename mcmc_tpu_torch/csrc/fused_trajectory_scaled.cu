// Kernel 1b: kernel 1 with its target scaled by a runtime beta, over every
// rung of a tempering ladder in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces mcmc_tpu/ops/fused_trajectory.py:_make_kernel with scaled=True
// (lp and grad times the scalar lp_scale inside every substep), which
// mcmc_tpu/samplers/tempered.py launches once per rung and sweep with that
// rung's (eps_k, beta_k). Here one launch takes the replica-major (K C, D)
// batch: row r belongs to rung k = r / C and reads its rung's row of a
// (K, 4) table, (eps_k, gamma, steepness, beta_k) -- the TPU kernel's scalar
// vector for that rung. At K = 1 this is the TPU kernel. The Philox
// counter's chain word is the global row r. The state machine is kernel 1's
// (trajectory.cuh); the potential is Scaled<Target>: lp and grad of the
// target times beta, in that order, on the tempered state the caller
// carries. Plain PyTorch version: ops/fused_trajectory.py:
// grahmc_step_scaled_plain.
//
// What bounds it on an H100: as kernel 1, the chain state read and written
// once per transition, q and grad in, q, grad and the proposal out (about
// 10.7 MB at 49,152 rows x 10 dims, ~3.2 us at 3.35 TB/s), against L
// substeps of per-chain arithmetic and two dependent warp sums each (the
// mixture's). Warp per row at D = 10, 22 of 32 lanes hold padding while
// every lane issues the per-row tanhf friction, the mixture's expf, logf
// and broadcast and the butterflies: 0.160 ms, 50x the bound. In kernel 1's
// lane groups (trajectory.cuh), 8 rows a warp at D = 10, each group its own
// rung's scalars (a warp's rows may lie in two rungs), it takes 0.032 ms
// (H100 80GB HBM3 at 700 W, experiments/torch_step_kernel_timing.py).
//
// Build: as fused_trajectory.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3, no --use_fast_math).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "trajectory.cuh"

namespace mcmc {

// The target's lp and gradient times beta.
template <typename T>
struct Scaled {
  T target;
  float beta;

  template <int K>
  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    const float lp = target(q, g, lane);
#pragma unroll
    for (int r = 0; r < K; ++r) g[r] = beta * g[r];
    return beta * lp;
  }
};

template <typename T>
struct family_of<Scaled<T>> : family_of<T> {};

// Kernel 1's layout (fused_trajectory.cuh:grahmc_step_kernel): warp per
// chain at G = 32, else lane groups of G lanes. A group reads its own rung's
// row, so a warp's chains may belong to two rungs.
template <int FAMILY, int K, bool DENSE, int G>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) grahmc_scaled_kernel(const StepArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if constexpr (G == 32) {
    const int chain = blockIdx.x * WARPS_PER_BLOCK + warp;
    extern __shared__ __align__(16) float smem[];
    const Metric<K, DENSE> metric =
        make_metric<K, DENSE>(a.inv_mass, a.l_inv, a.dim, smem, warp, lane);
    if (chain >= a.n_chains) return;  // uniform across the warp

    const float* rung = a.scalars + 4 * (chain / a.rung_chains);
    const Scalars sc{rung[0], rung[1], rung[2]};
    const Scaled<Target<FAMILY, K>> potential{Target<FAMILY, K>(a.dim, a.params, a.data),
                                               rung[3]};
    step_chain<K>(a, potential, metric, sc, chain, lane);
  } else {
    static_assert(!DENSE && GROUPED_FAMILY<FAMILY>, "lane groups: diagonal, no data");
    constexpr int N = K * 32 / G;  // registers a lane
    const int first = (blockIdx.x * WARPS_PER_BLOCK + warp) * (32 / G);
    if (first >= a.n_chains) return;  // uniform across the warp
    const int gl = lane & (G - 1);
    const bool active = first + lane / G < a.n_chains;
    const int chain = active ? first + lane / G : a.n_chains - 1;
    const float* rung = a.scalars + 4 * (chain / a.rung_chains);
    const Scalars sc{rung[0], rung[1], rung[2]};
    const Scaled<Target<FAMILY, N, G>> potential{Target<FAMILY, N, G>(a.dim, a.params, a.data),
                                                 rung[3]};
    step_chain<N, G>(a, potential, DiagMetric<N, G>(a.inv_mass, gl, a.dim), sc, chain, gl,
                     active);
  }
}

template <int FAMILY, int K, bool DENSE>
struct ScaledLaunch {
  static cudaError_t run(const StepArgs& a, cudaStream_t stream) {
    constexpr int LEAST = DENSE ? 32 : least_lanes<FAMILY, K>();
    return launch_lanes<LEAST>(step_lanes(LEAST, a.n_chains), [&](auto lanes) {
      constexpr int G = decltype(lanes)::value;
      return launch<K, DENSE, G>(grahmc_scaled_kernel<FAMILY, K, DENSE, G>, a, stream);
    });
  }
};

}  // namespace mcmc

// Plain C entry point, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// n_chains rows in rungs of rung_chains consecutive rows; `rungs` is the
// (n_chains / rung_chains, 4) device table (eps_k, gamma, steepness, beta_k).
// The other arguments as grahmc_step_launch's (fused_trajectory.cu). Returns
// the launch's cudaError_t.
extern "C" int grahmc_scaled_launch(int family, int dim, int n_chains, int rung_chains,
                                    int num_steps, int schedule, int dense,
                                    const mcmc::TargetParams* target_params,
                                    const mcmc::TargetData* data, const float* rungs,
                                    const uint32_t* key, unsigned int call, const float* q,
                                    const float* lp, const float* grad,
                                    const float* inv_mass, const float* l_inv,
                                    const float* p0, const float* u, float* q_out,
                                    float* lp_out, float* grad_out, bool* acc_out,
                                    float* dh_out, float* prop_q, float* prop_lp,
                                    void* stream) {
  if ((p0 == nullptr && key == nullptr) || target_params == nullptr || rungs == nullptr ||
      (dense && l_inv == nullptr) || rung_chains < 1 || n_chains % rung_chains != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc::StepArgs a{};
  a.dim = dim, a.n_chains = n_chains, a.num_steps = num_steps, a.schedule = schedule;
  a.rung_chains = rung_chains;
  a.params = *target_params;
  a.data = mcmc::target_data(data);
  a.scalars = rungs, a.key = key, a.call = call;
  a.q = q, a.lp = lp, a.grad = grad, a.inv_mass = inv_mass, a.l_inv = l_inv;
  a.p0 = p0, a.u = u;
  a.q_out = q_out, a.lp_out = lp_out, a.grad_out = grad_out, a.acc_out = acc_out;
  a.dh_out = dh_out, a.prop_q = prop_q, a.prop_lp = prop_lp;
  return static_cast<int>(mcmc::dispatch<mcmc::ScaledLaunch>(
      family, dense != 0, a, static_cast<cudaStream_t>(stream)));
}
