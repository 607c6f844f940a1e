// Kernel 1c: kernel 1 on the annealed-SMC geometric bridge, for NVIDIA
// Hopper (sm_90a).
//
// Replaces mcmc_tpu/ops/fused_trajectory.py:_make_kernel with bridged=True,
// the move kernel of mcmc_tpu/samplers/smc.py: each transition targets
//   pi_b = beta logp + (1 - beta) log N(m, S^2 I)
// with a runtime beta, the spherical-Gaussian base evaluated in the kernel
// from a (D,) mean row and a (D,) row of 1/S. The scalars are (eps, gamma,
// steepness, beta, base_log_norm), base_log_norm = -sum log S - D/2 log 2 pi
// computed on the host in double and rounded once; beta and eps stay on the
// device (SMC picks both there). Each lane keeps the mean and 1/S of its
// coordinates in registers (zeros past D, so the base term sees none of
// them). The potential, in the TPU kernel's order:
//   z = (q - m) (1/S),  lb = -sum z^2 / 2 + base_log_norm,
//   lp = beta lt + (1 - beta) lb,  grad = beta gt - (1 - beta) (z (1/S)).
// At beta = 1 this is kernel 1 bit for bit. The state machine is kernel 1's
// (trajectory.cuh). Plain PyTorch version: ops/fused_trajectory.py:
// grahmc_step_bridged_plain.
//
// What bounds it on an H100: as kernel 1, the chain state read and written
// once per transition (about 14.2 MB at 65,536 x 10, ~4.2 us at 3.35 TB/s);
// the base term adds one warp sum per substep to the target's, and at
// D = 10 one warp per chain leaves 22 of 32 lanes idle: the substeps' issue
// and latency set its time.
//
// Build: as fused_trajectory.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3, no --use_fast_math).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "trajectory.cuh"

namespace mcmc {

// beta * target + (1 - beta) * log N(mean, diag(1 / inv_scale^2)). For a
// family of ROUNDED_LEAPFROG the gradient's products are rounded before
// their difference, as the plain version's (ops/fused_trajectory.py:
// bridged_vag) are.
template <typename T, int K>
struct Bridged {
  T target;
  float beta, one_minus_beta, base_log_norm;
  float mean[K], inv_scale[K];

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    const float lt = target(q, g, lane);
    float z[K];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      z[r] = (q[r] - mean[r]) * inv_scale[r];
      s += z[r] * z[r];
    }
    const float lb = -0.5f * warp_sum(s) + base_log_norm;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if constexpr (ROUNDED_LEAPFROG<family_of<T>::value>) {
        g[r] = __fsub_rn(__fmul_rn(beta, g[r]),
                         __fmul_rn(one_minus_beta, __fmul_rn(z[r], inv_scale[r])));
      } else {
        g[r] = beta * g[r] - one_minus_beta * (z[r] * inv_scale[r]);
      }
    }
    return beta * lt + one_minus_beta * lb;
  }
};

template <typename T, int K>
struct family_of<Bridged<T, K>> : family_of<T> {};

template <int FAMILY, int K, bool DENSE>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    grahmc_bridged_kernel(const StepArgs a) {
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * WARPS_PER_BLOCK + warp;
  const int lane = threadIdx.x & 31;
  extern __shared__ __align__(16) float smem[];
  const Metric<K, DENSE> metric =
      make_metric<K, DENSE>(a.inv_mass, a.l_inv, a.dim, smem, warp, lane);
  if (chain >= a.n_chains) return;  // uniform across the warp

  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  Bridged<Target<FAMILY, K>, K> potential{Target<FAMILY, K>(a.dim, a.params, a.data),
                                          a.scalars[3], 1.f - a.scalars[3], a.scalars[4]};
  load_row(a.base_mean, 0, lane, a.dim, potential.mean);
  load_row(a.base_inv_scale, 0, lane, a.dim, potential.inv_scale);
  step_chain<K>(a, potential, metric, sc, chain, lane);
}

template <int FAMILY, int K, bool DENSE>
struct BridgedLaunch {
  static cudaError_t run(const StepArgs& a, cudaStream_t stream) {
    return launch<K, DENSE>(grahmc_bridged_kernel<FAMILY, K, DENSE>, a, stream);
  }
};

}  // namespace mcmc

// Plain C entry point, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// `scalars` is the device array (eps, gamma, steepness, beta,
// base_log_norm); base_mean and base_inv_scale are (dim,) device rows. The
// other arguments as grahmc_step_launch's (fused_trajectory.cu). Returns the
// launch's cudaError_t.
extern "C" int grahmc_bridged_launch(int family, int dim, int n_chains, int num_steps,
                                     int schedule, int dense, const mcmc::TargetParams* target_params,
                                     const mcmc::TargetData* data, const float* scalars,
                                     const float* base_mean,
                                     const float* base_inv_scale, const uint32_t* key,
                                     unsigned int call, const float* q, const float* lp,
                                     const float* grad, const float* inv_mass,
                                     const float* l_inv, const float* p0, const float* u,
                                     float* q_out, float* lp_out, float* grad_out,
                                     bool* acc_out, float* dh_out, float* prop_q,
                                     float* prop_lp, void* stream) {
  if ((p0 == nullptr && key == nullptr) || target_params == nullptr || base_mean == nullptr ||
      base_inv_scale == nullptr || (dense && l_inv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc::StepArgs a{};
  a.dim = dim, a.n_chains = n_chains, a.num_steps = num_steps, a.schedule = schedule;
  a.params = *target_params;
  a.data = mcmc::target_data(data);
  a.scalars = scalars, a.base_mean = base_mean, a.base_inv_scale = base_inv_scale;
  a.key = key, a.call = call;
  a.q = q, a.lp = lp, a.grad = grad, a.inv_mass = inv_mass, a.l_inv = l_inv;
  a.p0 = p0, a.u = u;
  a.q_out = q_out, a.lp_out = lp_out, a.grad_out = grad_out, a.acc_out = acc_out;
  a.dh_out = dh_out, a.prop_q = prop_q, a.prop_lp = prop_lp;
  return static_cast<int>(mcmc::dispatch<mcmc::BridgedLaunch>(
      family, dense != 0, a, static_cast<cudaStream_t>(stream)));
}
