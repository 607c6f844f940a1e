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
// device (SMC picks both there). The potential, in the TPU kernel's order:
//   z = (q - m) (1/S),  lb = -sum z^2 / 2 + base_log_norm,
//   lp = beta lt + (1 - beta) lb,  grad = beta gt - (1 - beta) (z (1/S)).
// At beta = 1 this is kernel 1 bit for bit but for the sign of an exact
// zero gradient entry and, on the funnel at K >= 2, the last bits of the lp
// (Bridged::log_density). The state machine is kernel 1's (trajectory.cuh).
// Plain PyTorch version: ops/fused_trajectory.py:grahmc_bridged_plain.
//
// What bounds it on an H100: as kernel 1, the chain state read and written
// once per transition (about 14.2 MB at 65,536 x 10, ~4.2 us at 3.35 TB/s),
// against L substeps of per-chain work: the target's (the mixture's two
// expf, logf, broadcast and sum) and the base's sum. Warp per chain at D =
// 10, 22 of 32 lanes held padding while every lane issued that work:
// 0.168 ms, 40x the bound. Now, as 1b, the diagonal instances on the
// GROUPED_FAMILY targets run in kernel 1's lane groups (4 lanes a chain at
// D <= 32, trajectory.cuh:step_lanes), the base term summed in the
// warp-per-chain order (targets.cuh:chain_sum), and every substep but a
// trajectory's last computes the gradient alone, without the target's
// log-density and the base's sum (transition's LP_LAST; a target whose
// functor takes no `with_lp`, the hierarchical posterior, keeps the
// unpeeled loop), bit for bit the warp-per-chain kernel: the funnel's
// log-density is rounded as the warp instances compiled it
// (Bridged::log_density). The instances are compiled for
// bridged_min_blocks() blocks an SM, the register budget under which the
// peel spills no more than the unpeeled loop did. 0.1676 -> 0.0384 ms at
// 65,536 x 10, L 16, and 0.0551 -> 0.0152 at the SMC row's 32,768 x 10,
// L 8 (H100 80GB HBM3 at 700 W, experiments/torch_step_kernel_timing.py).
//
// Build: as fused_trajectory.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3, no --use_fast_math).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "trajectory.cuh"

namespace mcmc {

// Blocks an SM 1c's instance is compiled for (__launch_bounds__'s
// minimum): 2 where a lane holds 2 or more registers of each row, as kernel
// 2 (fused_trajectory.cuh:MULTI_MIN_BLOCKS), else 1. Without a minimum
// ptxas spilled 18 of the peeled instances where the unpeeled ones did not;
// at 3 the 4-lane groups spilled (PERF.md section 6).
template <int K, int G>
constexpr int bridged_min_blocks() {
  return K * 32 / G > 1 ? 2 : 1;
}

// beta * target + (1 - beta) * log N(mean, diag(1 / inv_scale^2)) for a
// group of G lanes (targets.cuh's layout), each lane holding the mean and
// 1/S of its coordinates (zeros past dim, so the base term sees none of
// them). With `with_lp` false it writes the same gradient bits and returns
// 0, leaving out the base's sum and the target's log-density (PEELS: the
// target's functor takes `with_lp`). For a family of ROUNDED_LEAPFROG the
// gradient's products are rounded before their difference, as the plain
// version's (ops/fused_trajectory.py:bridged_vag) are.
template <typename T, int K, int G = 32>
struct Bridged {
  static constexpr bool PEELS = TAKES_WITH_LP<T, K>;
  T target;
  float beta, one_minus_beta, base_log_norm;
  float mean[K], inv_scale[K];

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K], int lane,
                                              bool with_lp = true) const {
    if constexpr (PEELS) {
      if (!with_lp) {  // the gradient alone
        target(q, g, lane, false);
#pragma unroll
        for (int r = 0; r < K; ++r) mix(g, r, (q[r] - mean[r]) * inv_scale[r]);
        return 0.f;
      }
    }
    const float lt = log_density(q, g, lane);
    float z[K];
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = (q[r] - mean[r]) * inv_scale[r];
    const float lb =
        -0.5f * chain_sum<K, G, false>([&](float s, int r) { return s + z[r] * z[r]; }) +
        base_log_norm;
#pragma unroll
    for (int r = 0; r < K; ++r) mix(g, r, z[r]);
    return beta * lt + one_minus_beta * lb;
  }

  // The target's lp (and gradient). The funnel's log-density rounded as
  // 1c's warp-per-chain instances compiled it, whatever the layout: nvcc
  // fused d_rest x0 into sum_sq inv_var + d_rest x0 at K = 1 and sum_sq
  // inv_var at K >= 2, and the other product in the lane groups (kernel 1
  // fuses d_rest x0 at K >= 2 too; PERF.md section 6).
  __device__ __forceinline__ float log_density(const float (&q)[K], float (&g)[K],
                                               int lane) const {
    if constexpr (family_of<T>::value == NEALS_FUNNEL) {
      return target.template operator()<K * G == 32 ? 1 : 2>(q, g, lane);
    } else {
      return target(q, g, lane);
    }
  }

  // g[r] = beta g[r] - (1 - beta) z (1/S)
  __device__ __forceinline__ void mix(float (&g)[K], int r, float z) const {
    if constexpr (ROUNDED_LEAPFROG<family_of<T>::value>) {
      g[r] = __fsub_rn(__fmul_rn(beta, g[r]),
                       __fmul_rn(one_minus_beta, __fmul_rn(z, inv_scale[r])));
    } else {
      g[r] = beta * g[r] - one_minus_beta * (z * inv_scale[r]);
    }
  }
};

template <typename T, int K, int G>
struct family_of<Bridged<T, K, G>> : family_of<T> {};

// The bridge over the family's target for a group of G lanes, K registers
// a lane; `lane` its place in the group.
template <int FAMILY, int K, int G>
__device__ __forceinline__ Bridged<Target<FAMILY, K, G>, K, G> bridge(const StepArgs& a,
                                                                      int lane) {
  const float beta = a.scalars[3];
  Bridged<Target<FAMILY, K, G>, K, G> b{Target<FAMILY, K, G>(a.dim, a.params, a.data), beta,
                                        1.f - beta, a.scalars[4]};
  load_row<K, G>(a.base_mean, 0, lane, a.dim, b.mean);
  load_row<K, G>(a.base_inv_scale, 0, lane, a.dim, b.inv_scale);
  return b;
}

// Kernel 1's layout (fused_trajectory.cuh:grahmc_step_kernel): warp per
// chain at G = 32, else lane groups of G lanes; every substep but a
// trajectory's last computes the gradient alone where the target's functor
// allows it (Bridged::PEELS).
template <int FAMILY, int K, bool DENSE, int G>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, (bridged_min_blocks<K, G>()))
    grahmc_bridged_kernel(const StepArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  if constexpr (G == 32) {
    const int chain = blockIdx.x * WARPS_PER_BLOCK + warp;
    extern __shared__ __align__(16) float smem[];
    const Metric<K, DENSE> metric =
        make_metric<K, DENSE>(a.inv_mass, a.l_inv, a.dim, smem, warp, lane);
    if (chain >= a.n_chains) return;  // uniform across the warp
    using P = Bridged<Target<FAMILY, K>, K>;
    const P potential = bridge<FAMILY, K, 32>(a, lane);
    step_chain<K, 32, false, P::PEELS>(a, potential, metric, sc, chain, lane);
  } else {
    static_assert(!DENSE && GROUPED_FAMILY<FAMILY>, "lane groups: diagonal, no data");
    constexpr int N = K * 32 / G;  // registers a lane
    const int first = (blockIdx.x * WARPS_PER_BLOCK + warp) * (32 / G);
    if (first >= a.n_chains) return;  // uniform across the warp
    const int gl = lane & (G - 1);
    const bool active = first + lane / G < a.n_chains;
    const int chain = active ? first + lane / G : a.n_chains - 1;
    using P = Bridged<Target<FAMILY, N, G>, N, G>;
    const P potential = bridge<FAMILY, N, G>(a, gl);
    step_chain<N, G, true, P::PEELS>(a, potential, DiagMetric<N, G>(a.inv_mass, gl, a.dim), sc,
                                     chain, gl, active);
  }
}

template <int FAMILY, int K, bool DENSE>
struct BridgedLaunch {
  static cudaError_t run(const StepArgs& a, cudaStream_t stream) {
    constexpr int LEAST = DENSE ? 32 : least_lanes<FAMILY, K>();
    return launch_lanes<LEAST>(step_lanes(LEAST, a.n_chains), [&](auto lanes) {
      constexpr int G = decltype(lanes)::value;
      return launch<K, DENSE, G>(grahmc_bridged_kernel<FAMILY, K, DENSE, G>, a, stream);
    });
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
