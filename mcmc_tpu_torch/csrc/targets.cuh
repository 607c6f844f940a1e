// Target device functions inlined into the fused GRAHMC kernels.
//
// Replace mcmc_tpu/ops/padded_targets.py:_standard_normal and _neals_funnel.
// One warp holds one chain: lane j owns coordinates j, j+32, ... (K of them,
// zeros past dim). Each functor maps this lane's q to its gradient entries
// and returns the chain's log-density, identical on every lane. The float
// arithmetic follows the plain PyTorch version in
// mcmc_tpu_torch/ops/padded_targets.py term for term.
#pragma once

#include <cuda_runtime.h>

namespace mcmc {

// Must match FAMILY_IDS in mcmc_tpu_torch/ops/padded_targets.py.
enum Family { STANDARD_NORMAL = 0, NEALS_FUNNEL = 1 };

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double LOG_2PI = 1.8378770664093453;         // log(2 pi)
constexpr double LOG_2PI_9 = 4.0351016437455645;       // log(2 pi * 9)

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(FULL_MASK, v, offset);
  }
  return v;
}

template <int FAMILY, int K>
struct Target;

// N(0, I): lp = -0.5 (sum q^2 + D log 2pi), grad = -q.
template <int K>
struct Target<STANDARD_NORMAL, K> {
  float c;
  __device__ explicit Target(int dim) : c(static_cast<float>(dim * LOG_2PI)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int /*lane*/) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      s += q[r] * q[r];
      g[r] = -q[r];
    }
    return -0.5f * (warp_sum(s) + c);
  }
};

// Neal's funnel: x0 ~ N(0, 9), x_i | x0 ~ N(0, exp(x0)). The neck x0 is
// coordinate 0, lane 0's first register; it is broadcast with one shuffle.
template <int K>
struct Target<NEALS_FUNNEL, K> {
  float d_rest, c_rest, c_neck;
  __device__ explicit Target(int dim)
      : d_rest(static_cast<float>(dim - 1)),
        c_rest(static_cast<float>((dim - 1) * LOG_2PI)),
        c_neck(static_cast<float>(LOG_2PI_9)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    const float x0 = __shfl_sync(FULL_MASK, q[0], 0);
    const float inv_var = expf(-x0);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float v = (r == 0 && lane == 0) ? 0.f : q[r];
      s += v * v;
      g[r] = -q[r] * inv_var;
    }
    const float sum_sq = warp_sum(s);
    if (lane == 0) {
      g[0] = -x0 / 9.f + 0.5f * inv_var * sum_sq - 0.5f * d_rest;
    }
    return -0.5f * (x0 * x0 / 9.f + c_neck) -
           0.5f * (sum_sq * inv_var + d_rest * x0 + c_rest);
  }
};

}  // namespace mcmc
