// Target device functions inlined into the fused kernels.
//
// Replace mcmc_tpu/ops/padded_targets.py:_standard_normal, _neals_funnel,
// _correlated and _gaussian_mixture.
// A group of G lanes (G a power of two, 32 = a whole warp) holds one chain:
// each lane owns K coordinates (zeros past dim), and coordinate 0 is register
// 0 of the group's lane 0. The GRAHMC and NUTS kernels use G = 32 with lane j
// owning j, j+32, ...; the RWMH kernel packs 32 / G chains into a warp, lane
// j of a group owning 4j..4j+3. Each functor maps this lane's q to its
// gradient entries and returns the chain's log-density, identical on every
// lane of the group. The float arithmetic follows the plain PyTorch version
// in mcmc_tpu_torch/ops/padded_targets.py term for term.
#pragma once

#include <cuda_runtime.h>

namespace mcmc {

// Must match FAMILY_IDS in mcmc_tpu_torch/ops/padded_targets.py.
enum Family {
  STANDARD_NORMAL = 0,
  NEALS_FUNNEL = 1,
  CORRELATED_GAUSSIAN = 2,
  GAUSSIAN_MIXTURE = 3
};

// A family's float parameters, computed on the host in double and rounded
// once (mcmc_tpu_torch/ops/padded_targets.py:device_params); zeros for the
// families that take none.
struct TargetParams {
  float v[4];
};

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double LOG_2PI = 1.8378770664093453;         // log(2 pi)
constexpr double LOG_2PI_9 = 4.0351016437455645;       // log(2 pi * 9)
constexpr double LOG_HALF = -0.6931471805599453;       // log(1/2)
constexpr double HALF_LOG_2PI = 0.9189385332046727;    // log(2 pi) / 2

// Sum over each aligned group of G lanes; every lane gets its group's
// total. All 32 lanes of the warp must take part.
template <int G = 32>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(FULL_MASK, v, offset);
  }
  return v;
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

template <int FAMILY, int K, int G = 32>
struct Target;

// N(0, I): lp = -0.5 (sum q^2 + D log 2pi), grad = -q.
template <int K, int G>
struct Target<STANDARD_NORMAL, K, G> {
  float c;
  __device__ explicit Target(int dim, const TargetParams& = TargetParams{})
      : c(static_cast<float>(dim * LOG_2PI)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int /*lane*/) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      s += q[r] * q[r];
      g[r] = -q[r];
    }
    return -0.5f * (group_sum<G>(s) + c);
  }
};

// Neal's funnel: x0 ~ N(0, 9), x_i | x0 ~ N(0, exp(x0)). The neck x0 is
// coordinate 0, the group's lane 0's first register; it is broadcast with
// one shuffle. `lane` is the lane's index within its group.
template <int K, int G>
struct Target<NEALS_FUNNEL, K, G> {
  float d_rest, c_rest, c_neck;
  __device__ explicit Target(int dim, const TargetParams& = TargetParams{})
      : d_rest(static_cast<float>(dim - 1)),
        c_rest(static_cast<float>((dim - 1) * LOG_2PI)),
        c_neck(static_cast<float>(LOG_2PI_9)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    const float x0 = __shfl_sync(FULL_MASK, q[0], 0, G);
    const float inv_var = expf(-x0);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float v = (r == 0 && lane == 0) ? 0.f : q[r];
      s += v * v;
      g[r] = -q[r] * inv_var;
    }
    const float sum_sq = group_sum<G>(s);
    if (lane == 0) {
      g[0] = -x0 / 9.f + 0.5f * inv_var * sum_sq - 0.5f * d_rest;
    }
    return -0.5f * (x0 * x0 / 9.f + c_neck) -
           0.5f * (sum_sq * inv_var + d_rest * x0 + c_rest);
  }
};

// Compound-symmetry Gaussian, Sigma^{-1} = a I + b J: with s = sum q,
// siv = a q + b s, grad = -siv, lp = -0.5 (siv . q + log|Sigma| + D log 2pi).
// Two group sums, O(D). The b s term would leak into the zero coordinates
// past dim, so it is masked there; that mask is the warp-per-chain layout's
// (lane j owns j + 32 r), the only one this functor serves. Params: a, b and
// the constant log|Sigma| + D log 2pi. Its sums and products are rounded as
// the plain version's (ops/padded_targets.py:_correlated, warp_order_sum)
// are: under the dense oracle metric the sum s moves the trajectory along
// the metric's largest eigenvector (45x the others at D = 50), so a
// rounding difference there would grow along every trajectory.
template <int K, int G>
struct Target<CORRELATED_GAUSSIAN, K, G> {
  static_assert(G == 32, "the correlated Gaussian serves the warp-per-chain layout");
  float a, b, c;
  int dim;
  __device__ explicit Target(int dim_, const TargetParams& p)
      : a(p.v[0]), b(p.v[1]), c(p.v[2]), dim(dim_) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s += q[r];
    s = group_sum<G>(s);
    const float bs = __fmul_rn(b, s);
    float m = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float siv = lane + 32 * r < dim ? __fadd_rn(__fmul_rn(a, q[r]), bs) : 0.f;
      m = __fadd_rn(m, __fmul_rn(siv, q[r]));
      g[r] = -siv;
    }
    return -0.5f * (group_sum<G>(m) + c);
  }
};

// Two-mode mixture: x0 ~ (N(-h, 1) + N(h, 1)) / 2 with h = sep / 2, the
// other coordinates N(0, 1). x0 is coordinate 0, broadcast from the group's
// lane 0 with one shuffle as the funnel's neck is; two expf, one logf and one
// group sum of the other coordinates' squares. Params: h.
template <int K, int G>
struct Target<GAUSSIAN_MIXTURE, K, G> {
  float half_sep, c_rest;
  __device__ explicit Target(int dim, const TargetParams& p)
      : half_sep(p.v[0]), c_rest(static_cast<float>((dim - 1) * LOG_2PI)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    const float x0 = __shfl_sync(FULL_MASK, q[0], 0, G);
    const float a = x0 + half_sep;
    const float b = x0 - half_sep;
    const float m1 = -0.5f * (a * a);
    const float m2 = -0.5f * (b * b);
    const float mx = fmaxf(m1, m2);
    const float e1 = expf(m1 - mx);
    const float e2 = expf(m2 - mx);
    const float lse = e1 + e2;
    const float log_p_x0 =
        static_cast<float>(LOG_HALF) + mx + logf(lse) - static_cast<float>(HALF_LOG_2PI);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float v = (r == 0 && lane == 0) ? 0.f : q[r];
      s += v * v;
      g[r] = -q[r];
    }
    const float sum_sq = group_sum<G>(s);
    if (lane == 0) g[0] = -(a * e1 + b * e2) / lse;
    return log_p_x0 - 0.5f * (sum_sq + c_rest);
  }
};

}  // namespace mcmc
