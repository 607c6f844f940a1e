// Target device functions inlined into the fused kernels.
//
// Replace the 14 device functions of mcmc_tpu/ops/padded_targets.py:_BUILDERS:
// _standard_normal, _neals_funnel, _correlated, _gaussian_mixture,
// _hierarchical_logistic, _neals_funnel_noncentered, _ill_conditioned,
// _student_t, _log_gamma, _log_gamma_unconstrained, _rosenbrock,
// _multimodal_funnel_2d, _concentric_l1 and _nested_l1.
// A group of G lanes (G a power of two, 32 = a whole warp) holds one chain:
// each lane owns K coordinates (zeros past dim), and coordinate 0 is register
// 0 of the group's lane 0. Two layouts, the template flag BLOCKED: the
// GRAHMC and NUTS kernels use lane j owning j, j+G, j+2G, ... (BLOCKED
// false; G = 32 but for kernel 1's and 1b's lane groups, where one lane
// stands for the 32 / G lanes j + G m of the warp-per-chain layout and
// chain_sum keeps that layout's order); the RWMH kernel packs 32 / G chains
// into a warp, lane j of a group owning 4j..4j+3 (BLOCKED true, K = 4).
// Each functor maps this
// lane's q to its gradient entries and returns the chain's log-density,
// identical on every lane of the group. A functor's optional last argument
// `with_lp` (true unless given) asks for the log-density: false computes the
// same gradient bits (where a functor has two arms, both write g through one
// lambda, `grad`) and returns 0, leaving out the sums and terms only the
// log-density reads (kernel 2 reads the lp of a trajectory's last substep
// alone, trajectory.cuh:transition's LP_LAST); a sum the gradient reads stays
// (the funnel's, the correlated Gaussian's first, log-gamma's support count,
// the L1 shells'). The hierarchical functor always computes it (its kernel 2,
// 2b, runs block-tiled). The float arithmetic follows the
// plain PyTorch version in mcmc_tpu_torch/ops/padded_targets.py term for
// term; the functors of families 5-13 and the correlated Gaussian also
// round each product before its sum (__fmul_rn, __fadd_rn: no FMA) and sum
// in the plain version's lane order (warp_order_sum), so their lp and
// gradient equal the plain version's bit for bit where the two libraries'
// expf/logf/log1pf agree.
#pragma once

#include <cuda_runtime.h>

namespace mcmc {

// Must match FAMILY_IDS in mcmc_tpu_torch/ops/padded_targets.py.
enum Family {
  STANDARD_NORMAL = 0,
  NEALS_FUNNEL = 1,
  CORRELATED_GAUSSIAN = 2,
  GAUSSIAN_MIXTURE = 3,
  HIERARCHICAL_LOGISTIC = 4,
  NEALS_FUNNEL_NONCENTERED = 5,
  ILL_CONDITIONED_GAUSSIAN = 6,
  STUDENT_T = 7,
  LOG_GAMMA = 8,
  LOG_GAMMA_UNCONSTRAINED = 9,
  ROSENBROCK = 10,
  MULTIMODAL_FUNNEL_2D = 11,
  CONCENTRIC_L1 = 12,
  NESTED_L1 = 13
};

// Every family, for the launchers' switches: X(FAMILY) once each.
#define MCMC_FAMILIES(X)                                                              \
  X(STANDARD_NORMAL) X(NEALS_FUNNEL) X(CORRELATED_GAUSSIAN) X(GAUSSIAN_MIXTURE)       \
  X(HIERARCHICAL_LOGISTIC) X(NEALS_FUNNEL_NONCENTERED) X(ILL_CONDITIONED_GAUSSIAN)    \
  X(STUDENT_T) X(LOG_GAMMA) X(LOG_GAMMA_UNCONSTRAINED) X(ROSENBROCK)                  \
  X(MULTIMODAL_FUNNEL_2D) X(CONCENTRIC_L1) X(NESTED_L1)

// The most L1 shells a target of the two L1 families may carry (the radii
// of concentric_l1_balls; nested_l1_balls' n_inner + 1). A target with more
// is refused by the Python wrappers (padded_targets.MAX_SHELLS); it is
// never truncated.
constexpr int MAX_SHELLS = 8;

// A family's float parameters, computed on the host in double and rounded
// once (mcmc_tpu_torch/ops/padded_targets.py:device_params and
// device_shells); zeros for the families that take none. The L1 families'
// shell radii go in `shell`, their count in `n_shells`.
struct TargetParams {
  float v[8];
  float shell[MAX_SHELLS];
  int n_shells;
};

// A data-carrying family's data set in device memory
// (mcmc_tpu_torch/ops/padded_targets.py:device_data); null pointers for the
// other families. X is (n_data, dim) row-major with a zero column 0, xt its
// (dim, n_data) transpose, y (n_data,).
struct TargetData {
  const float* X;
  const float* xt;
  const float* y;
  int n_data;
};

// A data-carrying family needs its data set; the others take none.
inline bool valid_data(int family, const TargetData& d) {
  if (family != HIERARCHICAL_LOGISTIC) return true;
  return d.X != nullptr && d.xt != nullptr && d.y != nullptr && d.n_data >= 1;
}

// The TargetData a launcher was handed: the pointed-to set, or none.
inline TargetData target_data(const TargetData* data) {
  return data != nullptr ? *data : TargetData{};
}

// Warps per block of every kernel that inlines a target: the hierarchical
// functor keeps one staging row per warp in static shared memory.
constexpr int TARGET_MAX_WARPS = 8;

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

// A chain's sum over its group: `acc(s, r)` returns s plus register r's
// term, and every lane of the group gets the total. In the warp-per-chain
// layout (G = 32) and kernel 3's (BLOCKED) a lane adds its registers in
// turn, then group_sum. In kernel 1's lane groups (G < 32, not BLOCKED) the
// sum is the warp-per-chain layout's, bit for bit: lane j of the group holds
// the coordinates of that layout's lanes j + G m (m < 32 / G), its register
// m + (32 / G) r being lane j + G m's register r. So the lane first sums
// each such lane's registers in that lane's order, then folds the 32 / G
// partials in registers as the butterfly's levels 16, ..., G pair them, and
// runs the levels G / 2, ..., 1 as shuffles. Addition is commutative, so
// every partial and every level is the one the warp-per-chain butterfly
// forms; a partial of padding alone still adds its term (ops/padded_targets.py:
// warp_order_sum is this order; tests/test_torch_fold_order.py models the fold).
template <int K, int G, bool BLOCKED, typename Acc>
__device__ __forceinline__ float chain_sum(const Acc& acc) {
  if constexpr (G == 32 || BLOCKED) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s = acc(s, r);
    return group_sum<G>(s);
  } else {
    constexpr int M = 32 / G;  // warp-per-chain lanes a lane stands for
    static_assert(K % M == 0, "a lane holds whole warp-per-chain lanes");
    float part[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s = 0.f;
#pragma unroll
      for (int r = m; r < K; r += M) s = acc(s, r);
      part[m] = s;
    }
#pragma unroll
    for (int w = M / 2; w > 0; w /= 2) {
#pragma unroll
      for (int m = 0; m < w; ++m) part[m] += part[m + w];
    }
    return group_sum<G>(part[0]);
  }
}

// The coordinate register r of a group's lane `lane` holds: lane + G r in
// the warp-per-chain layout (G = 32), K lane + r in kernel 3's blocked one.
template <int K, int G, bool BLOCKED>
__device__ __forceinline__ int coord_of(int lane, int r) {
  return BLOCKED ? K * lane + r : lane + G * r;
}

template <int FAMILY, int K, int G = 32, bool BLOCKED = false>
struct Target;

// Families whose kernels round the leapfrog's products before their sums
// (metric.cuh:add_scaled<true>) in the diagonal variants too, as every
// dense variant does: where a rounding difference in q would grow, the
// kernel repeats the plain version's trajectory. The L1 shells' gradient
// jumps where a coordinate changes sign, Rosenbrock's moves ~1,000x as
// fast as q (a = 100) and the bimodal funnel's neck amplifies it: with an
// FMA's ulp of difference, [3g] read drifted proposals on up to 4% of
// 16,384 chains after 8 transitions. The other families keep the FMA:
// rounding them too made kernel 1 3.9%, kernel 2 3.5% and kernel 4 1.7%
// slower on the 50-D funnel (H100 80GB HBM3 at 700 W,
// experiments/torch_leapfrog_rounding_timing.py), and [3g] bounds their
// few drifted chains (chip_smoke.py:FAMILY_DRIFT).
template <int FAMILY>
constexpr bool ROUNDED_LEAPFROG = FAMILY == ROSENBROCK || FAMILY == MULTIMODAL_FUNNEL_2D ||
                                  FAMILY == CONCENTRIC_L1 || FAMILY == NESTED_L1;

// The family of a potential: a Target's own, a wrapper's (Scaled, Bridged)
// that of the target it wraps.
template <typename P>
struct family_of;
template <int FAMILY, int K, int G, bool BLOCKED>
struct family_of<Target<FAMILY, K, G, BLOCKED>> {
  static constexpr int value = FAMILY;
};

// N(0, I): lp = -0.5 (sum q^2 + D log 2pi), grad = -q.
template <int K, int G, bool BLOCKED>
struct Target<STANDARD_NORMAL, K, G, BLOCKED> {
  float c;
  __device__ explicit Target(int dim, const TargetParams& = TargetParams{},
                             const TargetData& = TargetData{})
      : c(static_cast<float>(dim * LOG_2PI)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int /*lane*/, bool with_lp = true) const {
    const auto grad = [&](int r) { g[r] = -q[r]; };
    if (!with_lp) {
#pragma unroll
      for (int r = 0; r < K; ++r) grad(r);
      return 0.f;
    }
    const float sum_sq = chain_sum<K, G, BLOCKED>([&](float s, int r) {
      grad(r);
      return s + q[r] * q[r];
    });
    return -0.5f * (sum_sq + c);
  }
};

// Neal's funnel: x0 ~ N(0, 9), x_i | x0 ~ N(0, exp(x0)). The neck x0 is
// coordinate 0, the group's lane 0's first register; it is broadcast with
// one shuffle. `lane` is the lane's index within its group. FUSED: the
// log-density's sum_sq inv_var + d_rest x0 as nvcc compiles it (0; it
// fuses one product or the other by the kernel and layout), or with
// d_rest x0 (1) or sum_sq inv_var (2) fused, as a kernel that must keep
// its bits across layouts asks (1c, fused_trajectory_bridged.cu).
template <int K, int G, bool BLOCKED>
struct Target<NEALS_FUNNEL, K, G, BLOCKED> {
  float d_rest, c_rest, c_neck;
  __device__ explicit Target(int dim, const TargetParams& = TargetParams{},
                             const TargetData& = TargetData{})
      : d_rest(static_cast<float>(dim - 1)),
        c_rest(static_cast<float>((dim - 1) * LOG_2PI)),
        c_neck(static_cast<float>(LOG_2PI_9)) {}

  template <int FUSED = 0>
  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    const float x0 = __shfl_sync(FULL_MASK, q[0], 0, G);
    const float inv_var = expf(-x0);
    const float sum_sq = chain_sum<K, G, BLOCKED>([&](float s, int r) {
      const float v = (r == 0 && lane == 0) ? 0.f : q[r];
      g[r] = -q[r] * inv_var;
      return s + v * v;
    });
    if (lane == 0) {
      g[0] = -x0 / 9.f + 0.5f * inv_var * sum_sq - 0.5f * d_rest;
    }
    if (!with_lp) return 0.f;
    if constexpr (FUSED == 0) {
      return -0.5f * (x0 * x0 / 9.f + c_neck) -
             0.5f * (sum_sq * inv_var + d_rest * x0 + c_rest);
    } else {
      const float rest = FUSED == 1 ? __fmaf_rn(d_rest, x0, sum_sq * inv_var)
                                    : __fmaf_rn(sum_sq, inv_var, d_rest * x0);
      return -0.5f * (x0 * x0 / 9.f + c_neck) - 0.5f * (rest + c_rest);
    }
  }
};

// Compound-symmetry Gaussian, Sigma^{-1} = a I + b J: with s = sum q,
// siv = a q + b s, grad = -siv, lp = -0.5 (siv . q + log|Sigma| + D log 2pi).
// Two group sums, O(D). The b s term would leak into the zero coordinates
// past dim, so it is masked there; that mask is the warp-per-chain layout's
// by the coordinate each register holds in either layout. Params: a, b and
// the constant log|Sigma| + D log 2pi. Its sums and products are rounded as
// the plain version's (ops/padded_targets.py:_correlated, warp_order_sum)
// are: under the dense oracle metric the sum s moves the trajectory along
// the metric's largest eigenvector (45x the others at D = 50), so a
// rounding difference there would grow along every trajectory.
template <int K, int G, bool BLOCKED>
struct Target<CORRELATED_GAUSSIAN, K, G, BLOCKED> {
  float a, b, c;
  int dim;
  __device__ explicit Target(int dim_, const TargetParams& p, const TargetData& = TargetData{})
      : a(p.v[0]), b(p.v[1]), c(p.v[2]), dim(dim_) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    const float s = chain_sum<K, G, BLOCKED>([&](float t, int r) { return t + q[r]; });
    const float bs = __fmul_rn(b, s);
    const auto grad = [&](int r) {  // g = -siv; returns siv
      const float siv =
          coord_of<K, G, BLOCKED>(lane, r) < dim ? __fadd_rn(__fmul_rn(a, q[r]), bs) : 0.f;
      g[r] = -siv;
      return siv;
    };
    if (!with_lp) {  // the gradient alone: the sum m is the log-density's
#pragma unroll
      for (int r = 0; r < K; ++r) grad(r);
      return 0.f;
    }
    const float m = chain_sum<K, G, BLOCKED>(
        [&](float t, int r) { return __fadd_rn(t, __fmul_rn(grad(r), q[r])); });
    return -0.5f * (m + c);
  }
};

// Two-mode mixture: x0 ~ (N(-h, 1) + N(h, 1)) / 2 with h = sep / 2, the
// other coordinates N(0, 1). x0 is coordinate 0, broadcast from the group's
// lane 0 with one shuffle as the funnel's neck is; two expf, one logf and one
// group sum of the other coordinates' squares. Params: h.
template <int K, int G, bool BLOCKED>
struct Target<GAUSSIAN_MIXTURE, K, G, BLOCKED> {
  float half_sep, c_rest;
  __device__ explicit Target(int dim, const TargetParams& p, const TargetData& = TargetData{})
      : half_sep(p.v[0]), c_rest(static_cast<float>((dim - 1) * LOG_2PI)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    const float x0 = __shfl_sync(FULL_MASK, q[0], 0, G);
    const float a = x0 + half_sep;
    const float b = x0 - half_sep;
    const float m1 = -0.5f * (a * a);
    const float m2 = -0.5f * (b * b);
    const float mx = fmaxf(m1, m2);
    const float e1 = expf(m1 - mx);
    const float e2 = expf(m2 - mx);
    const float lse = e1 + e2;
    const auto grad = [&](int r) { g[r] = -q[r]; };
    const auto grad_x0 = [&] {
      if (lane == 0) g[0] = -(a * e1 + b * e2) / lse;
    };
    if (!with_lp) {  // the gradient alone: no logf, no sum
#pragma unroll
      for (int r = 0; r < K; ++r) grad(r);
      grad_x0();
      return 0.f;
    }
    const float log_p_x0 =
        static_cast<float>(LOG_HALF) + mx + logf(lse) - static_cast<float>(HALF_LOG_2PI);
    const float sum_sq = chain_sum<K, G, BLOCKED>([&](float s, int r) {
      const float v = (r == 0 && lane == 0) ? 0.f : q[r];
      grad(r);
      return s + v * v;
    });
    grad_x0();
    return log_p_x0 - 0.5f * (sum_sq + c_rest);
  }
};

// The hierarchical logistic posterior (mcmc_tpu_torch/targets/hierarchical.py):
// tau = coordinate 0, beta the rest, z = X beta over n_data rows,
//   lp = sum_n (y_n z_n - softplus z_n) - e^-tau |beta|^2 / 2 - p tau / 2 - tau^2 / 2,
//   grad_beta = X^T (y - sigmoid z) - beta e^-tau,
//   grad_tau = e^-tau |beta|^2 / 2 - p / 2 - tau.
// Of every ported target's the only gradient with real matrix work: two
// products with the (n_data, dim) matrix X, 4 n_data dim flops, against
// ~15 flops and two transcendentals per data row.
//
// z = X q by row ownership: lane l of the group owns the rows n = l, l + G,
// ... (chunks of G rows, n_data a runtime argument). The group's q is staged
// in a per-group row of static shared memory and read back as float4
// broadcasts; lane l reads column n of xt = X^T, so a warp's load is one
// coalesced line, and sums over the coordinates in order. Each row's one
// exp(-|z|) serves the sigmoid and the softplus, on the lane that owns the
// row. X^T (y - sigmoid z) by coordinate ownership: each row's residual is
// broadcast from its owner with a shuffle and every lane adds X[n, d] r_n
// for its own coordinates d, over the rows in order (coalesced reads of X's
// row n). Per chunk of G rows that is dim / 4 shared loads and G shuffles,
// ~n_data shuffles per evaluation, where warp sums would take 5 per row.
// What bounds it on an H100: every chain reads all of X twice per
// evaluation from L1 (~230 kB at dim 100, n_data 256, 32 K coordinates a
// row in the backward product), so the L1 load rate, not device memory or
// the f32 units, sets the time. This warp-per-chain form serves kernel 1's
// scaled and bridged variants (1b, 1c); kernels 1 (1d, and 1a's data form),
// 2 (2b, either metric), 3 (3a) and 4 (4c, and 4b's data form) evaluate the
// posterior for a block of chains at once, each X load shared by the
// block's chains (tiled_step.cuh:TiledHierarchical, the same sums in the
// same order; 3a's in kernel 3's lane groups).
// Products are rounded before their sums (__fmul_rn / __fadd_rn) in the
// plain version's order (ops/padded_targets.py:_hierarchical_logistic), as
// the correlated Gaussian's are. X's zero column 0 makes the likelihood's
// share of tau's gradient 0; tau's gradient is the prior's alone.
// The warp-per-chain layout (G = 32, lane j holds coordinates j + 32 r).
// X and y are read with __ldg from device memory: 100 kB at dim 100, n_data
// 256, which every chain reads, so they stay in L1 and L2.
template <int K, int G, bool LAYOUT>
struct Target<HIERARCHICAL_LOGISTIC, K, G, LAYOUT> {
  const float *X, *xt, *y;
  int n_data, dim;
  float half_p;
  __device__ explicit Target(int dim_, const TargetParams&, const TargetData& data)
      : X(data.X), xt(data.xt), y(data.y), n_data(data.n_data), dim(dim_),
        half_p(0.5f * static_cast<float>(dim_ - 1)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    static_assert(G == 32 && !LAYOUT, "the warp-per-chain layout (3a runs tiled)");
    // this warp's staging row: 32 K floats
    __shared__ __align__(16) float rows[TARGET_MAX_WARPS][32 * K];
    float* row = rows[threadIdx.x >> 5];
#pragma unroll
    for (int r = 0; r < K; ++r) row[lane + 32 * r] = q[r];  // zeros past dim
    __syncwarp();

    float gl[K];
#pragma unroll
    for (int r = 0; r < K; ++r) gl[r] = 0.f;
    float lik = 0.f;
    for (int c0 = 0; c0 < n_data; c0 += 32) {
      const int n = c0 + lane;
      float resid = 0.f;
      if (n < n_data) {
        const float* col = xt + n;
        float z = 0.f;
        for (int d = 0; d < dim; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(row + d);
          z = __fadd_rn(z, __fmul_rn(__ldg(col + static_cast<size_t>(d) * n_data), qv.x));
          if (d + 1 < dim)
            z = __fadd_rn(z, __fmul_rn(__ldg(col + static_cast<size_t>(d + 1) * n_data), qv.y));
          if (d + 2 < dim)
            z = __fadd_rn(z, __fmul_rn(__ldg(col + static_cast<size_t>(d + 2) * n_data), qv.z));
          if (d + 3 < dim)
            z = __fadd_rn(z, __fmul_rn(__ldg(col + static_cast<size_t>(d + 3) * n_data), qv.w));
        }
        const float e = expf(-fabsf(z));
        const float yn = __ldg(y + n);
        const float softplus = __fadd_rn(fmaxf(z, 0.f), log1pf(e));
        lik = __fadd_rn(lik, __fsub_rn(__fmul_rn(yn, z), softplus));
        const float denom = 1.f + e;
        resid = __fsub_rn(yn, z >= 0.f ? __fdiv_rn(1.f, denom) : __fdiv_rn(e, denom));
      }
      for (int k = 0; k < 32 && c0 + k < n_data; ++k) {  // uniform across the warp
        const float rk = __shfl_sync(FULL_MASK, resid, k, 32);
        const float* xr = X + static_cast<size_t>(c0 + k) * dim;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int d = lane + 32 * r;
          if (d < dim) gl[r] = __fadd_rn(gl[r], __fmul_rn(__ldg(xr + d), rk));
        }
      }
    }
    __syncwarp();  // every lane has read the staging row

    const float tau = __shfl_sync(FULL_MASK, q[0], 0, 32);
    const float inv_scale = expf(-tau);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float v = lane + 32 * r == 0 ? 0.f : q[r];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    const float shrink = __fmul_rn(__fmul_rn(0.5f, inv_scale), group_sum<32>(s));
    float lp = __fsub_rn(group_sum<32>(lik), shrink);
    lp = __fsub_rn(lp, __fmul_rn(half_p, tau));
    lp = __fsub_rn(lp, __fmul_rn(__fmul_rn(0.5f, tau), tau));
    const float g_tau = __fsub_rn(__fsub_rn(shrink, half_p), tau);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      g[r] = lane + 32 * r == 0 ? g_tau : __fsub_rn(gl[r], __fmul_rn(q[r], inv_scale));
    }
    return lp;
  }
};

// Neal's funnel, non-centered: N(0, diag(9, 1, ..., 1)), the funnel's
// curvature left to funnel_transform. siv = q / var (1/9 on coordinate 0),
// grad = -siv, lp = -0.5 (siv . q + log 9 + D log 2pi). Params: the
// constant.
template <int K, int G, bool BLOCKED>
struct Target<NEALS_FUNNEL_NONCENTERED, K, G, BLOCKED> {
  float c;
  __device__ explicit Target(int, const TargetParams& p, const TargetData& = TargetData{})
      : c(p.v[0]) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float siv = coord_of<K, G, BLOCKED>(lane, r) == 0 ? __fmul_rn(q[r], 1.f / 9.f) : q[r];
      s = __fadd_rn(s, __fmul_rn(siv, q[r]));
      g[r] = -siv;
    }
    if (!with_lp) return 0.f;
    return -0.5f * (group_sum<G>(s) + c);
  }
};

// Ill-conditioned Gaussian, N(0, diag(linspace(1, kappa, D))): eig_i = 1 +
// slope i in float32 from the integer i, siv = q / eig (0 past dim), grad =
// -siv, lp = -0.5 (siv . q + log|Sigma| + D log 2pi). Params: slope and the
// constant.
template <int K, int G, bool BLOCKED>
struct Target<ILL_CONDITIONED_GAUSSIAN, K, G, BLOCKED> {
  float slope, c;
  int dim;
  __device__ explicit Target(int dim_, const TargetParams& p, const TargetData& = TargetData{})
      : slope(p.v[0]), c(p.v[1]), dim(dim_) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = coord_of<K, G, BLOCKED>(lane, r);
      const float eig = __fadd_rn(1.f, __fmul_rn(static_cast<float>(i), slope));
      const float siv = i < dim ? __fmul_rn(q[r], __fdiv_rn(1.f, eig)) : 0.f;
      s = __fadd_rn(s, __fmul_rn(siv, q[r]));
      g[r] = -siv;
    }
    if (!with_lp) return 0.f;
    return -0.5f * (group_sum<G>(s) + c);
  }
};

// Independent Student-t(df): lp = D log_norm - (df + 1) / 2 sum log1p(q^2 /
// df), grad = -(df + 1) q / (df + q^2), in the plain version's order (one
// log1pf and one division each per coordinate). Zeros past dim add 0 to
// both. Params: df, (df + 1) / 2, D log_norm, -(df + 1).
template <int K, int G, bool BLOCKED>
struct Target<STUDENT_T, K, G, BLOCKED> {
  float df, half_df1, c, neg_df1;
  __device__ explicit Target(int, const TargetParams& p, const TargetData& = TargetData{})
      : df(p.v[0]), half_df1(p.v[1]), c(p.v[2]), neg_df1(p.v[3]) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int /*lane*/, bool with_lp = true) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float x2 = __fmul_rn(q[r], q[r]);
      s = __fadd_rn(s, log1pf(__fdiv_rn(x2, df)));
      g[r] = __fdiv_rn(__fmul_rn(neg_df1, q[r]), __fadd_rn(df, x2));
    }
    if (!with_lp) return 0.f;
    return __fsub_rn(c, __fmul_rn(half_df1, group_sum<G>(s)));
  }
};

// Independent Gamma(shape, rate) on x > 0: per coordinate (shape - 1)
// log max(x, 1e-10) - rate x - log Z, gradient (shape - 1) / max(x, 1e-10)
// (0 at x <= 1e-10) - rate. Any real coordinate <= 0 makes lp -inf and the
// whole gradient 0; the coordinates past dim (zeros) are left out of both
// the sum and that test. A -inf lp makes the kernels' energy non-finite, so
// the guard rejects the proposal as the plain version's does. Params:
// shape - 1, rate, log Z.
template <int K, int G, bool BLOCKED>
struct Target<LOG_GAMMA, K, G, BLOCKED> {
  float sm1, rate, log_norm;
  int dim;
  __device__ explicit Target(int dim_, const TargetParams& p, const TargetData& = TargetData{})
      : sm1(p.v[0]), rate(p.v[1]), log_norm(p.v[2]), dim(dim_) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    constexpr float EPS = 1e-10f;
    float s = 0.f, bad = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      g[r] = 0.f;
      if (coord_of<K, G, BLOCKED>(lane, r) >= dim) continue;
      const float qc = fmaxf(q[r], EPS);
      const float term =
          __fsub_rn(__fsub_rn(__fmul_rn(sm1, logf(qc)), __fmul_rn(rate, q[r])), log_norm);
      s = __fadd_rn(s, term);
      bad += q[r] > 0.f ? 0.f : 1.f;
      g[r] = __fsub_rn(__fmul_rn(sm1, q[r] > EPS ? __fdiv_rn(1.f, qc) : 0.f), rate);
    }
    const float lp = with_lp ? group_sum<G>(s) : 0.f;
    if (group_sum<G>(bad) > 0.f) {
#pragma unroll
      for (int r = 0; r < K; ++r) g[r] = 0.f;
      return -INFINITY;
    }
    return lp;
  }
};

// expGamma, log-gamma's log-transformed form on R^D: per coordinate shape y
// - rate e^y, gradient shape - rate e^y, lp the sum less D log Z. A zero
// past dim would add -rate and a gradient shape - rate, so those
// coordinates are masked. Params: shape, rate, D log Z.
template <int K, int G, bool BLOCKED>
struct Target<LOG_GAMMA_UNCONSTRAINED, K, G, BLOCKED> {
  float shape, rate, c;
  int dim;
  __device__ explicit Target(int dim_, const TargetParams& p, const TargetData& = TargetData{})
      : shape(p.v[0]), rate(p.v[1]), c(p.v[2]), dim(dim_) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      g[r] = 0.f;
      if (coord_of<K, G, BLOCKED>(lane, r) >= dim) continue;
      const float rey = __fmul_rn(rate, expf(q[r]));
      s = __fadd_rn(s, __fsub_rn(__fmul_rn(shape, q[r]), rey));
      g[r] = __fsub_rn(shape, rey);
    }
    if (!with_lp) return 0.f;
    return __fsub_rn(group_sum<G>(s), c);
  }
};

// The sign of x as jnp.sign gives it: 0 at 0 (never copysignf's +-1).
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// Rosenbrock: lp = -sum_{i < D-1} [(1 - q_i)^2 + a (q_{i+1} - q_i^2)^2],
// grad_i = -[-2 (1 - q_i) - 4 a q_i r_i] (i < D - 1) - 2 a r_{i-1} (i > 0)
// with r_i = q_{i+1} - q_i^2. The first functor that couples neighbouring
// coordinates: each lane needs q_{i+1} of its coordinates and r_{i-1}.
// Warp-per-chain layout (coordinate lane + 32 r): coordinate i + 1 is
// lane + 1's register r, lane 31's is lane 0's register r + 1
// (__shfl_down_sync, then lane 31 from lane 0); r_{i-1} is lane - 1's
// register r, lane 0's is lane 31's register r - 1 (__shfl_up_sync).
// Kernel 3's lane groups (coordinate K lane + r): registers 0..K-2 find
// their neighbour in the lane, register K-1 reads the next lane's register
// 0 with __shfl_down_sync over the group's width G, and register 0 takes
// r_{i-1} from the previous lane's register K-1 with __shfl_up_sync. At
// every G (1 included) the group's last coordinate, K G - 1 >= dim - 1, has
// no pair, so the value a shuffle returns past the group is never used.
// Pairs past dim - 1 contribute nothing (the plain version's pair mask).
// Params: a = 1 / scale^2, 2 a, 4 a.
template <int K, int G, bool BLOCKED>
struct Target<ROSENBROCK, K, G, BLOCKED> {
  float a, a2, a4;
  int dim;
  __device__ explicit Target(int dim_, const TargetParams& p, const TargetData& = TargetData{})
      : a(p.v[0]), a2(p.v[1]), a4(p.v[2]), dim(dim_) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    float nxt[K];  // q_{i+1} of each register's coordinate i
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if constexpr (BLOCKED) {
        nxt[r] = r + 1 < K ? q[r + 1 < K ? r + 1 : r] : __shfl_down_sync(FULL_MASK, q[0], 1, G);
      } else {
        const float down = __shfl_down_sync(FULL_MASK, q[r], 1);
        const float wrap = __shfl_sync(FULL_MASK, r + 1 < K ? q[r + 1 < K ? r + 1 : r] : 0.f, 0);
        nxt[r] = lane == 31 ? wrap : down;
      }
    }
    float s = 0.f, resid[K], fwd[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      resid[r] = 0.f;
      fwd[r] = 0.f;
      if (coord_of<K, G, BLOCKED>(lane, r) < dim - 1) {
        resid[r] = __fsub_rn(nxt[r], __fmul_rn(q[r], q[r]));
        const float om = __fsub_rn(1.f, q[r]);
        s = __fadd_rn(s, __fadd_rn(__fmul_rn(om, om), __fmul_rn(__fmul_rn(a, resid[r]), resid[r])));
        fwd[r] = __fsub_rn(__fmul_rn(-2.f, om), __fmul_rn(__fmul_rn(a4, q[r]), resid[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float prev;  // r_{i-1}, 0 at coordinate 0
      if constexpr (BLOCKED) {
        const float up = __shfl_up_sync(FULL_MASK, resid[K - 1], 1, G);
        prev = r > 0 ? resid[r > 0 ? r - 1 : 0] : (lane == 0 ? 0.f : up);
      } else {
        const float up = __shfl_up_sync(FULL_MASK, resid[r], 1);
        const float wrap = __shfl_sync(FULL_MASK, r > 0 ? resid[r > 0 ? r - 1 : 0] : 0.f, 31);
        prev = lane == 0 ? wrap : up;
      }
      g[r] = -__fadd_rn(fwd[r], __fmul_rn(a2, prev));
    }
    if (!with_lp) return 0.f;
    return -group_sum<G>(s);
  }
};

// The RAHMC paper's bimodal funnel on R^2: v ~ (N(mu, s^2) + N(-mu, s^2)) / 2,
// x | v ~ N(0, c e^v). v and x are coordinates 0 and 1 (registers 0 of
// lanes 0 and 1 in the warp-per-chain layout, registers 0 and 1 of lane 0 in
// the lane groups), broadcast with __shfl_sync; every other gradient entry
// is 0. Params: mu, s^2, c, log(1/2) - log(2 pi s^2) / 2, log(2 pi c).
template <int K, int G, bool BLOCKED>
struct Target<MULTIMODAL_FUNNEL_2D, K, G, BLOCKED> {
  float mu, sig2, c, log_norm_prior, log_2pi_c;
  __device__ explicit Target(int, const TargetParams& p, const TargetData& = TargetData{})
      : mu(p.v[0]), sig2(p.v[1]), c(p.v[2]), log_norm_prior(p.v[3]), log_2pi_c(p.v[4]) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    // coordinate 1: lane 0's register 1, or lane 1's register 0
    constexpr int R1 = BLOCKED && K > 1 ? 1 : 0;
    const float v = __shfl_sync(FULL_MASK, q[0], 0, G);
    const float x = __shfl_sync(FULL_MASK, q[R1], R1 == 1 ? 0 : 1, G);
    const float dm = __fsub_rn(v, mu), dp = __fadd_rn(v, mu);
    const float a1 = __fdiv_rn(__fmul_rn(-0.5f, __fmul_rn(dm, dm)), sig2);
    const float a2 = __fdiv_rn(__fmul_rn(-0.5f, __fmul_rn(dp, dp)), sig2);
    const float mx = fmaxf(a1, a2);
    const float e1 = expf(__fsub_rn(a1, mx));
    const float e2 = expf(__fsub_rn(a2, mx));
    const float lse = __fadd_rn(e1, e2);
    const float log_prior = __fadd_rn(__fadd_rn(log_norm_prior, mx), logf(lse));
    const float inv_var = __fdiv_rn(expf(-v), c);
    const float log_cond =
        __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(x, x), inv_var), v), log_2pi_c));
    const float w1 = __fdiv_rn(e1, lse), w2 = __fdiv_rn(e2, lse);
    const float gv = __fsub_rn(
        __fadd_rn(__fdiv_rn(-__fadd_rn(__fmul_rn(w1, dm), __fmul_rn(w2, dp)), sig2),
                  __fmul_rn(__fmul_rn(__fmul_rn(0.5f, x), x), inv_var)),
        0.5f);
    const float gx = __fmul_rn(-x, inv_var);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = coord_of<K, G, BLOCKED>(lane, r);
      g[r] = i == 0 ? gv : (i == 1 ? gx : 0.f);
    }
    if (!with_lp) return 0.f;
    return __fadd_rn(log_prior, log_cond);
  }
};

// One L1 shell's log-weight and its d/du: -(u - r)^2 / (2 s^2) and
// -(u - r) / s^2, rounded as the plain version's (ops/padded_targets.py).
__device__ __forceinline__ float shell_term(float u, float r, float sig2) {
  const float d = __fsub_rn(u, r);
  return __fdiv_rn(__fmul_rn(-0.5f, __fmul_rn(d, d)), sig2);
}
__device__ __forceinline__ float shell_slope(float u, float r, float sig2) {
  return __fdiv_rn(-__fsub_rn(u, r), sig2);
}

// The L1 families' shells spread over a warp (the warp-per-chain layout, G
// = 32): lanes SHELL_LANES k .. SHELL_LANES k + 3 compute shell k, so the
// shells' divisions and expf run once, side by side, instead of one shell
// after another. At 1,024 chains (~8 warps an SM) a kernel waits on each
// chain's dependent stream, and the shells in sequence were its longest
// part: on an H100 kernel 4's window at 1,024 x 2 took 4.18 us a
// chain-leapfrog on the nested shells and 1.96 on the concentric ones (N(0,
// I) 0.69), and with the shells over the lanes 1.92 and 1.32; the shells
// in sequence without branches (every shell computed, selects) 3.64 and
// 1.93, the axes computed once alone 4.00 (PERF.md section 6). Kernel 3's
// lane groups (G < 32) keep the shells in sequence.
constexpr int SHELL_LANES = 32 / MAX_SHELLS;
template <int G, bool BLOCKED>
constexpr bool LANE_SHELLS = G == 32 && !BLOCKED;

// x[k] for a k known only at run time, by selects: a register array indexed
// at run time would live in local memory.
__device__ __forceinline__ float pick_shell(const float (&x)[MAX_SHELLS], int k) {
  float v = x[0];
#pragma unroll
  for (int j = 1; j < MAX_SHELLS; ++j) v = k == j ? x[j] : v;
  return v;
}

// The shells' logsumexp pieces on this lane's shell k = lane / SHELL_LANES,
// whose value of u is `u`: returns the max of the valid shells' terms on
// every lane (the plain version's max: fmaxf ignores the NaN that masks a
// shell past n, and every term is -0 or below, so the order of the maxima
// changes no bit) and sets e = exp(term - max) and the slope of this lane's
// shell.
__device__ __forceinline__ float lane_shell(float u, float radius, float sig2, bool valid,
                                            float& e, float& slope) {
  const float t = shell_term(u, radius, sig2);
  slope = shell_slope(u, radius, sig2);
  float mx = valid ? t : NAN;
#pragma unroll
  for (int offset = SHELL_LANES; offset < 32; offset <<= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, offset));
  }
  e = expf(__fsub_rn(t, mx));
  return mx;
}

// Shell j's value of x, read from its first lane (every lane gets it).
__device__ __forceinline__ float shell_value(float x, int j) {
  return __shfl_sync(FULL_MASK, x, j * SHELL_LANES);
}

// Eight warp sums at once, s[k] this lane's share of shell k's: returns
// shell lane / SHELL_LANES's total. Each of the first three levels of the
// butterfly sends half of a lane's sums to its partner and keeps the other
// half, so 4 + 2 + 1 + 1 + 1 shuffles do what eight group_sums' 40 do. Each
// shell's sum is group_sum's tree, level for level (offsets 16, 8, 4, 2, 1),
// so the totals are group_sum's bits.
__device__ __forceinline__ float shell_sums(const float (&s)[MAX_SHELLS], int lane) {
  static_assert(MAX_SHELLS == 8 && SHELL_LANES == 4, "three halving levels");
  float s4[4], s2[2];
  const bool hi16 = (lane & 16) != 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = hi16 ? s[j] : s[4 + j];
    s4[j] = __fadd_rn(hi16 ? s[4 + j] : s[j], __shfl_xor_sync(FULL_MASK, send, 16));
  }
  const bool hi8 = (lane & 8) != 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = hi8 ? s4[j] : s4[2 + j];
    s2[j] = __fadd_rn(hi8 ? s4[2 + j] : s4[j], __shfl_xor_sync(FULL_MASK, send, 8));
  }
  const bool hi4 = (lane & 4) != 0;
  float s1 = __fadd_rn(hi4 ? s2[1] : s2[0], __shfl_xor_sync(FULL_MASK, hi4 ? s2[0] : s2[1], 4));
  s1 = __fadd_rn(s1, __shfl_xor_sync(FULL_MASK, s1, 2));
  return __fadd_rn(s1, __shfl_xor_sync(FULL_MASK, s1, 1));
}

// Concentric L1 shells: p ∝ sum_k exp(-(|q|_1 - r_k)^2 / (2 s^2)). One
// group sum for u = |q|_1, then the shells' logsumexp in the JAX builder's
// order (the max, the exps, their sum), lp = max + log(sum), and grad =
// (sum_k e_k (-(u - r_k) / s^2)) / sum * sign(q), the sign 0 at 0. Up to
// MAX_SHELLS shells from the params (`shell`, `n_shells`); a shell past
// n_shells is masked by a select. In the warp-per-chain layout the shells'
// terms, slopes and exps are spread over the lanes (LANE_SHELLS) and the
// sums gathered in shell order. Params: s^2.
template <int K, int G, bool BLOCKED>
struct Target<CONCENTRIC_L1, K, G, BLOCKED> {
  float sig2;
  float radius[MAX_SHELLS];
  int n;
  __device__ explicit Target(int, const TargetParams& p, const TargetData& = TargetData{})
      : sig2(p.v[0]), n(p.n_shells) {
#pragma unroll
    for (int k = 0; k < MAX_SHELLS; ++k) radius[k] = p.shell[k];
  }

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s = __fadd_rn(s, fabsf(q[r]));
    const float u = group_sum<G>(s);
    float mx, lse = 0.f, du = 0.f;
    if constexpr (LANE_SHELLS<G, BLOCKED>) {
      const int k = lane / SHELL_LANES;
      float e, slope;
      mx = lane_shell(u, pick_shell(radius, k), sig2, k < n, e, slope);
      const float term = __fmul_rn(e, slope);
#pragma unroll
      for (int j = 0; j < MAX_SHELLS; ++j) {
        const float ej = shell_value(e, j), tj = shell_value(term, j);
        lse = j < n ? __fadd_rn(lse, ej) : lse;
        du = j < n ? __fadd_rn(du, tj) : du;
      }
    } else {
      mx = shell_term(u, radius[0], sig2);
#pragma unroll
      for (int k = 1; k < MAX_SHELLS; ++k) {
        if (k < n) mx = fmaxf(mx, shell_term(u, radius[k], sig2));
      }
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        if (k < n) {
          const float e = expf(__fsub_rn(shell_term(u, radius[k], sig2), mx));
          lse = __fadd_rn(lse, e);
          du = __fadd_rn(du, __fmul_rn(e, shell_slope(u, radius[k], sig2)));
        }
      }
    }
    const float coef = __fdiv_rn(du, lse);
#pragma unroll
    for (int r = 0; r < K; ++r) g[r] = __fmul_rn(coef, sign_of(q[r]));
    if (!with_lp) return 0.f;
    return __fadd_rn(mx, logf(lse));
  }
};

// Nested L1 shells: an outer shell of radius r_outer about the origin and
// n_inner shells of radius r_inner about the axis points c_k (k = 1 ..
// n_inner), whose one nonzero coordinate is axis (k - 1) / 2 % dim with
// +mu_norm for odd k and -mu_norm for even k. n_inner + 1 group sums u_k =
// |q - c_k|_1, the shells' logsumexp in the JAX builder's order, and grad =
// (sum_k e_k (-(u_k - r_k) / s^2) sign(q - c_k)) / sum. Shell k's radius is
// shell[k] (r_outer, then r_inner n_inner times), n_shells = n_inner + 1 <=
// MAX_SHELLS. The axes are computed once, with the functor. In the
// warp-per-chain layout the MAX_SHELLS sums run at once (shell_sums) and
// the shells' terms, slopes and exps are spread over the lanes
// (LANE_SHELLS); a shell past n_shells is masked by a select. Params: s^2,
// mu_norm.
template <int K, int G, bool BLOCKED>
struct Target<NESTED_L1, K, G, BLOCKED> {
  float sig2, mu;
  float radius[MAX_SHELLS];
  int axis[MAX_SHELLS / 2];  // j % dim: the axis of shells 2 j + 1 and 2 j + 2
  int n;
  __device__ explicit Target(int dim, const TargetParams& p, const TargetData& = TargetData{})
      : sig2(p.v[0]), mu(p.v[1]), n(p.n_shells) {
#pragma unroll
    for (int k = 0; k < MAX_SHELLS; ++k) radius[k] = p.shell[k];
#pragma unroll
    for (int j = 0; j < MAX_SHELLS / 2; ++j) axis[j] = j % dim;
  }

  // q - c_k at coordinate i
  __device__ __forceinline__ float diff(float qi, int i, int k) const {
    if (k == 0 || i != axis[(k - 1) / 2]) return qi;
    return __fsub_rn(qi, (k - 1) % 2 == 0 ? mu : -mu);
  }

  // |q - c_k|_1 of this lane's coordinates
  __device__ __forceinline__ float partial(const float (&q)[K], int lane, int k) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      s = __fadd_rn(s, fabsf(diff(q[r], coord_of<K, G, BLOCKED>(lane, r), k)));
    }
    return s;
  }

  // g += coef sign(q - c_k)
  __device__ __forceinline__ void add_grad(const float (&q)[K], float (&g)[K], int lane, int k,
                                           float coef, bool valid) const {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = coord_of<K, G, BLOCKED>(lane, r);
      const float gk = __fadd_rn(g[r], __fmul_rn(coef, sign_of(diff(q[r], i, k))));
      g[r] = valid ? gk : g[r];
    }
  }

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane, bool with_lp = true) const {
    float mx, lse = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) g[r] = 0.f;
    if constexpr (LANE_SHELLS<G, BLOCKED>) {
      float s[MAX_SHELLS];
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) s[k] = partial(q, lane, k);
      const int k = lane / SHELL_LANES;
      float e, slope;
      mx = lane_shell(shell_sums(s, lane), pick_shell(radius, k), sig2, k < n, e, slope);
      const float coef = __fmul_rn(e, slope);
#pragma unroll
      for (int j = 0; j < MAX_SHELLS; ++j) {
        const float ej = shell_value(e, j);
        lse = j < n ? __fadd_rn(lse, ej) : lse;
        add_grad(q, g, lane, j, shell_value(coef, j), j < n);
      }
    } else {
      float u[MAX_SHELLS];
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        u[k] = 0.f;
        if (k < n) u[k] = group_sum<G>(partial(q, lane, k));
      }
      mx = shell_term(u[0], radius[0], sig2);
#pragma unroll
      for (int k = 1; k < MAX_SHELLS; ++k) {
        if (k < n) mx = fmaxf(mx, shell_term(u[k], radius[k], sig2));
      }
#pragma unroll
      for (int k = 0; k < MAX_SHELLS; ++k) {
        if (k < n) {
          const float e = expf(__fsub_rn(shell_term(u[k], radius[k], sig2), mx));
          lse = __fadd_rn(lse, e);
          add_grad(q, g, lane, k, __fmul_rn(e, shell_slope(u[k], radius[k], sig2)), true);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < K; ++r) g[r] = __fdiv_rn(g[r], lse);
    if (!with_lp) return 0.f;
    return __fadd_rn(mx, logf(lse));
  }
};

}  // namespace mcmc
