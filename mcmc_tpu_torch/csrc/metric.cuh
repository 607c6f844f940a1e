// The kinetic-energy metric of the warp-per-chain kernels: lane j holds
// coordinates j, j+32, ... (K registers) of a chain's momentum, or, in
// kernel 1's and 1b's lane groups of G lanes, j, j+G, ... (DiagMetric's G).
//
// Replaces mcmc_tpu/ops/fused_trajectory.py:_metric_ops and the dense
// unwhitening of unwhiten_op: velocity v = M^{-1} p, kinetic energy
// 0.5 p . v, and the momentum p ~ N(0, M) from standard normals z. The
// plain PyTorch versions are samplers/trajectory.py:velocity and
// kinetic_energy and the unwhitening of samplers/nuts_persistent.py:
// _machine_iteration, term for term.
//
// DiagMetric keeps the diagonal of M^{-1} in registers. DenseMetric reads
// M^{-1} and L^{-1} (M^{-1} = L L^T) from shared memory, where the block
// loads them once (load_dense_metric), and computes each row-vector-matrix
// product x @ A by writing x to a per-warp shared row; lane j then sums
// x[i] A[i][d] over i for its coordinates d = j + 32 r. This warp-per-chain
// DenseMetric serves kernel 2a, kernel 4's 4b and 4a+4b and the dense
// forms of 1b and 1c; kernel 1's dense variant 1a, and 1a's and 4b's data
// forms, compute the same sums for a block of chains at once
// (tiled_step.cuh:TiledDenseMetric). Lanes read
// consecutive words of A's row i, so the reads are free of bank conflicts,
// and x[i] is a broadcast. The products are this body's own, as the TPU
// kernel's MXU matmuls were; no library is called. The sum runs over i in
// order with each product rounded before it is added (no FMA contraction):
// an ill-conditioned M^{-1} (the oracle metric of the rho = 0.9 Gaussian
// has condition number 451) makes these sums cancel, so their rounding
// grows along a trajectory, and this order is the one the plain version
// (samplers/trajectory.py:ordered_matmul) repeats bit for bit.
//
// What bounds a product on an H100 is shared memory, not the chain of D
// dependent adds: a lane reads one word of A per multiply-add, and S
// interleaved partial sums did not make the products faster at a fixed
// occupancy (PERF.md section 6, experiments/torch_dense_product_timing.py).
// So at K >= 2 the loop over i is outside the loop over the K registers:
// one 16-byte broadcast load of the row serves four i and all K outputs,
// where a loop over the registers outside read row[i] once a term and
// register. At K = 1 nothing is shared, and the plain loop over i stays
// (the four-term steps were slower there). Every output keeps its order,
// so the products are the same bits either way.
//
// Kernels 1, 2 (fused_trajectory.cu) and 4 (nuts_window.cuh) take the metric
// as a template flag DENSE: Metric<K, DENSE> is the type (the block-tiled
// kernels 1a, 1d, 4b and 4c take tiled_step.cuh:TileMetric), make_metric builds
// it (the dense one after the block has loaded its shared memory), and
// add_scaled<DENSE> is the leapfrog's y + a x, rounded as the dense
// variants need.
#pragma once

#include <cstddef>
#include <type_traits>
#include <cuda_runtime.h>

#include "targets.cuh"

namespace mcmc {

// y + a x. ROUNDED rounds the product before the sum, as the plain
// version's separate tensor operations do; otherwise nvcc may contract it
// to an FMA. The dense variants need the rounded form: under an
// ill-conditioned M^{-1} a rounding difference grows along the trajectory.
template <bool ROUNDED>
__device__ __forceinline__ float add_scaled(float y, float a, float x) {
  if constexpr (ROUNDED) {
    return __fadd_rn(y, __fmul_rn(a, x));
  } else {
    return y + a * x;
  }
}

// A warp's place in a block-wide product over the chains that are live in
// it (the tiled persistent-NUTS window, nuts_window.cuh): `col`, this
// chain's column among them in warp order, -1 when its chain is not live;
// `n`, their count. tiled_step.cuh:live_tile computes it.
struct LiveTile {
  int col, n;
};

// `lane` is the lane's place in its group of G lanes.
template <int K, int G = 32>
struct DiagMetric {
  static constexpr bool DENSE = false;
  float invm[K];

  __device__ DiagMetric(const float* inv_mass, int lane, int dim) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = lane + G * r;
      invm[r] = d < dim ? inv_mass[d] : 1.f;
    }
  }

  __device__ __forceinline__ void velocity(const float (&p)[K], float (&v)[K]) const {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = p[r] * invm[r];
  }

  // 0.5 p . M^{-1} p; every lane of the group gets it.
  __device__ __forceinline__ float kinetic(const float (&p)[K]) const {
    return 0.5f * chain_sum<K, G, false>(
                      [&](float s, int r) { return s + p[r] * (p[r] * invm[r]); });
  }

  // z -> z / sqrt(M^{-1}), in place.
  __device__ __forceinline__ void unwhiten(float (&z)[K]) const {
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = z[r] / sqrtf(invm[r]);
  }

  // The interface of tiled_step.cuh:TiledDenseMetric's live-chain products,
  // which every warp calls: per chain here, so a chain that is not live
  // skips them.
  __device__ __forceinline__ void velocity(const float (&p)[K], float (&v)[K],
                                           const LiveTile& t) const {
    if (t.col >= 0) velocity(p, v);
  }
  __device__ __forceinline__ float kinetic(const float (&p)[K], const LiveTile& t) const {
    return t.col >= 0 ? kinetic(p) : 0.f;
  }
  __device__ __forceinline__ void unwhiten(float (&z)[K], const LiveTile& t) const {
    if (t.col >= 0) unwhiten(z);
  }
};

// Copy the (dim, dim) M^{-1} and L^{-1} into the block's shared memory:
// smem[0, dim^2) and smem[dim^2, 2 dim^2). Every thread of the block must
// call it; it ends with __syncthreads().
__device__ __forceinline__ void load_dense_metric(float* smem, const float* inv_mass,
                                                  const float* l_inv, int dim) {
  const int n = dim * dim;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    smem[i] = inv_mass[i];
    smem[n + i] = l_inv[i];
  }
  __syncthreads();
}

// Floats of the dense metric's shared memory before the warps' rows:
// M^{-1} and L^{-1}, rounded up to 4 so that each row starts on 16 bytes.
__host__ __device__ constexpr size_t dense_rows_at(int dim) {
  return (2 * static_cast<size_t>(dim) * dim + 3) & ~static_cast<size_t>(3);
}

template <int K>
struct DenseMetric {
  static constexpr bool DENSE = true;
  const float* minv;  // shared (dim, dim) M^{-1}, symmetric
  const float* linv;  // shared (dim, dim) L^{-1}, row-major
  float* row;         // this warp's shared row of 32 K floats, on 16 bytes
  int dim, lane;

  // out = x @ A for a (dim, dim) row-major A in shared memory; zeros past
  // dim. All 32 lanes take part. LOWER: A is lower triangular, so column d
  // sums from row i = d; the terms skipped are +-0 and leave the rounded sum
  // of the full order (the plain version's) unchanged. Each sum starts from
  // -0, so its first term enters unrounded.
  template <bool LOWER = false>
  __device__ __forceinline__ void row_times(const float (&x)[K], const float* A,
                                            float (&out)[K]) const {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = lane + 32 * r;
      if (d < dim) row[d] = x[r];
    }
    __syncwarp();
    float acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = -0.f;
    if constexpr (K == 1) {
      // one register: no row load to share between registers, and the
      // four-term steps below made these products slower (D <= 32)
      if (lane < dim) {
        const int i0 = LOWER ? lane : 0;
        acc[0] = __fmul_rn(row[i0], A[i0 * dim + lane]);
        for (int i = i0 + 1; i < dim; ++i) {
          acc[0] = __fadd_rn(acc[0], __fmul_rn(row[i], A[i * dim + lane]));
        }
      }
    } else {
      // four terms a step, from a multiple of 4; under LOWER this lane's
      // first term is i = lane, its smallest column
      const int first = LOWER ? lane : 0;
      int ib = first & ~3;
      for (; ib + 4 <= dim; ib += 4) terms<LOWER, false>(ib, A, acc);
      if (ib < dim) terms<LOWER, true>(ib, A, acc);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) out[r] = lane + 32 * r < dim ? acc[r] : 0.f;
    __syncwarp();
  }

  // Terms i = ib .. ib + 3 of every register's sum (TAIL: those below dim),
  // the row's four entries in one broadcast load.
  template <bool LOWER, bool TAIL>
  __device__ __forceinline__ void terms(int ib, const float* A, float (&acc)[K]) const {
    const float4 x4 = *reinterpret_cast<const float4*>(row + ib);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = ib + j;
      if (TAIL && i >= dim) break;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int d = lane + 32 * r;
        if (d < dim && (!LOWER || i >= d)) {
          acc[r] = __fadd_rn(acc[r], __fmul_rn(xs[j], A[i * dim + d]));
        }
      }
    }
  }

  // M^{-1} p (= p @ M^{-1}, M^{-1} symmetric).
  __device__ __forceinline__ void velocity(const float (&p)[K], float (&v)[K]) const {
    row_times(p, minv, v);
  }

  __device__ __forceinline__ float kinetic(const float (&p)[K]) const {
    float v[K];
    velocity(p, v);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s += p[r] * v[r];
    return 0.5f * warp_sum(s);
  }

  // z -> z @ L^{-1}, in place: covariance L^{-T} L^{-1} = M. L^{-1} is
  // lower triangular (trajectory.dense_unwhitening).
  __device__ __forceinline__ void unwhiten(float (&z)[K]) const {
    float p[K];
    row_times<true>(z, linv, p);
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = p[r];
  }
};

template <int K, bool DENSE>
using Metric = typename std::conditional<DENSE, DenseMetric<K>, DiagMetric<K>>::type;

// Dynamic shared memory of a block of `warps` warp-per-chain chains under
// the dense metric: M^{-1}, L^{-1} and one row per warp (0 for diagonal).
template <int K, bool DENSE>
inline size_t metric_smem_bytes(int dim, int warps) {
  if (!DENSE) return 0;
  return (dense_rows_at(dim) + static_cast<size_t>(warps) * 32 * K) * sizeof(float);
}

// The chain's metric: inv_mass is (dim,) for the diagonal metric, (dim, dim)
// with its factor l_inv for the dense one. DENSE: the whole block loads
// M^{-1} and L^{-1} into `smem` (metric_smem_bytes), so every thread of the
// block must call this before any returns. `smem` lies on 16 bytes.
template <int K, bool DENSE>
__device__ __forceinline__ Metric<K, DENSE> make_metric(const float* inv_mass,
                                                        const float* l_inv, int dim,
                                                        float* smem, int warp, int lane) {
  if constexpr (DENSE) {
    const int n = dim * dim;
    load_dense_metric(smem, inv_mass, l_inv, dim);
    return DenseMetric<K>{smem, smem + n, smem + dense_rows_at(dim) + warp * 32 * K, dim, lane};
  } else {
    return DiagMetric<K>(inv_mass, lane, dim);
  }
}

}  // namespace mcmc
