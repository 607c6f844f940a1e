// The kinetic-energy metric of the warp-per-chain kernels: lane j holds
// coordinates j, j+32, ... (K registers) of a chain's momentum.
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
// x[i] A[i][d] over i for its coordinates d = j + 32 r. Lanes read
// consecutive words of A's row i, so the reads are free of bank conflicts,
// and x[i] is a broadcast. The products are this body's own, as the TPU
// kernel's MXU matmuls were; no library is called. The sum runs over i in
// order with each product rounded before it is added (no FMA contraction):
// an ill-conditioned M^{-1} (the oracle metric of the rho = 0.9 Gaussian
// has condition number 451) makes these sums cancel, so their rounding
// grows along a trajectory, and this order is the one the plain version
// (samplers/trajectory.py:ordered_matmul) repeats bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "targets.cuh"

namespace mcmc {

template <int K>
struct DiagMetric {
  float invm[K];

  __device__ DiagMetric(const float* inv_mass, int lane, int dim) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = lane + 32 * r;
      invm[r] = d < dim ? inv_mass[d] : 1.f;
    }
  }

  __device__ __forceinline__ void velocity(const float (&p)[K], float (&v)[K]) const {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = p[r] * invm[r];
  }

  // 0.5 p . M^{-1} p; every lane gets it.
  __device__ __forceinline__ float kinetic(const float (&p)[K]) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s += p[r] * (p[r] * invm[r]);
    return 0.5f * warp_sum(s);
  }

  // z -> z / sqrt(M^{-1}), in place.
  __device__ __forceinline__ void unwhiten(float (&z)[K]) const {
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = z[r] / sqrtf(invm[r]);
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

template <int K>
struct DenseMetric {
  const float* minv;  // shared (dim, dim) M^{-1}, symmetric
  const float* linv;  // shared (dim, dim) L^{-1}, row-major
  float* row;         // this warp's shared row of 32 K floats
  int dim, lane;

  // out = x @ A for a (dim, dim) row-major A in shared memory; zeros past
  // dim. All 32 lanes take part.
  __device__ __forceinline__ void row_times(const float (&x)[K], const float* A,
                                            float (&out)[K]) const {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = lane + 32 * r;
      if (d < dim) row[d] = x[r];
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = lane + 32 * r;
      float acc = 0.f;
      if (d < dim) {
        acc = __fmul_rn(row[0], A[d]);
        for (int i = 1; i < dim; ++i) acc = __fadd_rn(acc, __fmul_rn(row[i], A[i * dim + d]));
      }
      out[r] = acc;
    }
    __syncwarp();
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

  // z -> z @ L^{-1}, in place: covariance L^{-T} L^{-1} = M.
  __device__ __forceinline__ void unwhiten(float (&z)[K]) const {
    float p[K];
    row_times(z, linv, p);
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = p[r];
  }
};

}  // namespace mcmc
