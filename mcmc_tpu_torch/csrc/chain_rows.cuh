// Row access for the warp-per-chain layout of the GRAHMC and NUTS kernels:
// a chain's state is row `row` (= chain * dim) of a (C, D) row-major array,
// and lane j of the warp holds coordinates j, j+32, ... (K registers).
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace mcmc {

// Load this lane's coordinates of a row; zeros past dim.
template <int K>
__device__ __forceinline__ void load_row(const float* in, size_t row, int lane, int dim,
                                         float (&v)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    v[r] = d < dim ? in[row + d] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void store_row(float* out, size_t row, int lane, int dim,
                                          const float (&v)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    if (d < dim) out[row + d] = v[r];
  }
}

}  // namespace mcmc
