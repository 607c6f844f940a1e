// The warp-per-chain dense metric's products alone (csrc/metric.cuh:
// DenseMetric::row_times), for experiments/torch_dense_product_timing.py.
//
// One warp a chain, 8 warps a block, M^{-1} and L^{-1} in shared memory as
// kernel 4's warp window holds them (make_metric). Each chain runs a chain
// of `n_products` dependent products, x <- x + 1e-3 (x @ A), A = L^{-1}
// (the unwhitening, lower triangular) every `lower_every`-th product and
// M^{-1} (a velocity or kinetic energy) otherwise: the products a chain of
// 4b's window takes, without the rest of the machine. Two loop orders, each
// at S partial sums (partial s takes the terms i = s (mod S) in order, the
// partials joined pairwise): the loop over i outside the K registers, one
// 16-byte broadcast load of the row serving four i (or S) and all K
// outputs -- the tree's DenseMetric::row_times at S = 1, row_times_i_outer
// at S > 1 --, and row_times_r_outer, the loop over the registers outside,
// one row load a term and register (the window's order before the
// reorder). At one S both give every output the same sums in the same
// order.
//
// Build (the script does): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v -shared
// -I <tree>/mcmc_tpu_torch/csrc -o libdense_product_bench.so
// dense_product_bench.cu

#include <cuda_runtime.h>

#include "metric.cuh"

namespace bench {
using namespace mcmc;

constexpr int WARPS = 8;

// row_times with the loop over i outside the K registers, at S partial
// sums: term i goes to partial i % S, the steps of the loop start on
// multiples of STEP.
template <int S>
__device__ __forceinline__ float join(const float* a) {
  if constexpr (S == 1) {
    return a[0];
  } else {
    return __fadd_rn(join<S / 2>(a), join<S / 2>(a + S / 2));
  }
}

template <int K, int S, bool LOWER, bool TAIL>
__device__ __forceinline__ void terms(const DenseMetric<K>& m, int ib, const float* A,
                                      float (&acc)[K][S]) {
  constexpr int STEP = S > 4 ? S : 4;
  float xs[STEP];
#pragma unroll
  for (int v = 0; v < STEP; v += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(m.row + ib + v);
    xs[v] = x4.x, xs[v + 1] = x4.y, xs[v + 2] = x4.z, xs[v + 3] = x4.w;
  }
#pragma unroll
  for (int j = 0; j < STEP; ++j) {
    const int i = ib + j;
    if (TAIL && i >= m.dim) break;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = m.lane + 32 * r;
      if (d < m.dim && (!LOWER || i >= d)) {
        acc[r][j % S] = __fadd_rn(acc[r][j % S], __fmul_rn(xs[j], A[i * m.dim + d]));
      }
    }
  }
}

template <int K, int S, bool LOWER>
__device__ __forceinline__ void row_times_i_outer(const DenseMetric<K>& m, const float (&x)[K],
                                                  const float* A, float (&out)[K]) {
  constexpr int STEP = S > 4 ? S : 4;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = m.lane + 32 * r;
    if (d < m.dim) m.row[d] = x[r];
  }
  __syncwarp();
  float acc[K][S];
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int s = 0; s < S; ++s) acc[r][s] = -0.f;
  }
  const int first = LOWER ? m.lane : 0;
  int ib = first - first % STEP;
  for (; ib + STEP <= m.dim; ib += STEP) terms<K, S, LOWER, false>(m, ib, A, acc);
  if (ib < m.dim) terms<K, S, LOWER, true>(m, ib, A, acc);
#pragma unroll
  for (int r = 0; r < K; ++r) out[r] = m.lane + 32 * r < m.dim ? join<S>(acc[r]) : 0.f;
  __syncwarp();
}

// row_times with the loop over the K registers outside the loop over i.
template <int K, int S, bool LOWER>
__device__ __forceinline__ void row_times_r_outer(const DenseMetric<K>& m,
                                                  const float (&x)[K], const float* A,
                                                  float (&out)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = m.lane + 32 * r;
    if (d < m.dim) m.row[d] = x[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = m.lane + 32 * r;
    float res = 0.f;
    if (d < m.dim) {
      const int i0 = LOWER ? d : 0;
      if constexpr (S == 1) {
        // the window's row_times before this change, as it was written
        res = __fmul_rn(m.row[i0], A[i0 * m.dim + d]);
        for (int i = i0 + 1; i < m.dim; ++i) {
          res = __fadd_rn(res, __fmul_rn(m.row[i], A[i * m.dim + d]));
        }
      } else {
        float acc[S];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = -0.f;
        for (int ib = i0 - i0 % S; ib < m.dim; ib += S) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const int i = ib + j;
            if (i >= i0 && i < m.dim) {
              acc[j] = __fadd_rn(acc[j], __fmul_rn(m.row[i], A[i * m.dim + d]));
            }
          }
        }
        res = join<S>(acc);
      }
    }
    out[r] = res;
  }
  __syncwarp();
}

template <int K, int S, bool PART_I, bool LOWER>
__device__ __forceinline__ void product(const DenseMetric<K>& m, const float (&x)[K],
                                        const float* A, float (&out)[K]) {
  if constexpr (PART_I && S == 1) {
    m.template row_times<LOWER>(x, A, out);
  } else if constexpr (PART_I) {
    row_times_i_outer<K, S, LOWER>(m, x, A, out);
  } else {
    row_times_r_outer<K, S, LOWER>(m, x, A, out);
  }
}

template <int K, int S, bool PART_I>
__global__ void __launch_bounds__(WARPS * 32)
    products_kernel(const float* inv_mass, const float* l_inv, int dim, int n_chains,
                    int n_products, int lower_every, const float* x0, float* x_out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chain = blockIdx.x * WARPS + warp;
  const DenseMetric<K> m = make_metric<K, true>(inv_mass, l_inv, dim, smem, warp, lane);
  if (chain >= n_chains) return;  // uniform across the warp
  float x[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    x[r] = d < dim ? x0[static_cast<size_t>(chain) * dim + d] : 0.f;
  }
  for (int n = 0; n < n_products; ++n) {
    float v[K];
    if (n % lower_every == 0) {
      product<K, S, PART_I, true>(m, x, m.linv, v);
    } else {
      product<K, S, PART_I, false>(m, x, m.minv, v);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) x[r] = __fadd_rn(x[r], __fmul_rn(1e-3f, v[r]));
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    if (d < dim) x_out[static_cast<size_t>(chain) * dim + d] = x[r];
  }
}

using KernelFn = void (*)(const float*, const float*, int, int, int, int, const float*, float*);

// variant = (K - 1) * 8 + log2(S) * 2 + part_i, K 1 or 2, S 1 to 8
template <int K, int S>
KernelFn pick(int part_i) {
  return part_i ? products_kernel<K, S, true> : products_kernel<K, S, false>;
}

template <int K>
KernelFn pick_s(int s_log2, int part_i) {
  switch (s_log2) {
    case 0: return pick<K, 1>(part_i);
    case 1: return pick<K, 2>(part_i);
    case 2: return pick<K, 4>(part_i);
    case 3: return pick<K, 8>(part_i);
    default: return nullptr;
  }
}

KernelFn kernel_of(int variant) {
  if (variant < 0 || variant >= 16) return nullptr;
  const int k = variant / 8 + 1, s_log2 = (variant / 2) % 4, part_i = variant % 2;
  return k == 1 ? pick_s<1>(s_log2, part_i) : pick_s<2>(s_log2, part_i);
}

}  // namespace bench

// Resident blocks an SM of `variant` at `smem_bytes` of dynamic shared memory.
extern "C" int bench_occupancy(int variant, int smem_bytes, int* blocks) {
  const bench::KernelFn f = bench::kernel_of(variant);
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, bench::WARPS * 32,
                                                      static_cast<size_t>(smem_bytes));
  return static_cast<int>(err);
}

// The shared memory a block needs: M^{-1}, L^{-1} and one row a warp.
extern "C" int bench_min_smem(int dim, int k) {
  return static_cast<int>(k == 1 ? mcmc::metric_smem_bytes<1, true>(dim, bench::WARPS)
                                 : mcmc::metric_smem_bytes<2, true>(dim, bench::WARPS));
}

extern "C" int bench_launch(int variant, int dim, int n_chains, int n_products,
                            int lower_every, const float* inv_mass, const float* l_inv,
                            const float* x0, float* x_out, int smem_bytes, void* stream) {
  const bench::KernelFn f = bench::kernel_of(variant);
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_chains + bench::WARPS - 1) / bench::WARPS);
  f<<<blocks, bench::WARPS * 32, static_cast<size_t>(smem_bytes),
      static_cast<cudaStream_t>(stream)>>>(inv_mass, l_inv, dim, n_chains, n_products,
                                           lower_every, x0, x_out);
  return static_cast<int>(cudaGetLastError());
}
