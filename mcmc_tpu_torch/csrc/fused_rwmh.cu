// Fused multi-transition random-walk Metropolis for NVIDIA Hopper (sm_90a).
//
// Replaces mcmc_tpu/ops/fused_rwmh.py:_make_rwmh_kernel (built by
// make_fused_rwmh_multistep): T RWMH transitions per call with the chain
// state kept on chip. Per transition and chain: q' = q + scale * eps,
// lp' = log p(q') from the target functor of targets.cuh (its gradient is
// never read, so the compiler drops it), accept if log u < min(0, lp' - lp),
// select, write the accept and, for the first n_hist chains only, the
// post-transition q and lp. The plain PyTorch version is
// mcmc_tpu_torch/ops/fused_rwmh.py:rwmh_multistep_plain.
//
// What bounds it on an H100: per transition a chain costs one Philox block
// per four coordinates plus one for the accept uniform, two Box-Muller pairs
// per block, the target's ~3 flops per coordinate and one small reduction.
// Device memory sees q and lp once per call (2.6 MB each way at 65,536 x 10
// in float32), the (T, C) accept bytes (2.1 MB at T = 32) and a history of
// only the n_hist chains the harness keeps: ~0.25 MB of traffic per
// transition, so the Philox and transcendental arithmetic sets the time
// (0.14 ms per 32-transition call on an H100, ~2.5 us of it memory).
//
// Design: a group of G = 2^ceil(log2(ceil(D / 4))) lanes holds one chain and
// lane j of the group holds the four consecutive coordinates 4j..4j+3 -- the
// four standard normals of exactly one Philox draw (draw j), so no draw is
// computed twice and, at D = 10, eight chains share a warp instead of one
// chain leaving 22 of 32 lanes idle. Group sums are __shfl_xor_sync
// butterflies over G lanes. Chains past n_chains in a partly used warp
// compute on a clamped index and store nothing, so every shuffle sees the
// full warp.
//
// Randomness: injected (noise, u non-null; noise (T, C, D), u (T, C)) or
// Philox4x32-10 with counter (chain, call, t, draw): noise coordinate d from
// draw d / 4 (the layout of philox.cuh), the accept uniform word x0 of draw
// ACCEPT_DRAW.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "targets.cuh"

namespace mcmc {
namespace rwmh {

constexpr int THREADS = 256;
constexpr int K = 4;  // coordinates per lane: the four normals of one Philox draw

struct Args {
  int dim, n_chains, transitions, n_hist;
  const float* scale;  // (1,) device
  const uint32_t* key;
  uint32_t call;
  const float *q, *lp, *noise, *u;
  float *q_out, *lp_out;
  bool* acc_out;
  float *hist_q, *hist_lp;  // (T, n_hist, D), (T, n_hist)
};

template <int FAMILY, int G>
__global__ void __launch_bounds__(THREADS) rwmh_multistep_kernel(const Args a) {
  constexpr int CHAINS_PER_WARP = 32 / G;
  const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (warp * CHAINS_PER_WARP >= a.n_chains) return;  // uniform across the warp
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int gl = lane % G;  // lane within the chain's group
  const int c = warp * CHAINS_PER_WARP + lane / G;
  const bool active = c < a.n_chains;
  const int chain = active ? c : a.n_chains - 1;

  const Target<FAMILY, K, G> target(a.dim);
  const float scale = a.scale[0];
  const int dim = a.dim;
  const size_t row = static_cast<size_t>(chain) * dim;
  const bool philox = a.noise == nullptr;
  const uint32_t k0 = philox ? a.key[0] : 0u, k1 = philox ? a.key[1] : 0u;

  float q[K], prop[K], g[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = gl * K + r;
    q[r] = d < dim ? a.q[row + d] : 0.f;
  }
  float lp = a.lp[chain];

  for (int t = 0; t < a.transitions; ++t) {
    const size_t slot = static_cast<size_t>(t) * a.n_chains + chain;  // (T, C) index
    float noise[K], u;
    if (philox) {
      const uint4 x = philox4x32_10(
          make_uint4(chain, a.call, static_cast<uint32_t>(t), static_cast<uint32_t>(gl)), k0, k1);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const float rad = sqrtf(-2.f * logf(bits_to_uniform(w[2 * pair])));
        const float theta = TWO_PI_F * bits_to_uniform(w[2 * pair + 1]);
        noise[2 * pair] = rad * cosf(theta);
        noise[2 * pair + 1] = rad * sinf(theta);
      }
      u = philox_accept_uniform(chain, a.call, static_cast<uint32_t>(t), k0, k1);
    } else {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int d = gl * K + r;
        noise[r] = d < dim ? a.noise[slot * dim + d] : 0.f;
      }
      u = a.u[slot];
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = gl * K + r;
      prop[r] = d < dim ? q[r] + scale * noise[r] : 0.f;
    }
    const float lp1 = target(prop, g, gl);
    const float log_u = logf(u);
    // log u < min(0, lp' - lp); a NaN lp' rejects, as in PyTorch
    const bool accept = (log_u < 0.f) && (log_u < lp1 - lp);
    if (accept) {
#pragma unroll
      for (int r = 0; r < K; ++r) q[r] = prop[r];
      lp = lp1;
    }
    if (active) {
      if (gl == 0) a.acc_out[slot] = accept;
      if (chain < a.n_hist) {
        const size_t hslot = static_cast<size_t>(t) * a.n_hist + chain;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int d = gl * K + r;
          if (d < dim) a.hist_q[hslot * dim + d] = q[r];
        }
        if (gl == 0) a.hist_lp[hslot] = lp;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = gl * K + r;
      if (d < dim) a.q_out[row + d] = q[r];
    }
    if (gl == 0) a.lp_out[chain] = lp;
  }
}

template <int FAMILY, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long chains_per_block = (THREADS / 32) * (32 / G);
  const unsigned blocks = static_cast<unsigned>((a.n_chains + chains_per_block - 1) /
                                                chains_per_block);
  rwmh_multistep_kernel<FAMILY, G><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int FAMILY>
cudaError_t dispatch_g(const Args& a, cudaStream_t stream) {
  const int lanes = (a.dim + K - 1) / K;
  if (lanes <= 1) return launch<FAMILY, 1>(a, stream);
  if (lanes <= 2) return launch<FAMILY, 2>(a, stream);
  if (lanes <= 4) return launch<FAMILY, 4>(a, stream);
  if (lanes <= 8) return launch<FAMILY, 8>(a, stream);
  if (lanes <= 16) return launch<FAMILY, 16>(a, stream);
  return launch<FAMILY, 32>(a, stream);
}

}  // namespace rwmh
}  // namespace mcmc

// Plain C entry point, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// Pointers are device pointers; noise/u null selects the in-kernel Philox
// draws (then key must be non-null). Returns the launch's cudaError_t.
extern "C" int rwmh_multistep_launch(int family, int dim, int n_chains, int transitions,
                                     int n_hist, const float* scale, const uint32_t* key,
                                     unsigned int call, const float* q, const float* lp,
                                     const float* noise, const float* u, float* q_out,
                                     float* lp_out, bool* acc_out, float* hist_q,
                                     float* hist_lp, void* stream) {
  using namespace mcmc;
  if (noise == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dim < 1 || dim > 32 * rwmh::K || n_chains < 1 || transitions < 1 || n_hist < 0 ||
      n_hist > n_chains) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rwmh::Args a{dim, n_chains, transitions, n_hist, scale, key,     call,   q,
                     lp,  noise,    u,           q_out,  lp_out, acc_out, hist_q, hist_lp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case STANDARD_NORMAL: return static_cast<int>(rwmh::dispatch_g<STANDARD_NORMAL>(a, s));
    case NEALS_FUNNEL: return static_cast<int>(rwmh::dispatch_g<NEALS_FUNNEL>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
