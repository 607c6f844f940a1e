// Fused multi-transition random-walk Metropolis for NVIDIA Hopper (sm_90a).
//
// Replaces mcmc_tpu/ops/fused_rwmh.py:_make_rwmh_kernel (built by
// make_fused_rwmh_multistep): T RWMH transitions per call with the chain
// state kept on chip. Per transition and chain: q' = q + scale * eps,
// lp' = log p(q') from the target functor of targets.cuh (its gradient is
// never read, so the compiler drops it), accept if log u < min(0, lp' - lp),
// select, write the accept and, for the first n_hist chains only, the
// post-transition q and lp. The plain PyTorch version is
// mcmc_tpu_torch/ops/fused_rwmh.py:rwmh_multistep_plain. The family
// HIERARCHICAL_LOGISTIC is the TPU kernel's data-carrying form (variant 3a,
// the `data_arrays` refs): lp' through the log-density alone, z = X q and
// the softplus sum with no X^T product, reading X and y from device memory
// (struct TargetData); that product, dim n_data multiply-adds per chain and
// transition, then sets the time. 3a runs block-tiled (rwmh_tiled_kernel,
// below), the other families in lane groups (rwmh_multistep_kernel).
//
// What bounds it on an H100: per transition a chain costs one Philox block
// per four coordinates plus one for the accept uniform, two Box-Muller pairs
// per block, the target's ~3 flops per coordinate and one small reduction.
// Device memory sees q and lp once per call (2.6 MB each way at 65,536 x 10
// in float32), the (T, C) accept bytes (2.1 MB at T = 32) and a history of
// only the n_hist chains the harness keeps: ~0.25 MB of traffic per
// transition, so the Philox and transcendental arithmetic sets the time
// (0.11 ms per 32-transition call at 65,536 x 10 on an H100, ~2.5 us of it
// memory, 1.3x the issue floor of its 331 warp instructions a transition,
// PERF.md section 6): the kernel is issue-bound, and a warp's instruction
// stream costs the same whether one of its lanes needs an instruction or
// all 32 do.
//
// Design: a group of G = 2^ceil(log2(ceil(D / 4))) lanes holds one chain and
// lane j of the group holds the four consecutive coordinates 4j..4j+3 -- the
// four standard normals of exactly one Philox draw (draw j), so no draw is
// computed twice and, at D = 10, eight chains share a warp instead of one
// chain leaving 22 of 32 lanes idle. Group sums are __shfl_xor_sync
// butterflies over G lanes. Chains past n_chains in a partly used warp
// compute on a clamped index and store nothing, so every shuffle sees the
// full warp. Where the group has a lane past the chain's draws (ceil(D / 4)
// < G: D = 9-12, 17-28, 33-60, 65-124), its last lane draws the accept
// block ACCEPT_DRAW in the same philox4x32_10 call as the others draw
// theirs, and its first Box-Muller logarithm, logf of the accept uniform,
// reaches the group by one shuffle: the second Philox block and the
// logarithm of u leave the warp's stream. Where D fills the group, every
// lane still draws the accept block after its own, under a branch uniform
// across the warp; at D <= 2 (one lane, one Box-Muller pair used) the
// second pair is skipped.
//
// Design of rwmh_tiled_kernel (3a): in lane groups every chain read all of
// X from L1 for each transition, n_data x D multiply-adds with no load
// shared across chains. RWMH chains evaluate in lockstep, one log-density
// a transition each, as kernel 1's 1d chains do, so 3a takes 1d's
// evaluator (tiled_step.cuh:TiledHierarchical::log_prob): a block of
// HIER_TILE_CHAINS chains, one warp each, streams X^T through shared
// memory in tiles of LP_TILE_ROWS rows (cp.async, double-buffered), and
// each thread computes 4 chains x 1 row of Z = Q X^T, so each load of X
// from L2 serves the block's chains and each shared load of it 4 chains.
// Inside a chain's warp the layout stays kernel 3's: lane j < G (G =
// rwmh_lanes(D) of ops/padded_targets.py, the lane group's size) holds
// coordinates 4j..4j+3, the four normals of Philox draw j, sums the rows n
// = j (mod G) in order and joins them in a butterfly over G lanes; a lane
// past G holds zeros. So every draw and sum is the lane-group kernel's,
// and 3a's outputs equal it bit for bit. A warp past n_chains runs a
// clamped chain and stores nothing.
//
// Randomness: injected (noise, u non-null; noise (T, C, D), u (T, C)) or
// Philox4x32-10 with counter (chain, call, t, draw): noise coordinate d from
// draw d / 4 (the layout of philox.cuh), the accept uniform word x0 of draw
// ACCEPT_DRAW; from whichever lane, its bits are philox_accept_uniform's.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "targets.cuh"
#include "tiled_step.cuh"

namespace mcmc {
namespace rwmh {

constexpr int THREADS = 256;      // the lane-group kernel's largest block
constexpr int MIN_THREADS = 64;   // and its smallest (launch_threads)
constexpr int K = 4;  // coordinates per lane: the four normals of one Philox draw
static_assert(THREADS / 32 <= TARGET_MAX_WARPS, "targets.cuh stages one row per warp");

struct Args {
  int dim, n_chains, transitions, n_hist;
  TargetParams params;
  const float* scale;  // (1,) device
  const uint32_t* key;
  uint32_t call;
  const float *q, *lp, *noise, *u;
  float *q_out, *lp_out;
  bool* acc_out;
  float *hist_q, *hist_lp;  // (T, n_hist, D), (T, n_hist)
  TargetData data;
};

// T transitions of one chain; `gl` is the lane's place in its group of G
// lanes (lane gl holds coordinates 4 gl .. 4 gl + 3) and `log_density(prop)`
// the proposal's lp, which every lane of the group (and, tiled, of the block)
// calls together. `active`: the chain is no clamped stand-in, so it stores.
template <int G, typename LogDensity>
__device__ __forceinline__ void run_chain(const Args& a, const LogDensity& log_density,
                                          int chain, bool active, int gl) {
  const float scale = a.scale[0];
  const int dim = a.dim;
  const size_t row = static_cast<size_t>(chain) * dim;
  const bool philox = a.noise == nullptr;
  const uint32_t k0 = philox ? a.key[0] : 0u, k1 = philox ? a.key[1] : 0u;
  // uniform across the warp: the group's last lane holds no coordinates
  // (it draws the accept block), and lanes hold a second pair of normals
  const bool spare = (dim + K - 1) / K < G;
  const bool second_pair = dim > 2;
  const uint32_t draw = spare && gl == G - 1 ? ACCEPT_DRAW : static_cast<uint32_t>(gl);

  float q[K], prop[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = gl * K + r;
    q[r] = d < dim ? a.q[row + d] : 0.f;
  }
  float lp = a.lp[chain];

  for (int t = 0; t < a.transitions; ++t) {
    const size_t slot = static_cast<size_t>(t) * a.n_chains + chain;  // (T, C) index
    float noise[K], log_u;
    if (philox) {
      const uint4 x = philox4x32_10(
          make_uint4(chain, a.call, static_cast<uint32_t>(t), draw), k0, k1);
      // philox_normal_row's Box-Muller pairs on words (x0, x1) and (x2, x3)
      const float log_w0 = logf(bits_to_uniform(x.x));
      const float rad0 = sqrtf(-2.f * log_w0);
      const float theta0 = TWO_PI_F * bits_to_uniform(x.y);
      noise[0] = rad0 * cosf(theta0);
      noise[1] = rad0 * sinf(theta0);
      noise[2] = noise[3] = 0.f;
      if (second_pair) {
        const float rad1 = sqrtf(-2.f * logf(bits_to_uniform(x.z)));
        const float theta1 = TWO_PI_F * bits_to_uniform(x.w);
        noise[2] = rad1 * cosf(theta1);
        noise[3] = rad1 * sinf(theta1);
      }
      // log u: the spare lane's log_w0 is logf of the accept uniform, word x0
      // of block ACCEPT_DRAW as philox_accept_uniform reads it
      log_u = spare ? __shfl_sync(FULL_MASK, log_w0, G - 1, G)
                    : logf(philox_accept_uniform(chain, a.call, static_cast<uint32_t>(t), k0,
                                                 k1));
    } else {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int d = gl * K + r;
        noise[r] = d < dim ? a.noise[slot * dim + d] : 0.f;
      }
      log_u = logf(a.u[slot]);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int d = gl * K + r;
      // rounded as the plain version's q + scale * eps (no FMA)
      prop[r] = d < dim ? __fadd_rn(q[r], __fmul_rn(scale, noise[r])) : 0.f;
    }
    const float lp1 = log_density(prop);
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

// Lane groups of G lanes, 32 / G chains a warp: every family but the data
// set's.
template <int FAMILY, int G>
__global__ void __launch_bounds__(THREADS) rwmh_multistep_kernel(const Args a) {
  constexpr int CHAINS_PER_WARP = 32 / G;
  const int warp = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (warp * CHAINS_PER_WARP >= a.n_chains) return;  // uniform across the warp
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int gl = lane % G;  // lane within the chain's group
  const int c = warp * CHAINS_PER_WARP + lane / G;
  const bool active = c < a.n_chains;
  const Target<FAMILY, K, G, true> target(a.dim, a.params, a.data);
  run_chain<G>(a, [&](const float (&prop)[K]) {
    float g[K];
    return target(prop, g, gl);
  }, active ? c : a.n_chains - 1, active, gl);
}

// 3a: HIER_TILE_CHAINS chains a block, one warp each, lanes past G idle in
// the sums (the design above); lane G - 1 draws the accept block where
// ceil(D / 4) < G, as in the lane groups. One block an SM: without that
// bound ptxas gave the G < 32 instances 32 registers and spilled.
template <int G>
__global__ void __launch_bounds__(32 * HIER_TILE_CHAINS, 1)
    rwmh_tiled_kernel(const Args a, const TileGeometry geo) {
  extern __shared__ float4 tile_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * HIER_TILE_CHAINS + warp;
  const bool active = c < a.n_chains;
  const TiledHierarchical<K, G, true> target(a.data, geo, reinterpret_cast<float*>(tile_smem),
                                             warp);
  run_chain<G>(a, [&](const float (&prop)[K]) { return target.log_prob(prop, lane); },
            active ? c : a.n_chains - 1, active, lane);
}

// 3a's geometry: HIER_TILE_CHAINS chains a block, LP_TILE_ROWS rows a tile
// of X^T, no X tile (ops/fused_rwmh.py:tile_geometry mirrors it).
inline TileGeometry tiled_geometry(int dim) {
  return tile_layout(dim, false, LP_TILE_ROWS, HIER_TILE_CHAINS, false);
}

// Threads a block of the lane-group kernel for n_chains chains of G lanes:
// the most of THREADS, THREADS / 2, ..., MIN_THREADS that still give every
// SM of the card a block (trajectory.cuh:spread_warps; at 1,024 chains 256
// threads made 16 blocks at D = 10 and 4 at D <= 4, and on an H100 64
// threads took 10-12% off there, PERF.md section 6).
inline int launch_threads(int n_chains, int G) {
  return 32 * spread_warps(n_chains, G, THREADS / 32, MIN_THREADS / 32);
}

template <int FAMILY, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (FAMILY == HIERARCHICAL_LOGISTIC) {
    const TileGeometry geo = tiled_geometry(a.dim);
    const cudaError_t err = cudaFuncSetAttribute(
        rwmh_tiled_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
    if (err != cudaSuccess) return err;
    const unsigned blocks =
        static_cast<unsigned>((a.n_chains + HIER_TILE_CHAINS - 1) / HIER_TILE_CHAINS);
    rwmh_tiled_kernel<G><<<blocks, 32 * HIER_TILE_CHAINS, geo.bytes, stream>>>(a, geo);
  } else {
    const int threads = launch_threads(a.n_chains, G);
    const long long chains_per_block = (threads / 32) * (32 / G);
    const unsigned blocks = static_cast<unsigned>((a.n_chains + chains_per_block - 1) /
                                                  chains_per_block);
    rwmh_multistep_kernel<FAMILY, G><<<blocks, threads, 0, stream>>>(a);
  }
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
// Pointers are device pointers except `target_params`, a host
// TargetParams, and `data`, a host TargetData of device
// pointers (null for a family without data); noise/u null selects the
// in-kernel Philox draws (then key must be non-null). Returns the launch's
// cudaError_t.
extern "C" int rwmh_multistep_launch(int family, int dim, int n_chains, int transitions,
                                     int n_hist, const mcmc::TargetParams* target_params,
                                     const mcmc::TargetData* data,
                                     const float* scale, const uint32_t* key,
                                     unsigned int call, const float* q, const float* lp,
                                     const float* noise, const float* u, float* q_out,
                                     float* lp_out, bool* acc_out, float* hist_q,
                                     float* hist_lp, void* stream) {
  using namespace mcmc;
  if ((noise == nullptr && key == nullptr) || target_params == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim < 1 || dim > 32 * rwmh::K || n_chains < 1 || transitions < 1 || n_hist < 0 ||
      n_hist > n_chains || !valid_data(family, target_data(data))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rwmh::Args a{dim,   n_chains, transitions, n_hist, *target_params, scale,
                     key,   call,     q,           lp,     noise,  u,
                     q_out, lp_out,   acc_out,     hist_q, hist_lp, target_data(data)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
#define MCMC_CASE(F) \
  case F: return static_cast<int>(rwmh::dispatch_g<F>(a, s));
    MCMC_FAMILIES(MCMC_CASE)
#undef MCMC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 3a's geometry for dim (rwmh::tiled_geometry): returns its dynamic shared
// memory in bytes and sets the chains a block and the rows a tile; the
// wrapper's tile_geometry must agree.
extern "C" int rwmh_tile_geometry(int dim, int* chains, int* rows) {
  const mcmc::TileGeometry g = mcmc::rwmh::tiled_geometry(dim);
  *chains = g.chains;
  *rows = g.rows;
  return g.bytes;
}
