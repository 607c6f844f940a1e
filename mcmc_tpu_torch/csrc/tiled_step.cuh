// Kernel 1's block-tiled form for NVIDIA Hopper (sm_90a): the dense-metric
// variant 1a (every family) and the data-carrying variant 1d (the
// hierarchical posterior, either metric); and kernel 2's data-carrying
// variant 2b (either metric), T transitions a call through the same body
// (tiled_chain). Its building blocks (TiledDenseMetric, TiledHierarchical,
// with live_tile's LiveTile for the chains live in a call) also serve
// kernel 4's tiled window (nuts_window.cuh: 4c in either scheme and metric)
// and, the log-density alone in kernel 3's lane layout, kernel 3's tiled 3a
// (fused_rwmh.cu). Kernel 1's other instances (fused_trajectory.cuh:
// grahmc_step_kernel, diagonal metric, no data), kernel 2's (2a among them),
// 1b and 1c, and kernel 4's other instances keep the warp-per-chain forms of
// metric.cuh and targets.cuh.
//
// Replaces mcmc_tpu/ops/fused_trajectory.py:_make_kernel with dense=True
// (variant 1a) and with data_arrays (variant 1d), one MH transition per
// chain, and mcmc_tpu/ops/fused_trajectory.py:_make_multistep_kernel with
// data_arrays (variant 2b), T per call. A block owns a tile of chains, one
// warp each (1a 8, 1d and 2b 32): the warps run the transition of
// trajectory.cuh (leapfrog, energies, accept) and the family's functor as
// kernels 1 and 2 do, and the whole block computes the products that every
// chain of the tile takes with one shared matrix.
//
// What bounds these variants on an H100 is those products, not device
// memory. 1a: each transition takes L + 3 products p @ A with a (D, D)
// M^{-1} or L^{-1} (L velocities, two kinetic energies, the unwhitening);
// warp-per-chain, each multiply-add read one word of shared memory, so the
// load/store unit set the pace. 1d: each gradient takes z = X beta and
// X^T (y - sigmoid z), 2 n_data D multiply-adds each per chain; warp-per-
// chain, every chain read all of X twice per evaluation from L1. The
// tiling: the block stages its chains' rows in shared memory, and each
// thread computes a register tile of RC chains x 1 column of the product
// (RC = 4: one float4 of the rows and one word of the matrix per 4
// multiply-adds), so a load of the matrix serves RC chains (block_times,
// mac_rows). X is streamed through shared memory in row tiles, double-
// buffered with cp.async, and each of its loads from L2 serves the block's
// 32 chains (TiledHierarchical). Tiled, the products' in-order sums still
// bound both: each output is a chain of D (1a) or n_data (1d) dependent
// adds, which no tile shortens (the products' share of each kernel's time:
// PERF.md section 6).
//
// Exactness: every output's sum runs over its index in the plain version's
// order with each product rounded before it is added (__fmul_rn,
// __fadd_rn), as metric.cuh's row_times and targets.cuh's functor do, so
// the outputs equal the warp-per-chain kernels' bit for bit: the tile only
// decides which thread computes which output. The metric products sum
// over i from -0 (-0 + x == x, so the first term enters unrounded, as
// row_times starts); z and the gradient sums start from +0 as the functor's
// do. No tensor cores: a TF32 or split-float mma would change the order.
//
// Lockstep: the block's warps meet at __syncthreads() in every product, so
// a warp past n_chains (the last, ragged block) runs the transitions on a
// zero row and stores nothing. Kernels 1's and 2's L is uniform and their
// leapfrog never exits early; the accept and the energy guard stay per
// chain.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "trajectory.cuh"

namespace mcmc {

// Chains (warps) a block. A product's sums run in order, so each thread's
// part of it is a chain of D (or n_data) dependent adds: a block's products
// take that latency however many threads share them. 1a keeps several
// small blocks on an SM, whose products overlap; 1d's blocks are as large
// as a block can be, each load of X serving 32 chains. Measured on an H100
// (PERF.md section 6): 1a at 4, 8, 16 and 32 chains a block, 1d at 8, 16
// and 32.
constexpr int DENSE_TILE_CHAINS = 8;
constexpr int HIER_TILE_CHAINS = 32;
template <int FAMILY>
struct TileChains {
  static constexpr int value =
      FAMILY == HIERARCHICAL_LOGISTIC ? HIER_TILE_CHAINS : DENSE_TILE_CHAINS;
};
__host__ __device__ constexpr int tile_chains(bool data) {
  return data ? HIER_TILE_CHAINS : DENSE_TILE_CHAINS;
}
static_assert(DENSE_TILE_CHAINS >= 4 && HIER_TILE_CHAINS >= 4 && HIER_TILE_CHAINS <= 32 &&
                  DENSE_TILE_CHAINS <= 32,
              "one warp per chain: 4 to 32 chains a block (a block holds 1024 threads; "
              "the X tile's copy needs at least 128)");
// A thread's register tile: RC chains x 1 column of 1a's D x D products and
// of 1d's Z = Q X^T and G = R X, its chains loaded as one float4. 4 x 1 beat
// 1 x 2, 1 x 4, 2 x 2, 2 x 4, 4 x 2 and 4 x 4 on both (the same
// measurements).
constexpr int RC = 4;  // mac_rows: one float4 a row of the tile
static_assert(DENSE_TILE_CHAINS % RC == 0 && HIER_TILE_CHAINS % RC == 0,
              "chain tiles split the block's chains");
static_assert(HIER_TILE_CHAINS / RC * 32 * MAX_K <= 32 * HIER_TILE_CHAINS,
              "every G tile has its own thread at D = 128");
// mac_rows' iterations a loop trip: loads run ahead of the dependent adds.
// 16 beat 1, 2, 4 and 8 on both variants (the same measurements).
constexpr int MAC_UNROLL = 16;
constexpr int TILE_MAX_ROWS = 64;               // data rows per tile: 64, 32 or 16
constexpr int TILE_MIN_ROWS = 16;
// The log-density alone (kernel 3's 3a) needs no X tile and no residuals:
// a tile of 128 rows fits at every D and gives each of the block's 1,024
// threads one output of Z = Q X^T (HIER_TILE_CHAINS / RC x 128).
constexpr int LP_TILE_ROWS = 128;
constexpr int MAX_TILE_SMEM = 232448;           // an H100 block's dynamic shared memory

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The block's dynamic shared memory, in floats from its base; every region
// starts on 16 bytes. dp: the padded row length (D rounded up to 4); ps:
// the chain stride of a transposed tile; rows: data rows per X tile (0
// without data); chains: the block's. Regions: the dense metric's M^{-1}
// and L^{-1} (D x dp, zero columns past D), `in` the block's rows
// transposed (D x ps), `out` the products' rows (chains x max(dp, rows)),
// and for data two X^T
// tiles (D x rows), two X tiles (rows x dp) and the residuals transposed
// (rows x ps); without the gradient (`grad` false: the log-density alone)
// `out` holds Z only (chains x rows), and there are no X tiles and no
// residuals. bytes 0: no row tile fits.
struct TileGeometry {
  int dim, dp, ps, rows, chains;
  int minv, linv, in, out, xt, x, rt;
  int bytes;
};

__host__ __device__ constexpr TileGeometry tile_layout(int dim, bool dense, int rows,
                                                      int chains, bool grad = true) {
  TileGeometry g{};
  g.dim = dim;
  g.dp = round4(dim);
  g.ps = chains + 4;
  g.rows = rows;
  g.chains = chains;
  int at = 0;
  g.minv = at;
  at += dense ? dim * g.dp : 0;
  g.linv = at;
  at += dense ? dim * g.dp : 0;
  g.in = at;
  at += dim * g.ps;
  g.out = at;
  at += chains * (grad && g.dp > rows ? g.dp : rows);
  g.xt = at;
  at += 2 * dim * rows;
  g.x = at;
  at += grad ? 2 * rows * g.dp : 0;
  g.rt = at;
  at += grad ? rows * g.ps : 0;
  g.bytes = at * static_cast<int>(sizeof(float));
  return g;
}
static_assert(tile_layout(32 * MAX_K, true, TILE_MIN_ROWS, HIER_TILE_CHAINS).bytes <=
                  MAX_TILE_SMEM,
              "the smallest row tile fits at the largest D, with the dense metric");

static_assert(tile_layout(32 * MAX_K, false, LP_TILE_ROWS, HIER_TILE_CHAINS, false).bytes <=
                  MAX_TILE_SMEM,
              "the log-density's row tile fits at the largest D");

// The geometry of a call: the largest row tile that fits (ops/
// fused_trajectory.py:tile_geometry mirrors it).
__host__ __device__ inline TileGeometry tile_geometry(int dim, int n_data, bool dense, bool data) {
  if (!data) return tile_layout(dim, dense, 0, tile_chains(false));
  for (int rows = TILE_MAX_ROWS; rows >= TILE_MIN_ROWS; rows /= 2) {
    const TileGeometry g = tile_layout(dim, dense, rows, tile_chains(true));
    if (g.bytes <= MAX_TILE_SMEM) return g;
  }
  (void)n_data;
  return TileGeometry{};
}

// acc[c] += L[i][c] * R[i] for i in [i0, i1), in order, each product
// rounded before its sum: L points at the tile's first chain of a
// transposed row block (stride ls, RC floats 16-byte aligned), R at its
// column (stride rs). For a lower-triangular R, i0 is the column, as
// row_times<true> skips the zero triangle.
__device__ __forceinline__ void mac_rows(float (&acc)[RC], const float* L, int ls,
                                         const float* R, int rs, int i0, int i1) {
#pragma unroll MAC_UNROLL
  for (int i = i0; i < i1; ++i) {
    const float4 l = *reinterpret_cast<const float4*>(L + static_cast<size_t>(i) * ls);
    const float r = R[static_cast<size_t>(i) * rs];
    acc[0] = __fadd_rn(acc[0], __fmul_rn(l.x, r));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(l.y, r));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(l.z, r));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(l.w, r));
  }
}

// Rows c0.. of `out` (stride os), column j, from a register tile.
__device__ __forceinline__ void store_tile(float* out, int os, int c0, int j,
                                           const float (&acc)[RC]) {
#pragma unroll
  for (int c = 0; c < RC; ++c) out[(c0 + c) * os + j] = acc[c];
}

// This warp's row (coordinates lane + 32 r < dim, or K lane + r in kernel
// 3's BLOCKED layout) into column `warp` of a transposed tile (stride ps),
// and back out of row `warp` of a row tile.
template <int K, bool BLOCKED = false>
__device__ __forceinline__ void put_column(float* t, int ps, int dim, int warp, int lane,
                                           const float (&x)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = coord_of<K, 32, BLOCKED>(lane, r);
    if (d < dim) t[d * ps + warp] = x[r];
  }
}

template <int K>
__device__ __forceinline__ void get_row(const float* t, int os, int dim, int warp, int lane,
                                        float (&x)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    x[r] = d < dim ? t[warp * os + d] : 0.f;
  }
}

// The dense metric of the tiled kernel: the interface of metric.cuh's
// DenseMetric (velocity, kinetic, unwhiten), its products block-wide.
// Replaces the dense _metric_ops and unwhiten_op of mcmc_tpu/ops/
// fused_trajectory.py:_make_kernel (dense=True). Every warp of the block
// must call each method together. What bounds it: the D x D product per
// chain, 2 D^2 flops; a register tile of RC chains x 1 column reads RC
// words of the rows and one of A for its RC multiply-adds (row_times read
// 1.5 words per multiply-add), and the block's M^{-1} and L^{-1} are loaded
// once per launch. Dense-metric shared memory, see TileGeometry.
template <int K, int C>
struct TiledDenseMetric {
  static constexpr bool DENSE = true;
  const float* minv;  // shared (D, dp) M^{-1}, symmetric, zero columns past D
  const float* linv;  // shared (D, dp) L^{-1}, lower triangular
  float* in;          // (D, ps): the block's rows, transposed
  float* out;         // (C, dp): the products' rows
  int dim, dp, ps, warp, lane;

  // out = x @ A for every chain of the block (metric.cuh:row_times, same
  // sums); zeros past dim. LIVE: for the chains live in the call only
  // (LiveTile), their rows compacted into the first columns, so the
  // products take ceil(n / RC) chain tiles; a warp that is not live only
  // meets the barriers.
  template <bool LOWER, bool LIVE = false>
  __device__ __forceinline__ void block_times(const float (&x)[K], const float* A,
                                              float (&o)[K],
                                              const LiveTile& live = LiveTile{}) const {
    const int col = LIVE ? live.col : warp;
    if (!LIVE || col >= 0) put_column(in, ps, dim, col, lane, x);
    __syncthreads();
    const int tiles = (LIVE ? (live.n + RC - 1) / RC : C / RC) * dp;
    for (int t = threadIdx.x; t < tiles; t += 32 * C) {
      const int c0 = (t / dp) * RC;
      const int j = t % dp;
      float acc[RC] = {-0.f, -0.f, -0.f, -0.f};
      mac_rows(acc, in + c0, ps, A + j, dp, LOWER ? j : 0, dim);
      store_tile(out, dp, c0, j, acc);
    }
    __syncthreads();
    if (!LIVE || col >= 0) get_row(out, dp, dim, col, lane, o);
  }

  __device__ __forceinline__ void velocity(const float (&p)[K], float (&v)[K]) const {
    block_times<false>(p, minv, v);
  }

  __device__ __forceinline__ float kinetic(const float (&p)[K]) const {
    float v[K];
    velocity(p, v);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s += p[r] * v[r];
    return 0.5f * warp_sum(s);
  }

  __device__ __forceinline__ void unwhiten(float (&z)[K]) const {
    float p[K];
    block_times<true>(z, linv, p);
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = p[r];
  }

  // The same for the chains live in the call only (the persistent-NUTS
  // window); every warp calls them, a warp that is not live gets nothing.
  __device__ __forceinline__ void velocity(const float (&p)[K], float (&v)[K],
                                           const LiveTile& t) const {
    block_times<false, true>(p, minv, v, t);
  }

  __device__ __forceinline__ float kinetic(const float (&p)[K], const LiveTile& t) const {
    float v[K];
    velocity(p, v, t);
    if (t.col < 0) return 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) s += p[r] * v[r];
    return 0.5f * warp_sum(s);
  }

  __device__ __forceinline__ void unwhiten(float (&z)[K], const LiveTile& t) const {
    float p[K];
    block_times<true, true>(z, linv, p, t);
    if (t.col < 0) return;
#pragma unroll
    for (int r = 0; r < K; ++r) z[r] = p[r];
  }
};

// This warp's LiveTile among the block's C chains whose `flag` is set
// (warp-uniform): their columns in warp order. Every warp of the block
// calls it together; one barrier. `buf` is C ints of shared memory, and
// consecutive calls take turns between two such buffers, so that a call's
// writes never overtake a warp still reading the last call's (a barrier
// lies between any call and the next but one).
template <int C>
__device__ __forceinline__ LiveTile live_tile(bool flag, int* buf, int warp, int lane) {
  if (lane == 0) buf[warp] = flag ? 1 : 0;
  __syncthreads();
  const unsigned mask = __ballot_sync(FULL_MASK, lane < C && buf[lane] != 0);
  return LiveTile{flag ? __popc(mask & ((1u << warp) - 1u)) : -1, __popc(mask)};
}

// Copy M^{-1} and L^{-1} into the block's shared memory with rows padded to
// dp (zeros past D). Every thread calls it; it ends with __syncthreads().
__device__ __forceinline__ void load_padded_metric(float* minv, float* linv,
                                                   const float* inv_mass, const float* l_inv,
                                                   int dim, int dp) {
  for (int k = threadIdx.x; k < dim * dp; k += blockDim.x) {
    const int i = k / dp, d = k - i * dp;
    minv[k] = d < dim ? inv_mass[i * dim + d] : 0.f;
    linv[k] = d < dim ? l_inv[i * dim + d] : 0.f;
  }
  __syncthreads();
}

// 4 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The hierarchical posterior (targets.cuh:Target<HIERARCHICAL_LOGISTIC>)
// for the block's HIER_TILE_CHAINS chains at once: lp and gradient, the
// same functor interface, called by every warp of the block together; with
// a LiveTile, for the chains live in the call only (the
// persistent-NUTS window 4c, nuts_window.cuh): their rows compacted into
// the first columns, ceil(n / RC) chain tiles of Z and G, and only their
// warps take rows; log_prob, the log-density alone (kernel 3's 3a,
// fused_rwmh.cu): Z and the row terms, no residuals, no G, no X tile.
// Replaces the target device function of
// mcmc_tpu/ops/fused_trajectory.py:_make_kernel, mcmc_tpu/ops/
// fused_nuts.py:_make_kernel and mcmc_tpu/ops/fused_rwmh.py:
// _make_rwmh_kernel with data_arrays (padded_targets.py:
// _hierarchical_logistic) in variants 1d, 4c and 3a and in 1a's and 4b's
// data forms.
//
// G and BLOCKED: the lanes of a chain's warp that hold its coordinates and
// sum its rows: G = 32 with lane j holding j + 32 r (kernels 1 and 4, the
// layout of targets.cuh's functor), or kernel 3's lane group of G =
// rwmh_lanes(D) lanes with lane j holding 4 j + r (BLOCKED, the layout of
// fused_rwmh.cu's lane groups), so that every sum runs in the order of the
// kernel the tile replaces.
//
// Per row tile of `rows` data rows (n0 = k rows):
//   Z = Q X^T:  thread tiles of RC chains x 1 row, sum over d in order
//               from the X^T tile and the block's q (transposed in `in`);
//   rows:       each chain's warp, lane j < G taking rows n = j (mod G) in
//               order (the functor's lanes), computes exp(-|z|), the row's
//               log-likelihood term, added to the lane's sum, and the
//               residual y - sigmoid z, written transposed to `rt`;
//   G += R X:   thread tiles of RC chains x 1 coordinate, the tile's
//               rows in order, the accumulators in registers across tiles.
// Tile k + 1 is copied (cp.async) into the other buffer while tile k is
// computed. Then the gradient rows go through `out` to their warps, each
// warp sums its lanes' likelihood terms (group_sum<G>) and adds the tau
// terms as the functor does. What bounds it on an H100: 4 n_data D flops
// per chain per evaluation; X's loads from L2 serve the block's chains and
// each shared load of X a thread's RC chains.
template <int K, int G = 32, bool BLOCKED = false>
struct TiledHierarchical {
  static_assert(G == 32 || BLOCKED, "the warp-per-chain layout spans the warp");
  static constexpr int C = HIER_TILE_CHAINS, THREADS = 32 * HIER_TILE_CHAINS;
  const float *X, *xt, *y;
  float *in, *out, *xt_s, *x_s, *rt;
  int n_data, dim, dp, ps, rows, warp;
  float half_p;
  // this thread's share of the tile copies and its G tile
  int cx_d, cx_n, cx_step, ct_n, ct_d, ct_step;
  int g_c0, g_j;
  bool g_owner;

  __device__ TiledHierarchical(const TargetData& data, const TileGeometry& geo, float* smem,
                               int warp_)
      : X(data.X), xt(data.xt), y(data.y), in(smem + geo.in), out(smem + geo.out),
        xt_s(smem + geo.xt), x_s(smem + geo.x), rt(smem + geo.rt), n_data(data.n_data),
        dim(geo.dim), dp(geo.dp), ps(geo.ps), rows(geo.rows), warp(warp_),
        half_p(0.5f * static_cast<float>(geo.dim - 1)) {
    const int t = threadIdx.x;
    cx_step = THREADS / dp;          // X tile: thread -> (row, coordinate)
    cx_d = t % dp;
    cx_n = t < cx_step * dp ? t / dp : rows;
    ct_step = THREADS / rows;        // X^T tile: thread -> (coordinate, row)
    ct_n = t % rows;
    ct_d = t / rows;
    g_owner = t < (C / RC) * dp;
    g_c0 = (t / dp) * RC;
    g_j = t % dp;
  }

  // Start copying row tile k into buffer b (GRAD: the X tile too).
  template <bool GRAD>
  __device__ __forceinline__ void prefetch(int k, int b) const {
    const int n0 = k * rows;
    float* ts = xt_s + b * dim * rows;
    for (int d = ct_d; d < dim; d += ct_step) {
      const int n = n0 + ct_n;
      cp_async4(ts + d * rows + ct_n, n < n_data ? xt + static_cast<size_t>(d) * n_data + n : xt,
                n < n_data);
    }
    if constexpr (GRAD) {
      float* xs = x_s + b * rows * dp;
      for (int nl = cx_n; nl < rows; nl += cx_step) {
        const int n = n0 + nl;
        const bool valid = n < n_data && cx_d < dim;
        cp_async4(xs + nl * dp + cx_d, valid ? X + static_cast<size_t>(n) * dim + cx_d : X,
                  valid);
      }
    }
    cp_async_commit();
  }

  __device__ float operator()(const float (&q)[K], float (&g)[K], int lane) const {
    return evaluate<false, true>(q, g, lane, LiveTile{});
  }

  // The chains live in the call only; a warp that is not live gets 0.
  __device__ float operator()(const float (&q)[K], float (&g)[K], int lane,
                              const LiveTile& live) const {
    return evaluate<true, true>(q, g, lane, live);
  }

  // The log-density alone, every chain of the block (a geometry of
  // tile_layout with grad false suffices).
  __device__ float log_prob(const float (&q)[K], int lane) const {
    float unused[K];
    return evaluate<false, false>(q, unused, lane, LiveTile{});
  }

  template <bool LIVE, bool GRAD>
  __device__ __forceinline__ float evaluate(const float (&q)[K], float (&g)[K], int lane,
                                            const LiveTile& live) const {
    static_assert(GRAD || !LIVE, "the log-density alone serves every chain");
    const int col = LIVE ? live.col : warp;
    const bool mine = !LIVE || col >= 0;
    const bool g_tile = GRAD && g_owner && (!LIVE || g_c0 < live.n);
    if (mine) put_column<K, BLOCKED>(in, ps, dim, col, lane, q);
    prefetch<GRAD>(0, 0);
    const int n_tiles = (n_data + rows - 1) / rows;
    const int z_tiles = (LIVE ? (live.n + RC - 1) / RC : C / RC) * rows;
    float gacc[RC] = {0.f, 0.f, 0.f, 0.f};
    float lik = 0.f;
    for (int k = 0; k < n_tiles; ++k) {
      const int n0 = k * rows;
      const int valid = n_data - n0 < rows ? n_data - n0 : rows;
      const float* ts = xt_s + (k & 1) * dim * rows;
      const float* xs = x_s + (k & 1) * rows * dp;
      cp_async_wait_all();
      __syncthreads();  // tile k landed; every thread is past tile k - 1
      if (k + 1 < n_tiles) prefetch<GRAD>(k + 1, (k + 1) & 1);
      for (int t = threadIdx.x; t < z_tiles; t += THREADS) {
        const int c0 = (t / rows) * RC;
        const int j = t % rows;
        float acc[RC] = {0.f, 0.f, 0.f, 0.f};
        mac_rows(acc, in + c0, ps, ts + j, rows, 0, dim);
        store_tile(out, rows, c0, j, acc);
      }
      __syncthreads();
      // a lane past G holds no coordinates and sums no rows (G < 32: kernel
      // 3's lane groups at small D)
      for (int nl = (lane - n0) & (G - 1); mine && lane < G && nl < valid; nl += G) {
        const float z = out[col * rows + nl];
        const float e = expf(-fabsf(z));
        const float yn = __ldg(y + n0 + nl);
        const float softplus = __fadd_rn(fmaxf(z, 0.f), log1pf(e));
        lik = __fadd_rn(lik, __fsub_rn(__fmul_rn(yn, z), softplus));
        if constexpr (GRAD) {
          const float denom = 1.f + e;
          rt[nl * ps + col] =
              __fsub_rn(yn, z >= 0.f ? __fdiv_rn(1.f, denom) : __fdiv_rn(e, denom));
        }
      }
      if constexpr (GRAD) {
        __syncthreads();
        if (g_tile) mac_rows(gacc, rt + g_c0, ps, xs + g_j, dp, 0, valid);
      }
    }
    float gl[K];
    if constexpr (GRAD) {
      if (g_tile) store_tile(out, dp, g_c0, g_j, gacc);
      __syncthreads();
      if (!mine) return 0.f;
      get_row(out, dp, dim, col, lane, gl);
    }

    const float tau = __shfl_sync(FULL_MASK, q[0], 0, 32);
    const float inv_scale = expf(-tau);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float v = coord_of<K, 32, BLOCKED>(lane, r) == 0 ? 0.f : q[r];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    const float shrink = __fmul_rn(__fmul_rn(0.5f, inv_scale), group_sum<G>(s));
    float lp = __fsub_rn(group_sum<G>(lik), shrink);
    lp = __fsub_rn(lp, __fmul_rn(half_p, tau));
    lp = __fsub_rn(lp, __fmul_rn(__fmul_rn(0.5f, tau), tau));
    if constexpr (GRAD) {
      const float g_tau = __fsub_rn(__fsub_rn(shrink, half_p), tau);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        g[r] = lane + 32 * r == 0 ? g_tau : __fsub_rn(gl[r], __fmul_rn(q[r], inv_scale));
      }
    }
    return lp;
  }
};

template <int K, int G, bool BLOCKED>
struct family_of<TiledHierarchical<K, G, BLOCKED>> {
  static constexpr int value = HIERARCHICAL_LOGISTIC;
};

// The tiled kernels' body for the block's chains: T = `transitions`
// transitions of `chain` (kernel 1: T = 1, the tiled counterpart of
// trajectory.cuh:step_chain; kernel 2: a.transitions, as
// fused_trajectory.cuh:grahmc_multistep_kernel runs them), q, grad and lp
// in registers throughout. The draws of transition t are injected at (t,
// chain) or Philox with counter (chain, call, t, draw), the chain word the
// chain's row, as there. After each transition a live chain hands `record`
// (its (T, C) slot, the accept, delta H, the selected q and lp, the
// proposal q1 and lp1) what the kernel keeps of it; the end state goes to
// q_out, grad_out and lp_out. A chain past n_chains takes part on a zero
// row and stores nothing. SHARED_FRICTION: transition's (kernel 2's).
template <int K, bool SHARED_FRICTION, typename A, typename P, typename M, typename Record>
__device__ __forceinline__ void tiled_chain(const A& a, int transitions, const P& potential,
                                            const M& metric, int chain, int lane,
                                            const Record& record) {
  const bool live = chain < a.n_chains;
  const size_t row = static_cast<size_t>(live ? chain : 0) * a.dim;
  float q[K], g[K], lp = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) q[r] = g[r] = 0.f;
  if (live) {
    load_row(a.q, row, lane, a.dim, q);
    load_row(a.grad, row, lane, a.dim, g);
    lp = a.lp[chain];
  }
  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  for (int t = 0; t < transitions; ++t) {
    const size_t slot = static_cast<size_t>(t) * a.n_chains + chain;  // (T, C) index
    float p0[K], u = 1.f;
#pragma unroll
    for (int r = 0; r < K; ++r) p0[r] = 0.f;
    if (a.p0 != nullptr) {  // uniform across the grid
      if (live) {
        load_row(a.p0, slot * a.dim, lane, a.dim, p0);
        u = a.u[slot];
      }
    } else {
      philox_normal_row(p0, lane, a.dim, chain, a.call, static_cast<uint32_t>(t), a.key[0],
                        a.key[1]);
      metric.unwhiten(p0);
      u = philox_accept_uniform(chain, a.call, static_cast<uint32_t>(t), a.key[0], a.key[1]);
    }
    float q1[K], lp1, dh;
    const bool accept = transition<32, SHARED_FRICTION>(potential, metric, sc, a.num_steps,
                                                        a.schedule, lane, p0, u, q, g, lp, q1,
                                                        lp1, dh);
    if (live) record(slot, accept, dh, q, lp, q1, lp1);
  }
  if (!live) return;
  store_row(a.q_out, row, lane, a.dim, q);
  store_row(a.grad_out, row, lane, a.dim, g);
  if (lane == 0) a.lp_out[chain] = lp;
}

template <int K, bool DENSE, int C>
using TileMetric = typename std::conditional<DENSE, TiledDenseMetric<K, C>, DiagMetric<K>>::type;

// The tiled kernels' metric from their arguments' inv_mass, l_inv and dim
// (kernel 1's StepArgs, kernel 4's nuts::Args); DENSE: the block loads
// M^{-1} and L^{-1}, so every thread of the block calls this.
template <int K, bool DENSE, int C, typename A>
__device__ __forceinline__ TileMetric<K, DENSE, C> make_tile_metric(const A& a,
                                                                 const TileGeometry& geo,
                                                                 float* smem, int warp,
                                                                 int lane) {
  if constexpr (DENSE) {
    load_padded_metric(smem + geo.minv, smem + geo.linv, a.inv_mass, a.l_inv, a.dim, geo.dp);
    return TiledDenseMetric<K, C>{smem + geo.minv, smem + geo.linv, smem + geo.in, smem + geo.out,
                               geo.dim, geo.dp, geo.ps, warp, lane};
  } else {
    return DiagMetric<K>(a.inv_mass, lane, a.dim);
  }
}

// Variants 1a (DENSE, every family) and 1d (the hierarchical family, either
// metric): TileChains<FAMILY> chains a block, one transition, the proposal
// kept.
template <int FAMILY, int K, bool DENSE>
__global__ void __launch_bounds__(32 * TileChains<FAMILY>::value)
    grahmc_tiled_step_kernel(const StepArgs a, const TileGeometry geo) {
  constexpr int C = TileChains<FAMILY>::value;
  extern __shared__ float4 tile_smem[];
  float* smem = reinterpret_cast<float*>(tile_smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * C + warp;
  const TileMetric<K, DENSE, C> metric = make_tile_metric<K, DENSE, C>(a, geo, smem, warp, lane);
  const auto record = [&](size_t slot, bool accept, float dh, const float(&)[K], float,
                          const float(&q1)[K], float lp1) {
    store_row(a.prop_q, slot * a.dim, lane, a.dim, q1);
    if (lane == 0) {
      a.acc_out[slot] = accept;
      a.dh_out[slot] = dh;
      a.prop_lp[slot] = lp1;
    }
  };
  if constexpr (FAMILY == HIERARCHICAL_LOGISTIC) {
    tiled_chain<K, false>(a, 1, TiledHierarchical<K>(a.data, geo, smem, warp), metric, chain,
                          lane, record);
  } else {
    tiled_chain<K, false>(a, 1, Target<FAMILY, K>(a.dim, a.params, a.data), metric, chain, lane,
                          record);
  }
}

// Variant 2b (kernel 2 on the hierarchical family, either metric):
// HIER_TILE_CHAINS chains a block, T transitions a call, their chains in
// lockstep (L is uniform and no leapfrog exits early), every transition's
// state written to the history as grahmc_multistep_kernel writes it; the
// friction factors shared as kernel 2 shares them. Replaces the
// warp-per-chain 2b, where every chain read all of X twice a gradient from
// L1 with no load shared across chains.
template <int K, bool DENSE>
__global__ void __launch_bounds__(32 * HIER_TILE_CHAINS)
    grahmc_tiled_multistep_kernel(const MultiArgs a, const TileGeometry geo) {
  constexpr int C = HIER_TILE_CHAINS;
  extern __shared__ float4 tile_smem[];
  float* smem = reinterpret_cast<float*>(tile_smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * C + warp;
  const TileMetric<K, DENSE, C> metric = make_tile_metric<K, DENSE, C>(a, geo, smem, warp, lane);
  tiled_chain<K, true>(a, a.transitions, TiledHierarchical<K>(a.data, geo, smem, warp), metric,
                       chain, lane,
                       [&](size_t slot, bool accept, float dh, const float(&q)[K], float lp,
                           const float(&)[K], float) {
                         store_row(a.hist_q, slot * a.dim, lane, a.dim, q);
                         if (lane == 0) {
                           a.hist_lp[slot] = lp;
                           a.acc_out[slot] = accept;
                           a.dh_out[slot] = dh;
                         }
                       });
}

// Launch a tiled kernel (kernel 1's or 2's) for FAMILY: ceil(n_chains /
// chains) blocks, the geometry's shared memory (above 48 kB after opting
// in). Returns the launch's error; cudaErrorInvalidValue when no row tile
// fits.
template <int FAMILY, bool DENSE, typename Args>
cudaError_t launch_tiled(void (*kernel)(const Args, const TileGeometry), const Args& a,
                         cudaStream_t stream) {
  constexpr int C = TileChains<FAMILY>::value;
  const TileGeometry geo =
      tile_geometry(a.dim, a.data.n_data, DENSE, FAMILY == HIERARCHICAL_LOGISTIC);
  if (geo.bytes == 0) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.n_chains + C - 1) / C));
  kernel<<<grid, 32 * C, geo.bytes, stream>>>(a, geo);
  return cudaGetLastError();
}

}  // namespace mcmc
