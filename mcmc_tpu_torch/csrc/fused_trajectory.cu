// Fused GRAHMC/HMC transitions for NVIDIA Hopper (sm_90a).
//
// What each function replaces (TPU Pallas kernels of the JAX package):
//   grahmc_step_kernel      <- mcmc_tpu/ops/fused_trajectory.py:_make_kernel
//                              (with _integrate, _metric_ops, _gaussian and
//                              _bits_to_uniform; built by _build_call for
//                              make_fused_grahmc_step and make_debug_trajectory):
//                              one MH transition per chain.
//   grahmc_multistep_kernel <- mcmc_tpu/ops/fused_trajectory.py:_make_multistep_kernel
//                              (make_fused_grahmc_multistep): T transitions per
//                              call, writing per-transition accept, delta H and
//                              post-transition q and lp.
//   targets.cuh             <- mcmc_tpu/ops/padded_targets.py:_standard_normal,
//                              _neals_funnel (inlined into both kernels).
// Both kernels share one __device__ transition. Plain PyTorch versions of
// everything here live in mcmc_tpu_torch/ops/fused_trajectory.py.
//
// What bounds them on an H100: per transition a kernel reads and writes the
// chain state once -- q and grad in; q, grad and the proposal out -- about
// 5 x 13 MB at 65,536 chains x 50 dims in float32, ~20 us at 3.35 TB/s.
// Inside, each of the L substeps costs per chain one expf (the funnel's
// exp(-x0)) and about 10 flops per coordinate, plus two dependent warp
// reductions (5 shuffles each) per substep on the funnel. At L = 16 the
// arithmetic and the serial dependency chain of each chain's substeps, not
// device memory, set the time.
//
// Design: one warp per chain. Lane j holds coordinates j, j+32, j+64, j+96
// (K = ceil(D / 32) <= 4 registers each of q, p, grad and M^{-1}), and q, p
// and grad stay in registers for the whole trajectory -- in the multistep
// kernel for all T transitions -- so device memory sees the state once per
// call. Per-chain sums are __shfl_xor_sync butterflies; the funnel's neck
// coordinate is broadcast from lane 0 with __shfl_sync. The public (C, D)
// row-major layout is read and written as is: a warp touches one contiguous
// row, nothing is padded or transposed, and lanes past D hold zeros that no
// sum sees. 65,536 chains are 65,536 warps, enough to keep every SM's
// schedulers fed while each warp waits on its shuffles.
//
// Randomness: injected (p0, u pointers non-null) or Philox4x32-10 with key
// (key[0], key[1]) and counter (chain, call, transition, draw). Momentum
// coordinate d uses draw d / 4 (Box-Muller on words (x0, x1) for d % 4 in
// {0, 1} -- cos, sin -- and (x2, x3) for {2, 3}); the accept uniform uses
// word x0 of draw ACCEPT_DRAW.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math (the isfinite guard and the
// agreement of expf/logf/sinf/cosf with PyTorch depend on IEEE math).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_rows.cuh"
#include "philox.cuh"
#include "targets.cuh"

namespace mcmc {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_K = 4;  // registers per lane: dim <= 128
constexpr float ENERGY_OVERFLOW = 1e10f;
constexpr float PI_F = 3.141592653589793f;

// Must match SCHEDULE_IDS in mcmc_tpu_torch/ops/fused_trajectory.py.
enum Schedule { NO_FRICTION = 0, CONSTANT = 1, TANH = 2, SIGMOID = 3, LINEAR = 4, SINE = 5 };

struct Scalars {
  float eps, gamma, steep;
};

// gamma(t) of mcmc_tpu_torch/samplers/grahmc.py, same operation order.
__device__ __forceinline__ float friction(int schedule, float t, float T, float g, float s) {
  switch (schedule) {
    case CONSTANT:
      return t < T / 2.f ? -g : (t > T / 2.f ? g : 0.f);
    case TANH:
      return g * tanhf(s * (2.f * t / T - 1.f));
    case SIGMOID: {
      const float z = s * (t / T - 0.5f);
      return g * (2.f / (1.f + expf(-z)) - 1.f);
    }
    case LINEAR:
      return g * (2.f * t / T - 1.f);
    case SINE:
      return g * sinf(PI_F * (t / T - 0.5f));
    default:
      return 0.f;
  }
}

// One MH transition of the chain this warp holds. On entry (q, g, lp) is the
// current state; on exit the selected state. (q1, lp1) is the proposal and
// dh = H1 - H0. Returns the accept decision (uniform across the warp).
template <int FAMILY, int K>
__device__ __forceinline__ bool transition(const Target<FAMILY, K>& target, const Scalars& sc,
                                           int num_steps, int schedule, int lane,
                                           const float (&invm)[K], const float (&p0)[K],
                                           float u, float (&q)[K], float (&g)[K], float& lp,
                                           float (&q1)[K], float& lp1, float& dh) {
  float p[K], g1[K];
  float kin = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    q1[r] = q[r];
    g1[r] = g[r];
    p[r] = p0[r];
    kin += p[r] * (p[r] * invm[r]);
  }
  const float h0 = -lp + 0.5f * warp_sum(kin);

  const float half = 0.5f * sc.eps;
  const float total = sc.eps * static_cast<float>(num_steps);
  lp1 = lp;
  for (int i = 0; i < num_steps; ++i) {
    float scale = 1.f;
    if (schedule != NO_FRICTION) {
      // midpoint grid t = (i + 1/2) eps
      const float gt = friction(schedule, (static_cast<float>(i) + 0.5f) * sc.eps, total,
                                sc.gamma, sc.steep);
      scale = expf(-gt * half);
#pragma unroll
      for (int r = 0; r < K; ++r) p[r] *= scale;
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      p[r] += half * g1[r];
      q1[r] += sc.eps * (p[r] * invm[r]);
    }
    lp1 = target(q1, g1, lane);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      p[r] += half * g1[r];
      if (schedule != NO_FRICTION) p[r] *= scale;
    }
  }

  kin = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    p[r] = -p[r];
    kin += p[r] * (p[r] * invm[r]);
  }
  float h1 = -lp1 + 0.5f * warp_sum(kin);
  if (!isfinite(h1)) h1 = ENERGY_OVERFLOW;
  dh = h1 - h0;
  const float log_alpha = h0 - h1;
  const float log_u = logf(u);
  // log u < min(0, log_alpha); a NaN log_alpha rejects, as in PyTorch
  const bool accept = (log_u < 0.f) && (log_u < log_alpha);
  if (accept) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      q[r] = q1[r];
      g[r] = g1[r];
    }
    lp = lp1;
  }
  return accept;
}

struct StepArgs {
  int dim, n_chains, num_steps, schedule;
  const float* scalars;
  const uint32_t* key;
  uint32_t call;
  const float *q, *lp, *grad, *inv_mass, *p0, *u;
  float *q_out, *lp_out, *grad_out;
  bool* acc_out;
  float *dh_out, *prop_q, *prop_lp;
};

struct MultiArgs {
  int dim, n_chains, num_steps, schedule, transitions;
  const float* scalars;
  const uint32_t* key;
  uint32_t call;
  const float *q, *lp, *grad, *inv_mass, *p0, *u;
  float *q_out, *lp_out, *grad_out;
  bool* acc_out;
  float *dh_out, *hist_q, *hist_lp;
};

// Load this lane's coordinates of row `row` (zeros past dim) and M^{-1}
// (ones past dim).
template <int K>
__device__ __forceinline__ void load_state(const float* q_in, const float* g_in,
                                           const float* invm_in, size_t row, int lane,
                                           int dim, float (&q)[K], float (&g)[K],
                                           float (&invm)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    const bool valid = d < dim;
    q[r] = valid ? q_in[row + d] : 0.f;
    g[r] = valid ? g_in[row + d] : 0.f;
    invm[r] = valid ? invm_in[d] : 1.f;
  }
}

template <int FAMILY, int K>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) grahmc_step_kernel(const StepArgs a) {
  const int chain = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= a.n_chains) return;  // uniform across the warp

  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  const Target<FAMILY, K> target(a.dim);
  const size_t row = static_cast<size_t>(chain) * a.dim;
  float q[K], g[K], invm[K], p0[K];
  load_state(a.q, a.grad, a.inv_mass, row, lane, a.dim, q, g, invm);
  float lp = a.lp[chain];
  float u;
  if (a.p0 != nullptr) {
    load_row(a.p0, row, lane, a.dim, p0);
    u = a.u[chain];
  } else {
    philox_momentum(p0, invm, lane, a.dim, chain, a.call, 0u, a.key[0], a.key[1]);
    u = philox_accept_uniform(chain, a.call, 0u, a.key[0], a.key[1]);
  }

  float q1[K], lp1, dh;
  const bool accept =
      transition(target, sc, a.num_steps, a.schedule, lane, invm, p0, u, q, g, lp, q1, lp1, dh);

  store_row(a.q_out, row, lane, a.dim, q);
  store_row(a.grad_out, row, lane, a.dim, g);
  store_row(a.prop_q, row, lane, a.dim, q1);
  if (lane == 0) {
    a.lp_out[chain] = lp;
    a.acc_out[chain] = accept;
    a.dh_out[chain] = dh;
    a.prop_lp[chain] = lp1;
  }
}

template <int FAMILY, int K>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    grahmc_multistep_kernel(const MultiArgs a) {
  const int chain = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= a.n_chains) return;

  const Scalars sc{a.scalars[0], a.scalars[1], a.scalars[2]};
  const Target<FAMILY, K> target(a.dim);
  const size_t row = static_cast<size_t>(chain) * a.dim;
  float q[K], g[K], invm[K];
  load_state(a.q, a.grad, a.inv_mass, row, lane, a.dim, q, g, invm);
  float lp = a.lp[chain];

  for (int t = 0; t < a.transitions; ++t) {
    const size_t slot = static_cast<size_t>(t) * a.n_chains + chain;  // (T, C) index
    const size_t trow = slot * a.dim;                                  // (T, C, D) row
    float p0[K], u;
    if (a.p0 != nullptr) {
      load_row(a.p0, trow, lane, a.dim, p0);
      u = a.u[slot];
    } else {
      philox_momentum(p0, invm, lane, a.dim, chain, a.call, static_cast<uint32_t>(t),
                      a.key[0], a.key[1]);
      u = philox_accept_uniform(chain, a.call, static_cast<uint32_t>(t), a.key[0], a.key[1]);
    }
    float q1[K], lp1, dh;
    const bool accept = transition(target, sc, a.num_steps, a.schedule, lane, invm, p0, u,
                                   q, g, lp, q1, lp1, dh);
    store_row(a.hist_q, trow, lane, a.dim, q);
    if (lane == 0) {
      a.hist_lp[slot] = lp;
      a.acc_out[slot] = accept;
      a.dh_out[slot] = dh;
    }
  }
  store_row(a.q_out, row, lane, a.dim, q);
  store_row(a.grad_out, row, lane, a.dim, g);
  if (lane == 0) a.lp_out[chain] = lp;
}

template <template <int, int> class Launch, int FAMILY, typename Args>
cudaError_t dispatch_k(const Args& a, cudaStream_t stream) {
  switch ((a.dim + 31) / 32) {
    case 1: return Launch<FAMILY, 1>::run(a, stream);
    case 2: return Launch<FAMILY, 2>::run(a, stream);
    case 3: return Launch<FAMILY, 3>::run(a, stream);
    case 4: return Launch<FAMILY, 4>::run(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int> class Launch, typename Args>
cudaError_t dispatch(int family, const Args& a, cudaStream_t stream) {
  if (a.dim < 1 || a.dim > 32 * MAX_K || a.n_chains < 1 || a.num_steps < 0) {
    return cudaErrorInvalidValue;
  }
  switch (family) {
    case STANDARD_NORMAL: return dispatch_k<Launch, STANDARD_NORMAL>(a, stream);
    case NEALS_FUNNEL: return dispatch_k<Launch, NEALS_FUNNEL>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline dim3 grid_for(int n_chains) {
  return dim3(static_cast<unsigned>((n_chains + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
}

template <int FAMILY, int K>
struct StepLaunch {
  static cudaError_t run(const StepArgs& a, cudaStream_t stream) {
    grahmc_step_kernel<FAMILY, K><<<grid_for(a.n_chains), WARPS_PER_BLOCK * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
};

template <int FAMILY, int K>
struct MultiLaunch {
  static cudaError_t run(const MultiArgs& a, cudaStream_t stream) {
    grahmc_multistep_kernel<FAMILY, K>
        <<<grid_for(a.n_chains), WARPS_PER_BLOCK * 32, 0, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace mcmc

// Plain C entry points, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// Pointers are device pointers; p0/u null selects the in-kernel Philox draws
// (then key must be non-null). Each returns the launch's cudaError_t.
extern "C" int grahmc_step_launch(int family, int dim, int n_chains, int num_steps,
                                  int schedule, const float* scalars, const uint32_t* key,
                                  unsigned int call, const float* q, const float* lp,
                                  const float* grad, const float* inv_mass, const float* p0,
                                  const float* u, float* q_out, float* lp_out,
                                  float* grad_out, bool* acc_out, float* dh_out,
                                  float* prop_q, float* prop_lp, void* stream) {
  if (p0 == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const mcmc::StepArgs a{dim,    n_chains, num_steps, schedule, scalars, key,     call,
                         q,      lp,       grad,      inv_mass, p0,      u,       q_out,
                         lp_out, grad_out, acc_out,   dh_out,   prop_q,  prop_lp};
  return static_cast<int>(
      mcmc::dispatch<mcmc::StepLaunch>(family, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int grahmc_multistep_launch(int family, int dim, int n_chains, int num_steps,
                                       int schedule, int transitions, const float* scalars,
                                       const uint32_t* key, unsigned int call,
                                       const float* q, const float* lp, const float* grad,
                                       const float* inv_mass, const float* p0,
                                       const float* u, float* q_out, float* lp_out,
                                       float* grad_out, bool* acc_out, float* dh_out,
                                       float* hist_q, float* hist_lp, void* stream) {
  if (p0 == nullptr && key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (transitions < 1) return static_cast<int>(cudaErrorInvalidValue);
  const mcmc::MultiArgs a{dim,    n_chains, num_steps, schedule, transitions, scalars, key,
                          call,   q,        lp,        grad,     inv_mass,    p0,      u,
                          q_out,  lp_out,   grad_out,  acc_out,  dh_out,      hist_q,  hist_lp};
  return static_cast<int>(
      mcmc::dispatch<mcmc::MultiLaunch>(family, a, static_cast<cudaStream_t>(stream)));
}
