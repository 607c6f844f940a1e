// Fused GRAHMC/HMC transitions for NVIDIA Hopper (sm_90a), diagonal and
// dense metric.
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
//   The template flag DENSE is the TPU kernels' `dense` flag (variants 1a
//   and 2a): M^{-1} is a (D, D) matrix, the momentum is z @ L^{-1} with
//   M^{-1} = L L^T, and every velocity and kinetic energy is a D x D product
//   (metric.cuh; for 1a the block-tiled products of tiled_step.cuh).
//   targets.cuh             <- mcmc_tpu/ops/padded_targets.py:_BUILDERS, all 14
//                              families (inlined).
//   The family HIERARCHICAL_LOGISTIC is the TPU kernels' data-carrying form
//   (variants 1d and 2b: the target's `data_arrays` refs): the design matrix
//   and labels in device memory (struct TargetData). That target's
//   likelihood, two products with X per evaluation, not the state traffic,
//   sets those variants' time: kernels 1 (1d, and 1a's data form) and 2
//   (2b, either metric) compute it for a block of chains at once
//   (tiled_step.cuh:TiledHierarchical).
// The kernels and their launchers are in fused_trajectory.cuh; this file
// holds the entry points, and fused_trajectory_families_{1,2,3}.cu
// instantiate ten of the families so that nvcc compiles four sources at once.
// Both kernels share one __device__ transition (trajectory.cuh) with the
// scaled and bridged variants of kernel 1 (fused_trajectory_scaled.cu,
// fused_trajectory_bridged.cu). Plain PyTorch versions of everything here
// live in mcmc_tpu_torch/ops/fused_trajectory.py.
//
// What bounds them on an H100: per transition a kernel reads and writes the
// chain state once -- q and grad in; q, grad and the proposal out -- about
// 5 x 13 MB at 65,536 chains x 50 dims in float32, ~20 us at 3.35 TB/s.
// Inside, each of the L substeps costs per chain about 10 instructions per
// coordinate slot (64 at D = 50) and a per-chain part that does not scale
// with D: the friction factor (an expf, a tanhf under tanh), the funnel's
// exp(-x0) and neck broadcast, the lane-0 gradient, two butterflies; the
// momentum draw a Philox block per coordinate. Warp per chain, every lane
// issues that per-chain part, so kernel 1 was issue-bound at 8x its memory
// bound (0.160 ms at 65,536 x 50 on the funnel, L = 16, H100 80GB HBM3 at
// 700 W): the NO_FRICTION schedule took 20% off, injected draws 24%, the
// standard normal's simpler functor 21%, D = 64 (no padding slots) none
// (experiments/torch_step_kernel_timing.py, PERF.md section 6). The dense variants
// add L + 3 D x D products per transition (the unwhitening, two kinetic
// energies, a velocity per substep), 2 D^2 flops each per chain, every
// multiply-add reading one word of shared memory: those products set their
// time (kernel 1's 1a and 1d compute them block-tiled, tiled_step.cuh).
//
// Design: one warp per chain, or in kernel 1's diagonal instances without
// data (and 1b's) on the GROUPED_FAMILY targets a group of G lanes per
// chain (trajectory.cuh). Warp per chain, lane j holds coordinates j, j+32,
// j+64, j+96 (K = ceil(D / 32) <= 4 registers each of q, p and grad; the
// diagonal of M^{-1} too under the diagonal metric), and q, p and grad stay
// in registers for the whole trajectory -- in the multistep kernel for all
// T transitions -- so device memory sees the state once per call. Per-chain
// sums are __shfl_xor_sync butterflies; the funnel's neck coordinate is
// broadcast from lane 0 with __shfl_sync. The public (C, D) row-major layout
// is read and written as is: a warp touches one contiguous row, nothing is
// padded or transposed, and lanes past D hold zeros. Lane groups keep the
// coordinate slots (a lane holds the 32 / G warp-per-chain lanes j + G m)
// and divide the per-chain part by the 32 / G chains a warp: a lane folds
// its partials in registers where the butterfly's levels 16 .. G were, the
// group draws each Philox block once and computes G substeps' friction
// factors at once, bit for bit the warp-per-chain kernel. step_lanes takes
// the fewest lanes that keep 2,048 warps in the launch (4 at K = 1, 8 at K
// = 2, 16 at K >= 3), else a warp per chain: 0.1605 -> 0.0694 ms at 65,536
// x 50 and 1b 0.1604 -> 0.0323 at 6 x 8,192 x 10, while groups of 4 at
// 2,048 x 20 and 1,024 x 10 lost 13-270% to the warp kernel, their few
// warps waiting on each lane's longer stream. Kernel 2 shares the friction
// factors too (-14% at 4,096 x 50, T = 8) and runs the same lane groups
// (0.0807 -> 0.0529 ms there). Its other launches hold ~8 warps an SM
// (1,024 chains), so each chain's in-order stream sets their time: every
// substep but a trajectory's last computes the gradient alone, without the
// log-density's butterfly and terms (the sweep's families -13 to -40%, 2a
// on Rosenbrock 0.2269 -> 0.1791 ms), and a launch too small to give every
// SM a block of 8 warps takes blocks of 4 or 2 (the nested shells -4%).
// Launching the next transition's draws before the trajectory, the
// friction factors once a launch and 2a's M^{-1} in registers lost as
// often as they won, and were left out. The same peel in kernels 1, 1b,
// 1c, 1a, 1d and 2b ran up to 30% faster (1c) but made 62 of their
// instances spill anew or more, so they sum the lp at every substep
// (trajectory.cuh:transition's LP_LAST off; H100 80GB HBM3 at 700 W,
// PERF.md section 6). Under DENSE the block's warps share one copy of
// M^{-1} and L^{-1} in shared memory (20 kB at D = 50, 128 kB at D = 128),
// and the leapfrog's products are rounded before their sums (add_scaled):
// under an ill-conditioned metric a rounding difference would grow along
// the trajectory away from the plain version's.
//
// Randomness: injected (p0, u pointers non-null; p0 is the momentum, already
// unwhitened) or Philox4x32-10 with key (key[0], key[1]) and counter (chain,
// call, transition, draw). Standard normal z_d uses draw d / 4 (Box-Muller on
// words (x0, x1) for d % 4 in {0, 1} -- cos, sin -- and (x2, x3) for
// {2, 3}), unwhitened to the momentum by the metric; the accept uniform uses
// word x0 of draw ACCEPT_DRAW.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math (the isfinite guard and the
// agreement of expf/logf/sinf/cosf with PyTorch depend on IEEE math).

#include <cstdint>
#include <cuda_runtime.h>

#include "fused_trajectory.cuh"

namespace mcmc {
#define MCMC_TRAJECTORY_EXTERN(F) MCMC_TRAJECTORY_DISPATCH(extern template, F)
MCMC_TRAJECTORY_FAMILIES_1(MCMC_TRAJECTORY_EXTERN)
MCMC_TRAJECTORY_FAMILIES_2(MCMC_TRAJECTORY_EXTERN)
MCMC_TRAJECTORY_FAMILIES_3(MCMC_TRAJECTORY_EXTERN)
#undef MCMC_TRAJECTORY_EXTERN
}  // namespace mcmc

// Plain C entry points, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// Pointers are device pointers except `target_params`, a host TargetParams,
// and `data`, a host TargetData of device pointers
// (null for a family without data). p0/u null selects the in-kernel Philox
// draws (then key must be non-null). `dense` selects the dense metric: inv_mass is then
// (dim, dim) and l_inv its (dim, dim) factor L^{-1}, required. Each returns
// the launch's cudaError_t.
extern "C" int grahmc_step_launch(int family, int dim, int n_chains, int num_steps,
                                  int schedule, int dense, const mcmc::TargetParams* target_params,
                                  const mcmc::TargetData* data, const float* scalars,
                                  const uint32_t* key, unsigned int call,
                                  const float* q, const float* lp, const float* grad,
                                  const float* inv_mass, const float* l_inv, const float* p0,
                                  const float* u, float* q_out, float* lp_out,
                                  float* grad_out, bool* acc_out, float* dh_out,
                                  float* prop_q, float* prop_lp, void* stream) {
  if ((p0 == nullptr && key == nullptr) || target_params == nullptr ||
      (dense && l_inv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc::StepArgs a{};
  a.dim = dim, a.n_chains = n_chains, a.num_steps = num_steps, a.schedule = schedule;
  a.params = *target_params;
  a.data = mcmc::target_data(data);
  a.scalars = scalars, a.key = key, a.call = call;
  a.q = q, a.lp = lp, a.grad = grad, a.inv_mass = inv_mass, a.l_inv = l_inv;
  a.p0 = p0, a.u = u;
  a.q_out = q_out, a.lp_out = lp_out, a.grad_out = grad_out, a.acc_out = acc_out;
  a.dh_out = dh_out, a.prop_q = prop_q, a.prop_lp = prop_lp;
  return static_cast<int>(mcmc::dispatch<mcmc::StepLaunch>(family, dense != 0, a,
                                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int grahmc_multistep_launch(int family, int dim, int n_chains, int num_steps,
                                       int schedule, int transitions, int dense,
                                       const mcmc::TargetParams* target_params,
                                       const mcmc::TargetData* data, const float* scalars,
                                       const uint32_t* key, unsigned int call,
                                       const float* q, const float* lp, const float* grad,
                                       const float* inv_mass, const float* l_inv,
                                       const float* p0, const float* u, float* q_out,
                                       float* lp_out, float* grad_out, bool* acc_out,
                                       float* dh_out, float* hist_q, float* hist_lp,
                                       void* stream) {
  if ((p0 == nullptr && key == nullptr) || target_params == nullptr ||
      (dense && l_inv == nullptr) || transitions < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mcmc::MultiArgs a{};
  a.dim = dim, a.n_chains = n_chains, a.num_steps = num_steps, a.schedule = schedule;
  a.transitions = transitions;
  a.params = *target_params;
  a.data = mcmc::target_data(data);
  a.scalars = scalars, a.key = key, a.call = call;
  a.q = q, a.lp = lp, a.grad = grad, a.inv_mass = inv_mass, a.l_inv = l_inv;
  a.p0 = p0, a.u = u;
  a.q_out = q_out, a.lp_out = lp_out, a.grad_out = grad_out, a.acc_out = acc_out;
  a.dh_out = dh_out, a.hist_q = hist_q, a.hist_lp = hist_lp;
  return static_cast<int>(mcmc::dispatch<mcmc::MultiLaunch>(family, dense != 0, a,
                                                            static_cast<cudaStream_t>(stream)));
}

// The block-tiled kernel 1's geometry for (dim, n_data) under the metric and
// data flags: returns its dynamic shared memory in bytes (0: no row tile
// fits) and writes the chains per block and the data rows per tile; the
// wrapper's tile_geometry must agree.
extern "C" int grahmc_tile_geometry(int dim, int n_data, int dense, int data, int* chains,
                                    int* rows) {
  const mcmc::TileGeometry g = mcmc::tile_geometry(dim, n_data, dense != 0, data != 0);
  *chains = mcmc::tile_chains(data != 0);
  *rows = g.rows;
  return g.bytes;
}
