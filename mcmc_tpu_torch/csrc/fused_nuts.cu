// Fused persistent-NUTS window for NVIDIA Hopper (sm_90a): the plain C entry
// points. The kernels (warp-per-chain, and block-tiled for the data-carrying
// target), their launch and their dispatch over K, scheme and metric are
// in nuts_window.cuh, which says what the kernels replace and how they are
// built. This file instantiates them for the standard normal, Neal's funnel,
// the correlated Gaussian and the mixture; fused_nuts_families_1.cu, _2.cu
// and _3.cu instantiate the other families, so the four compile in parallel.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "nuts_window.cuh"

namespace mcmc {
namespace nuts {
#define MCMC_NUTS_EXTERN(F) extern template MCMC_NUTS_DISPATCH(F)
MCMC_NUTS_FAMILIES_1(MCMC_NUTS_EXTERN)
MCMC_NUTS_FAMILIES_2(MCMC_NUTS_EXTERN)
MCMC_NUTS_FAMILIES_3(MCMC_NUTS_EXTERN)
#undef MCMC_NUTS_EXTERN
}  // namespace nuts
}  // namespace mcmc

// Plain C entry point, bound with ctypes by mcmc_tpu_torch/ops/_cuda.py.
// `multinomial` and `dense` pick the variant. `target_params` is a host
// TargetParams, `data` a host TargetData of device
// pointers (null for a family without data). `state` is a host array of the 42
// device pointers of struct State, in its order (the last 9 null without
// `multinomial`); `draws` a host array of the 6 injected draw pointers, or
// null for the in-kernel Philox draws (then key must be non-null). `l_inv`
// is needed with `dense`. The kernel updates the state in place. Returns the
// launch's cudaError_t.
extern "C" int nuts_window_launch(int family, int dim, int n_chains, int n_iters, int slots,
                                  int max_tree_depth, int multinomial, int dense,
                                  const mcmc::TargetParams* target_params,
                                  const mcmc::TargetData* data,
                                  const float* scalars, const float* inv_mass,
                                  const float* l_inv, const uint32_t* key,
                                  unsigned int call, void* const* state, void* const* draws,
                                  void* stream) {
  using namespace mcmc;
  if (state == nullptr || target_params == nullptr || (draws == nullptr && key == nullptr) ||
      (dense && l_inv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim < 1 || dim > 32 * MAX_K || n_chains < 1 || n_iters < 1 || slots < 1 ||
      max_tree_depth < 1 || max_tree_depth > 30 || !valid_data(family, target_data(data))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nuts::Args a{};
  a.dim = dim, a.n_chains = n_chains, a.n_iters = n_iters, a.slots = slots;
  a.max_tree_depth = max_tree_depth, a.scalars = scalars, a.inv_mass = inv_mass;
  a.l_inv = l_inv, a.key = key, a.call = call;
  a.params = *target_params;
  a.data = target_data(data);
  std::memcpy(&a.s, state, sizeof(nuts::State));
  if (draws != nullptr) std::memcpy(&a.d, draws, sizeof(nuts::Draws));
  if (multinomial && (a.s.q_sub == nullptr || a.s.q_stk == nullptr || a.s.p_stk == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool multi = multinomial != 0, dns = dense != 0;
  switch (family) {
#define MCMC_CASE(F) \
  case F: return static_cast<int>(nuts::dispatch_variant<F>(a, multi, dns, s));
    MCMC_FAMILIES(MCMC_CASE)
#undef MCMC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tiled window's geometry (nuts_window.cuh:window_tile_geometry) for dim
// under the metric flag: returns its dynamic shared memory in bytes (0: no
// row tile fits) and writes the chains per block and the data rows per
// tile; the wrapper's tile_geometry must agree.
extern "C" int nuts_tile_geometry(int dim, int dense, int* chains, int* rows) {
  const mcmc::TileGeometry g = mcmc::nuts::window_tile_geometry(dim, dense != 0);
  *chains = mcmc::nuts::WINDOW_TILE_CHAINS;
  *rows = g.rows;
  return g.bytes;
}
