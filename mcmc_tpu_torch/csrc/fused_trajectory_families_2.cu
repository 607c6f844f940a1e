// Kernels 1 and 2 (fused_trajectory.cuh) for the families of
// MCMC_TRAJECTORY_FAMILIES_2: their dispatch_metric, which
// fused_trajectory.cu's entry points call. A translation unit of its own so
// that nvcc compiles it beside the others.

#include <cuda_runtime.h>

#include "fused_trajectory.cuh"

namespace mcmc {
#define MCMC_TRAJECTORY_INSTANTIATE(F) MCMC_TRAJECTORY_DISPATCH(template, F)
MCMC_TRAJECTORY_FAMILIES_2(MCMC_TRAJECTORY_INSTANTIATE)
#undef MCMC_TRAJECTORY_INSTANTIATE
}  // namespace mcmc
