// Kernel 4 (nuts_window.cuh) for the families of MCMC_NUTS_FAMILIES_3:
// their dispatch_variant, which fused_nuts.cu's launcher calls. A
// translation unit of its own so that nvcc compiles it beside the others.

#include <cuda_runtime.h>

#include "nuts_window.cuh"

namespace mcmc {
namespace nuts {
#define MCMC_NUTS_INSTANTIATE(F) template MCMC_NUTS_DISPATCH(F)
MCMC_NUTS_FAMILIES_3(MCMC_NUTS_INSTANTIATE)
#undef MCMC_NUTS_INSTANTIATE
}  // namespace nuts
}  // namespace mcmc
