// Shared helpers of the port's CUDA kernels (built by etch_tpu_torch/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ETCH_API extern "C" __attribute__((visibility("default")))

// Squared distance with every rounding step explicit: (dx*dx + dy*dy) + dz*dz,
// never contracted into an FMA.  The plain PyTorch versions evaluate the same
// expression op by op, so neighbour and sampling indices match bit for bit.
__device__ __forceinline__ float etch_sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Raises a kernel's dynamic shared-memory limit above the 48 KB default.
template <typename Kernel>
static inline cudaError_t etch_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
