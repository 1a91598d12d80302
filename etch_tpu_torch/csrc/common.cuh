// Shared helpers of the port's CUDA kernels (built by etch_tpu_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ETCH_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

// bf16 <-> f32.  Rounding is to nearest even, as torch's .to(torch.bfloat16).
__device__ __forceinline__ float etch_f32(float x) { return x; }
__device__ __forceinline__ float etch_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float etch_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void etch_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void etch_store(bf16* p, float v) { *p = __float2bfloat16(v); }

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
