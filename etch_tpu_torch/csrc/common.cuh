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

// Two floats as a bf16 pair (round to nearest even; `lo` at the lower
// address), and back.
__device__ __forceinline__ uint32_t etch_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 etch_unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// 16-byte global -> shared copy that bypasses L1, and its group bookkeeping.
__device__ __forceinline__ void etch_cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void etch_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void etch_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: each lane passes the shared address of one 16-byte row of an
// 8 x 8 bf16 matrix (lanes 8i..8i+7 address matrix i).  Without .trans lane
// l receives row l/4, columns 2(l%4), 2(l%4)+1 of each matrix (an MMA A
// fragment, or a B fragment of a matrix stored N-major); with .trans the
// transpose (a B fragment of a matrix stored K-major, row-major (k, n)).
__device__ __forceinline__ void etch_ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void etch_ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void etch_ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// d += a b on the tensor cores, bf16 operands, f32 accumulators.  Fragments
// (g = lane / 4, t = 2 (lane % 4)): d[0..1] row g, columns t, t+1; d[2..3]
// row g + 8.  m16n8k16: a[0] rows g, k t..t+1; a[1] row g + 8; a[2], a[3]
// the same at k + 8; b0 k t..t+1 of column g, b1 the same at k + 8.
__device__ __forceinline__ void etch_mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// m16n8k8: a0 row g, k t..t+1; a1 row g + 8; b k t..t+1 of column g.
__device__ __forceinline__ void etch_mma_1688(float (&d)[4], uint32_t a0, uint32_t a1,
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Raises a kernel's dynamic shared-memory limit above the 48 KB default.
template <typename Kernel>
static inline cudaError_t etch_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
