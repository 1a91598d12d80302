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

// f32 -> tf32 (round to nearest, ties away; the low 13 bits of the result
// are zero), and the split x = hi + lo that 3xTF32 products use: both halves
// are tf32 values, and hi + lo is x to within 2^-21 relative.
__device__ __forceinline__ uint32_t etch_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void etch_split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = etch_tf32(x);
  lo = etch_tf32(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, tf32 operands, f32 accumulators (g = lane / 4, t =
// lane % 4): a[0] row g, k t; a[1] row g + 8, k t; a[2], a[3] the same at
// k t + 4; b0 k t of column g, b1 k t + 4; d as for the bf16 products.
__device__ __forceinline__ void etch_mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0).
__device__ __forceinline__ float etch_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier of the 128 threads of one 4-warp group (named barrier group + 1;
// 0 is __syncthreads').
__device__ __forceinline__ void etch_group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// Row softmax of the logits S of a warp's 16 query rows (rows g and g + 8,
// 64 keys as 8 n8 accumulator tiles) in place, keys >= L masked to -inf;
// returns a = bf16(exp(z - m) * (1 / den)) as the four m16 x k16 A fragments
// of the product a v.  The max and the sum run over the 4 lanes of a row.
// exp(z - m) is 2^(z log2(e) - m log2(e)): one FMA and one ex2.approx
// (relative error about 2^-22, where expf takes some ten instructions for
// 2^-23); the bf16 rounding of a absorbs the difference but for a value at a
// rounding boundary, as it absorbs the summation order.
__device__ __forceinline__ void etch_softmax_frags(float (&s)[8][4], int L,
                                                   uint32_t (&p)[4][4]) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int t2 = 2 * (threadIdx.x & 3);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    if (8 * jt + 8 > L) {   // the tile holds padded keys
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * jt + t2 + (e & 1) >= L) s[jt][e] = -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[jt][e]);
  }
  float den[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
  for (int jt = 0; jt < 8; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[jt][e] = etch_ex2(fmaf(s[jt][e], kLog2e, -ml[e >> 1]));   // exp(z - m)
      den[e >> 1] += s[jt][e];
    }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    inv[h] = 1.f / den[h];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        p[t][2 * j + h] = etch_pack_bf16(s[2 * t + j][2 * h] * inv[h],
                                         s[2 * t + j][2 * h + 1] * inv[h]);
}

// Per-head attention of one warp's 16 query rows over 64 keys on the tensor
// cores, shared by the direction core and the anchor attention.  k and v are
// bf16 rows in shared memory (row stride ld elements, 16-byte aligned),
// finite in rows L..63, whose keys are masked to -inf; the softmax takes its
// max per (query, head).

// The heads of one 8-column tile, head size HS in {1, 2, 4, 8} (8 also takes
// 3, 5, 6 and 7 padded by zero columns): S = q_h k_h^T by m16n8k8, with q
// masked to each head's own columns where several heads share the tile
// (exact: the other columns add zeros).  qa(a0, a1) writes q's m16n8k8 A
// fragment of the tile, called once k and v are requested; ks, vs: the
// tile's first column.  Returns the tile's f32 output fragment in ot.
template <int HS, typename QA>
__device__ __forceinline__ void etch_attention_tile8(QA qa, const bf16* ks, const bf16* vs,
                                                     int ld, int L, float (&ot)[4]) {
  constexpr int kHeadsPerTile = 8 / HS;
  const int lane = threadIdx.x & 31, t2 = 2 * (lane & 3);
  uint32_t kb[2][4], vb[2][4];   // keys 0-31 and 32-63
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    etch_ldsm_x4(kb[u], ks + (32 * u + lane) * ld);
    etch_ldsm_x4_trans(vb[u], vs + (32 * u + lane) * ld);
  }
  uint32_t qa0, qa1;
  qa(qa0, qa1);
#pragma unroll
  for (int e = 0; e < 4; ++e) ot[e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < kHeadsPerTile; ++hh) {
    const bool own0 = t2 / HS == hh, own1 = (t2 + 1) / HS == hh;
    const uint32_t mask = (own0 ? 0x0000ffffu : 0u) | (own1 ? 0xffff0000u : 0u);
    float s[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][e] = 0.f;
      etch_mma_1688(s[jt], qa0 & mask, qa1 & mask, kb[jt >> 2][jt & 3]);
    }
    uint32_t p[4][4];
    etch_softmax_frags(s, L, p);
    float oh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      etch_mma_16816(oh, p[t], vb[t >> 1][2 * (t & 1)], vb[t >> 1][2 * (t & 1) + 1]);
    if (own0) {
      ot[0] = oh[0];
      ot[2] = oh[2];
    }
    if (own1) {
      ot[1] = oh[1];
      ot[3] = oh[3];
    }
  }
}

// Logits of one head's 16 * nk16 columns (nk16 <= KT): s += q_h k_h^T in
// nk16 k16 steps of m16n8k16 over the 64 keys.  qa(kt, a) writes q's A
// fragment of the columns 16 kt .. 16 kt + 15; ks: the columns' first one.
// A head wider than shared memory holds adds its column slices in turn.
template <int KT, typename QA>
__device__ __forceinline__ void etch_attention_logits16(QA qa, const bf16* ks, int ld, int nk16,
                                                        float (&s)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nk16) {
      uint32_t a[4];
      qa(kt, a);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {   // keys 16 jj .. 16 jj + 15
        uint32_t kb[4];
        etch_ldsm_x4(kb, ks + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * kt +
                             ((lane >> 3) & 1) * 8);
        etch_mma_16816(s[2 * jj], a, kb[0], kb[1]);
        etch_mma_16816(s[2 * jj + 1], a, kb[2], kb[3]);
      }
    }
  }
}

// o_h = a v_h over 16 * nk16 columns (nk16 <= KT), 16 at a time: a is the
// softmax's A fragments (etch_softmax_frags); emit(j, o0, o1) takes the f32
// output fragments of the columns 16 j .. + 7 and 16 j + 8 .. + 15; vs: the
// columns' first one.
template <int KT, typename Emit>
__device__ __forceinline__ void etch_attention_pv16(const uint32_t (&p)[4][4], const bf16* vs,
                                                    int ld, int nk16, Emit emit) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < nk16) {
      float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t vb[4];
        etch_ldsm_x4_trans(vb, vs + (16 * t + (lane & 15)) * ld + 16 * j + (lane >> 4) * 8);
        etch_mma_16816(o0, p[t], vb[0], vb[1]);
        etch_mma_16816(o1, p[t], vb[2], vb[3]);
      }
      emit(j, o0, o1);
    }
  }
}

// One head of 16 * nk16 columns (nk16 <= KT): its logits, the softmax and
// the product with v (above).
template <int KT, typename QA, typename Emit>
__device__ __forceinline__ void etch_attention_head16(QA qa, const bf16* ks, const bf16* vs,
                                                      int ld, int L, int nk16, Emit emit) {
  float s[8][4];
#pragma unroll
  for (int jt = 0; jt < 8; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[jt][e] = 0.f;
  etch_attention_logits16<KT>(qa, ks, ld, nk16, s);
  uint32_t p[4][4];
  etch_softmax_frags(s, L, p);
  etch_attention_pv16<KT>(p, vs, ld, nk16, emit);
}

// The anchor attention (csrc/attention.cu) on M points of L rows of q, k
// and v with a row stride of ldr >= E elements, E = H heads of E / H
// columns (q pre-scaled); out has the same rows, bf16 when out_bf16, else
// f32.  Returns a cudaError_t.
int etch_attention_rows(const void* q, const void* k, const void* v, void* out, int out_bf16,
                        int M, int L, int E, int H, int ldr, cudaStream_t stream);

// Raises a kernel's dynamic shared-memory limit above the 48 KB default.
template <typename Kernel>
static inline cudaError_t etch_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
