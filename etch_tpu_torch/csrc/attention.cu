// Per-point multi-head attention over the anchor tokens.
//
// Replaces etch_tpu/nn/pallas_attention.py:attention_pallas (_kernel), the
// attention of the chunked bf16 direction head.  Per point, on its (L, E)
// bf16 q (pre-scaled by 1/sqrt(hs)), k and v, for every query i and head h:
//
//   z_j  = sum_d q[i, h*hs + d] k[j, h*hs + d]          (f32, j < L)
//   m    = max_j z_j                                    (per query and head)
//   a_j  = bf16(exp(z_j - m) * (1 / sum_j exp(z_j - m)))
//   out[i, h*hs + d] = sum_j a_j v[j, h*hs + d]         (f32)
//
// The max is per (query, head), as the TPU kernel's per-block max: a max over
// all heads underflows a head whose logits lie far below another's (0 / 0).
//
// The TPU kernel expands k and v block-diagonally by head (pltpu.repeat and
// a mask) and broadcasts maxima and denominators with one-hot matmuls, all to
// give its matrix unit (L, H*L)-shaped products; none of that is carried over.
//
// Bound on the H100: FP32 instruction rate and shared-memory reads.  At L=60, E=64,
// 8 heads a point costs 3 * L * L * E = 0.7 M FMAs (three passes over the
// keys) and 23 KB of operands, about 30 FMAs a byte.  Design: one block per
// point; k and v are converted to f32 in shared memory (2 * L * E * 4 bytes,
// 30 KB at E=64); one thread per (query, head) holds its q slice and output in
// registers and makes three passes over the L keys (max, denominator, weighted
// sum), so no logits are stored.  Head size 8 is below the tensor cores' MMA
// depth of 16; wgmma and several points per block are later work.
#include "common.cuh"

namespace {

// grid (M); block min(1024, L*H rounded up to a warp).  HS: the head size
// when EXACT, else a bound on the runtime head size E / H.
template <int HS, bool EXACT>
__global__ void attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, float* __restrict__ out, int L,
                                 int E, int H) {
  extern __shared__ float smem[];
  float* ks = smem;           // L * E
  float* vs = ks + L * E;     // L * E
  const size_t base = static_cast<size_t>(blockIdx.x) * L * E;
  for (int e = threadIdx.x; e < L * E; e += blockDim.x) {
    ks[e] = etch_f32(k[base + e]);
    vs[e] = etch_f32(v[base + e]);
  }
  __syncthreads();
  const int hs = EXACT ? HS : E / H;
  for (int p = threadIdx.x; p < L * H; p += blockDim.x) {
    const int i = p / H, c0 = (p % H) * hs;
    const float* kc = ks + c0;
    const float* vc = vs + c0;
    float qv[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) qv[d] = d < hs ? etch_f32(q[base + i * E + c0 + d]) : 0.f;
    auto logit = [&](int j) {
      float z = 0.f;
#pragma unroll
      for (int d = 0; d < HS; ++d)
        if (d < hs) z = fmaf(qv[d], kc[j * E + d], z);
      return z;
    };
    float m = -INFINITY;
    for (int j = 0; j < L; ++j) m = fmaxf(m, logit(j));
    float den = 0.f;
    for (int j = 0; j < L; ++j) den += expf(logit(j) - m);
    const float inv = 1.f / den;
    float o[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) o[d] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float a = etch_round_bf16(expf(logit(j) - m) * inv);
#pragma unroll
      for (int d = 0; d < HS; ++d)
        if (d < hs) o[d] = fmaf(a, vc[j * E + d], o[d]);
    }
    float* op = out + base + i * E + c0;
#pragma unroll
    for (int d = 0; d < HS; ++d)
      if (d < hs) op[d] = o[d];
  }
}

template <int HS, bool EXACT>
int launch(const bf16* q, const bf16* k, const bf16* v, float* out, int M, int L, int E,
           int H, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(L) * E * sizeof(float);
  cudaError_t err = etch_allow_smem(attention_kernel<HS, EXACT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (L * H + 31) / 32 * 32;
  const int threads = want < 1024 ? want : 1024;
  attention_kernel<HS, EXACT><<<M, threads, smem, stream>>>(q, k, v, out, L, E, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (M, L, E) bf16 -> out (M, L, E) f32.  E <= 128 and H divides E; a
// power-of-two head size is compiled exactly, any other is bounded by the
// next power of two.
ETCH_API int etch_attention(const void* q, const void* k, const void* v, float* out, int M,
                            int L, int E, int H, cudaStream_t stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  if (H < 1 || E % H != 0 || E > 128) return static_cast<int>(cudaErrorInvalidValue);
  switch (E / H) {
    case 1: return launch<1, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 2: return launch<2, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 4: return launch<4, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 8: return launch<8, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 16: return launch<16, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 32: return launch<32, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 64: return launch<64, true>(qb, kb, vb, out, M, L, E, H, stream);
    case 128: return launch<128, true>(qb, kb, vb, out, M, L, E, H, stream);
    default: break;
  }
  const int hs = E / H;
  if (hs < 4) return launch<4, false>(qb, kb, vb, out, M, L, E, H, stream);
  if (hs < 8) return launch<8, false>(qb, kb, vb, out, M, L, E, H, stream);
  if (hs < 16) return launch<16, false>(qb, kb, vb, out, M, L, E, H, stream);
  if (hs < 32) return launch<32, false>(qb, kb, vb, out, M, L, E, H, stream);
  if (hs < 64) return launch<64, false>(qb, kb, vb, out, M, L, E, H, stream);
  return launch<128, false>(qb, kb, vb, out, M, L, E, H, stream);
}
