// Direction-head core, one point per block, everything in shared memory.
//
// Replaces etch_tpu/nn/pallas_dircore.py:direction_core_pallas (_kernel).
// Per point, on its 60 anchor tokens x (60, E=64) bf16:
//
//   layer 0: q = bf16(x Wq0 / sqrt(hs)), k = bf16(x Wk0), v = bf16(x Wv0)
//            per head h: a = bf16(softmax(q_h k_h^T)), o_h = a v_h (f32)
//            x = bf16(x + bf16(o) Wc0 + bc0)                    (residual)
//   layer 1: the same attention on x, then x = bf16(bf16(o) Wc1 + bc1)  (E -> V)
//   MLP:     x = bf16(relu(x Wm0 + bm0)); y = x Wm1 + bm1 (f32)
//   out[a] = sum_j y[a, j] wr[j]                 (br is added by the caller)
//
// The softmax takes its max per (query, head), never one max across heads:
// the fix for heads whose logits lie hundreds of nats apart
// (etch_tpu/nn/pallas_attention.py, the trained-weights NaN).
//
// Bound on the H100: about 5 M multiply-adds per point (200 G at B=8,
// N=5000), 90% of them in the dense projections.  Design: the projections
// run on the tensor cores as bf16 WMMA 16x16x16 tiles with f32 accumulators
// (each of the 4 warps owns one 16-row tile of the 64 padded token rows, the
// weights stream from L2 as B fragments); the per-head attention (head size
// 8, below the MMA depth of 16) runs as FP32 FMAs, one (query, head) pair per
// thread, three passes over the 60 keys (max, denominator, weighted sum) so
// no logits are stored.  Tokens and every intermediate stay in 50 KB of
// shared memory; only the 60 anchor weights are written.  The weights are
// re-read per point (through L2): several points per block, or weights
// staged in shared memory, is later work, as are wgmma and TMA.
//
// Widths are compiled in: tokens padded to 64 rows (A <= 64), E = 64 and
// V = 128 (the wrapper zero-pads narrower weights, which is exact: padded
// columns stay zero through every layer and no head reads them).
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kRows = 64;        // token rows, padded
constexpr int kE = 64;           // embed width
constexpr int kV = 128;          // value / MLP width
constexpr int kLdE = kE + 8;     // shared row strides (bf16): rows stay 16-byte
constexpr int kLdV = kV + 8;     // aligned and consecutive rows shift banks
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kScrLd = 20;       // per-warp 16 x 16 f32 accumulator scratch
constexpr int kTile = kRows * kLdE;  // one 64 x 64 bf16 buffer (elements)

// Offsets into the packed weights (bf16, each (in, out) row-major) and the
// packed f32 vectors; the wrapper builds both in this order.
constexpr int kWq0 = 0, kWk0 = 4096, kWv0 = 8192, kWc0 = 12288, kWq1 = 16384,
              kWk1 = 20480, kWv1 = 24576, kWc1 = 28672, kWm0 = 36864, kWm1 = 53248;
constexpr int kBc0 = 0, kBc1 = 64, kBm0 = 192, kBm1 = 320, kWr = 448;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// This warp's 16-row tile of A (shared, lda) times B (K x N, global,
// row-major); each 16 x 16 f32 result tile goes through `scr` to
// tile_fn(nt, scr).
template <int K, int N, typename TileFn>
__device__ __forceinline__ void warp_gemm(const bf16* a, int lda, const bf16* __restrict__ b,
                                          float* scr, TileFn tile_fn) {
  FragA fa[K / 16];
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) wmma::load_matrix_sync(fa[kt], a + kt * 16, lda);
#pragma unroll 1
  for (int nt = 0; nt < N / 16; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kt = 0; kt < K / 16; ++kt) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kt * 16 * N + nt * 16, N);
      wmma::mma_sync(acc, fa[kt], fb, acc);
    }
    wmma::store_matrix_sync(scr, acc, kScrLd, wmma::mem_row_major);
    __syncwarp();
    tile_fn(nt, scr);
    __syncwarp();
  }
}

// Calls fn(r, c, value) for the 256 entries of a 16 x 16 scratch tile.
template <typename Fn>
__device__ __forceinline__ void tile_for_each(const float* scr, Fn fn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane + 32 * i, r = e >> 4, c = e & 15;
    fn(r, c, scr[r * kScrLd + c]);
  }
}

// Multi-head attention of the block's point: q, k, v (rows x 64 bf16,
// stride kLdE) -> o (bf16, stride kLdE).  One (query, head) pair per thread.
template <int HS>
__device__ __forceinline__ void attention(const bf16* qs, const bf16* ks, const bf16* vs,
                                          bf16* os, int A, int H) {
  for (int p = threadIdx.x; p < A * H; p += kThreads) {
    const int qi = p / H, c0 = (p % H) * HS;
    float q[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) q[d] = etch_f32(qs[qi * kLdE + c0 + d]);
    float m = -INFINITY;
    for (int j = 0; j < A; ++j) {
      float z = 0.f;
#pragma unroll
      for (int d = 0; d < HS; ++d) z = fmaf(q[d], etch_f32(ks[j * kLdE + c0 + d]), z);
      m = fmaxf(m, z);
    }
    float den = 0.f;
    for (int j = 0; j < A; ++j) {
      float z = 0.f;
#pragma unroll
      for (int d = 0; d < HS; ++d) z = fmaf(q[d], etch_f32(ks[j * kLdE + c0 + d]), z);
      den += expf(z - m);
    }
    const float inv = 1.f / den;
    float o[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) o[d] = 0.f;
    for (int j = 0; j < A; ++j) {
      float z = 0.f;
#pragma unroll
      for (int d = 0; d < HS; ++d) z = fmaf(q[d], etch_f32(ks[j * kLdE + c0 + d]), z);
      const float a = etch_round_bf16(expf(z - m) * inv);
#pragma unroll
      for (int d = 0; d < HS; ++d) o[d] = fmaf(a, etch_f32(vs[j * kLdE + c0 + d]), o[d]);
    }
#pragma unroll
    for (int d = 0; d < HS; ++d) os[qi * kLdE + c0 + d] = __float2bfloat16(o[d]);
  }
}

// grid (M); block kThreads.  tokens (M, A, 64) bf16 -> out (M, A) f32.
template <int HS>
__global__ void __launch_bounds__(kThreads)
dircore_kernel(const bf16* __restrict__ tokens, const bf16* __restrict__ w,
               const float* __restrict__ f, float* __restrict__ out, int A, int H,
               float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // tokens, then the layer-0 output
  bf16* qs = xs + kTile;
  bf16* ks = qs + kTile;
  bf16* vs = ks + kTile;
  bf16* os = vs + kTile;                         // attention output
  bf16* h1 = qs;                                 // 64 x kLdV, after layer 1 (over q, k)
  bf16* h2 = vs;                                 // 64 x kLdV, MLP hidden (over v, o)
  float* scr = reinterpret_cast<float*>(os + kTile) + (threadIdx.x >> 5) * 16 * kScrLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp;                      // this warp's row tile
  const size_t point = blockIdx.x;

  // tokens -> xs (16-byte vectors); o's columns that no head writes are 0
  const uint4* src = reinterpret_cast<const uint4*>(tokens + point * A * kE);
  for (int e = threadIdx.x; e < A * (kE / 8); e += kThreads)
    *reinterpret_cast<uint4*>(xs + (e >> 3) * kLdE + (e & 7) * 8) = src[e];
  for (int e = threadIdx.x; e < kRows * kE; e += kThreads) {
    const int c = e % kE;
    if (c >= H * HS) os[(e / kE) * kLdE + c] = __float2bfloat16(0.f);
  }
  __syncthreads();

  for (int layer = 0; layer < 2; ++layer) {
    const bf16* wq = w + (layer ? kWq1 : kWq0);
    const bf16* wk = w + (layer ? kWk1 : kWk0);
    const bf16* wv = w + (layer ? kWv1 : kWv0);
    const bf16* xa = xs + r0 * kLdE;
    warp_gemm<kE, kE>(xa, kLdE, wq, scr, [&](int nt, const float* s) {
      tile_for_each(s, [&](int r, int c, float v) {
        qs[(r0 + r) * kLdE + nt * 16 + c] = __float2bfloat16(v * scale);
      });
    });
    warp_gemm<kE, kE>(xa, kLdE, wk, scr, [&](int nt, const float* s) {
      tile_for_each(s, [&](int r, int c, float v) {
        ks[(r0 + r) * kLdE + nt * 16 + c] = __float2bfloat16(v);
      });
    });
    warp_gemm<kE, kE>(xa, kLdE, wv, scr, [&](int nt, const float* s) {
      tile_for_each(s, [&](int r, int c, float v) {
        vs[(r0 + r) * kLdE + nt * 16 + c] = __float2bfloat16(v);
      });
    });
    __syncthreads();
    attention<HS>(qs, ks, vs, os, A, H);
    __syncthreads();
    if (layer == 0) {
      // residual: x = bf16(x + o Wc0 + bc0); each warp rewrites its own rows
      warp_gemm<kE, kE>(os + r0 * kLdE, kLdE, w + kWc0, scr, [&](int nt, const float* s) {
        tile_for_each(s, [&](int r, int c, float v) {
          bf16* x = xs + (r0 + r) * kLdE + nt * 16 + c;
          *x = __float2bfloat16(etch_f32(*x) + (v + f[kBc0 + nt * 16 + c]));
        });
      });
    } else {
      warp_gemm<kE, kV>(os + r0 * kLdE, kLdE, w + kWc1, scr, [&](int nt, const float* s) {
        tile_for_each(s, [&](int r, int c, float v) {
          h1[(r0 + r) * kLdV + nt * 16 + c] = __float2bfloat16(v + f[kBc1 + nt * 16 + c]);
        });
      });
    }
    __syncthreads();
  }

  // BatchMLP: h2 overlaps o, which every warp has finished reading above
  warp_gemm<kV, kV>(h1 + r0 * kLdV, kLdV, w + kWm0, scr, [&](int nt, const float* s) {
    tile_for_each(s, [&](int r, int c, float v) {
      h2[(r0 + r) * kLdV + nt * 16 + c] =
          __float2bfloat16(fmaxf(v + f[kBm0 + nt * 16 + c], 0.f));
    });
  });
  __syncwarp();
  // y = h2 Wm1 + bm1 (f32), dotted with wr; lane r < 16 owns row r0 + r
  float acc = 0.f;
  warp_gemm<kV, kV>(h2 + r0 * kLdV, kLdV, w + kWm1, scr, [&](int nt, const float* s) {
    if (lane < 16) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int j = nt * 16 + c;
        acc = fmaf(s[lane * kScrLd + c] + f[kBm1 + j], f[kWr + j], acc);
      }
    }
  });
  if (lane < 16 && r0 + lane < A) out[point * A + r0 + lane] = acc;
}

template <int HS>
int launch(const bf16* tokens, const bf16* w, const float* f, float* out, int M, int A, int H,
           float scale, cudaStream_t stream) {
  const size_t smem = 5 * kTile * sizeof(bf16) + kWarps * 16 * kScrLd * sizeof(float);
  cudaError_t err = etch_allow_smem(dircore_kernel<HS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dircore_kernel<HS><<<M, kThreads, smem, stream>>>(tokens, w, f, out, A, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens (M, A, 64) bf16, w: packed bf16 weights (69 632 values), f: packed
// f32 biases and wr (576 values), out (M, A) f32.  A <= 64, H * hs <= 64,
// hs in {1, 2, 4, 8, 16}.
ETCH_API int etch_dircore(const void* tokens, const void* w, const float* f, float* out, int M,
                          int A, int H, int hs, float scale, cudaStream_t stream) {
  const bf16* t = static_cast<const bf16*>(tokens);
  const bf16* wb = static_cast<const bf16*>(w);
  switch (hs) {
    case 1: return launch<1>(t, wb, f, out, M, A, H, scale, stream);
    case 2: return launch<2>(t, wb, f, out, M, A, H, scale, stream);
    case 4: return launch<4>(t, wb, f, out, M, A, H, scale, stream);
    case 8: return launch<8>(t, wb, f, out, M, A, H, scale, stream);
    case 16: return launch<16>(t, wb, f, out, M, A, H, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
