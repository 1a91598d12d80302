// Direction-head core: persistent blocks, weights resident in shared memory,
// every product on the tensor cores.
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
// Bound on the H100: the tensor cores.  With the 64 padded token rows a point
// costs about 11 MFLOP of bf16 products (projections 8.9, attention 2.1):
// 0.44 TFLOP at B=8, N=5000, 0.45 ms at 989 TFLOP/s; its 307 MB of tokens
// take 0.09 ms.  Beside it, 2.6 G exponentials through the special-function
// units (16 a clock an SM) take about 0.7 ms.  Design:
//   - Persistent blocks, one per SM, each of kGroups groups of 4 warps; a
//     group walks over points (point += gridDim.x * kGroups), a warp owns 16
//     of the 64 padded token rows.
//   - The 151,552 bytes of packed weights (rows padded by 8 elements so that
//     every ldmatrix phase is free of bank conflicts; the wrapper packs them
//     so) and the 576 f32 biases are copied into shared memory once per
//     block with cp.async and stay there for every point: nothing is re-read
//     through L2 per point.
//   - Activations stay in registers as mma.sync fragments: the token rows
//     are loaded from device memory straight into A fragments, the next
//     point's as soon as the current one's are spent (after layer 1's
//     projections), so that the load runs behind the MLP;
//     each projection's accumulator fragment is rounded and packed into the
//     A fragment of the next product (the m16n8 accumulator layout is the
//     m16k16 A layout), with bias, scale, residual, ReLU and the final wr
//     dot applied in registers.  Only k and v, which every warp of the group
//     reads, go to shared memory (2 x 64 x 72 bf16 per group).
//   - Attention on the tensor cores, per head (common.cuh's per-head
//     attention, shared with the anchor attention): S = q_h k_h^T is m16n8k8 at
//     head size 8 (q_h is a register fragment, k from shared memory by
//     ldmatrix); head sizes 1, 2 and 4 mask q to their head's columns of the
//     8-column tile (exact: the other columns add zeros), 16 uses m16n8k16.
//     The softmax runs on the S fragments, max and sum over the 4 lanes of a
//     row; the padded keys A..63 are -inf; a = bf16(exp(z - m) * (1 / den)) is
//     formed once per (query, key, head) and packed into the A fragments of
//     o_h = a v_h (m16n8k16 over 64 keys, v by ldmatrix.trans).  exp(z - m)
//     is 2^(z log2(e) - m log2(e)): one FMA and one ex2.approx (relative
//     error about 2^-22, where expf takes some ten instructions for 2^-23);
//     the bf16 rounding of a absorbs the difference but for a value at a
//     rounding boundary, as it absorbs the summation order.
// Shared memory: 151,552 (weights) + 2,304 (biases) + kGroups x 18,432 (k,
// v) = 209,152 bytes at kGroups = 3; one block (12 warps) per SM holds 3
// points at once.
//
// Widths are compiled in: tokens padded to 64 rows (A <= 64), E = 64 and
// V = 128 (the wrapper zero-pads narrower weights, which is exact: padded
// columns stay zero through every layer and their attention returns zero).
#include "common.cuh"

namespace {

constexpr int kRows = 64;        // token rows, padded
constexpr int kE = 64;           // embed width
constexpr int kLdE = kE + 8;     // shared row strides (bf16) of the packed weights,
constexpr int kLdV = 128 + 8;    // k and v: rows 16-byte aligned, banks shifted
constexpr int kGroups = 3;       // points in flight per block, 4 warps each
constexpr int kThreads = 128 * kGroups;
constexpr int kTile = kRows * kLdE;  // one 64 x 64 bf16 matrix, padded

// Offsets into the packed weights (bf16, each (in, out) row-major with rows
// padded to kLdE or kLdV) and the packed f32 vectors; the wrapper builds both
// in this order (nn/dircore.py:pack_weights).
constexpr int kLayerW = 4 * kE * kLdE;  // wq, wk, wv, wc of layer 0
constexpr int kWk = kE * kLdE, kWv = 2 * kE * kLdE, kWc0 = 3 * kE * kLdE;
constexpr int kWc1 = 2 * kLayerW - kE * kLdE;   // layer 1 has wq, wk, wv, then wc1 (E x V)
constexpr int kWm0 = kWc1 + kE * kLdV, kWm1 = kWm0 + 128 * kLdV;
constexpr int kWElems = kWm1 + 128 * kLdV;      // 75,776
constexpr int kBc0 = 0, kBc1 = 64, kBm0 = 192, kBm1 = 320, kWr = 448, kFElems = 576;

typedef uint32_t Frag[4];  // an m16 x k16 bf16 A fragment

// acc[j] = a (this warp's 16 rows x 16 KT) times w[:, n0 + 8j .. + 8] for
// j = 0, 1 (w row-major in shared memory, row stride ld).
template <int KT>
__device__ __forceinline__ void mma_16cols(float (&acc)[2][4], const Frag (&a)[KT],
                                           const bf16* w, int ld, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t b[4];
    etch_ldsm_x4_trans(b, w + (kt * 16 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
    etch_mma_16816(acc[0], a[kt], b[0], b[1]);
    etch_mma_16816(acc[1], a[kt], b[2], b[3]);
  }
}

// f(j, h, col) -> packed bf16 pair for accumulator columns col, col + 1 of
// row g + 8h, stored in fragment slot 2j + h of 16-column tile t.
template <typename Fn>
__device__ __forceinline__ void to_frag(Frag& out, Fn f) {
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) out[2 * j + h] = f(j, h, 8 * j + t2);
}

// Token rows r0..r0+15 of one point (A x 64 bf16 in device memory) as A
// fragments; rows >= A are zero.
__device__ __forceinline__ void load_tokens(Frag (&x)[4], const bf16* __restrict__ tok, int A,
                                            int r0) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        x[t][2 * s + h] =
            row < A ? __ldg(reinterpret_cast<const unsigned*>(tok + row * kE + 16 * t + 8 * s + t2))
                    : 0u;
      }
}

// Multi-head attention of the warp's 16 query rows: q (A fragments, 4
// k16 tiles = 64 columns), k and v (64 x kLdE bf16, shared) -> o, bf16 A
// fragments.  Column tiles at or beyond E are zero.
template <int HS>
__device__ __forceinline__ void attention(const Frag (&q)[4], const bf16* ks, const bf16* vs,
                                          int A, int E, Frag (&o)[4]) {
  if constexpr (HS == 16) {
#pragma unroll
    for (int hd = 0; hd < 4; ++hd) {   // head hd = k16 tile hd of q
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hd][e] = 0u;
      if (16 * hd < E)
        etch_attention_head16<1>(
            [&](int, uint32_t (&a)[4]) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[e] = q[hd][e];
            },
            ks + 16 * hd, vs + 16 * hd, kLdE, A, 1,
            [&](int, const float (&o0)[4], const float (&o1)[4]) {
              o[hd][0] = etch_pack_bf16(o0[0], o0[1]);
              o[hd][1] = etch_pack_bf16(o0[2], o0[3]);
              o[hd][2] = etch_pack_bf16(o1[0], o1[1]);
              o[hd][3] = etch_pack_bf16(o1[2], o1[3]);
            });
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {   // 8-column tile of q, k, v, o
      float ot[4] = {0.f, 0.f, 0.f, 0.f};
      if (8 * nt < E)
        etch_attention_tile8<HS>(
            [&](uint32_t& a0, uint32_t& a1) {
              a0 = q[nt >> 1][2 * (nt & 1)];
              a1 = q[nt >> 1][2 * (nt & 1) + 1];
            },
            ks + 8 * nt, vs + 8 * nt, kLdE, A, ot);
      o[nt >> 1][2 * (nt & 1)] = etch_pack_bf16(ot[0], ot[1]);
      o[nt >> 1][2 * (nt & 1) + 1] = etch_pack_bf16(ot[2], ot[3]);
    }
  }
}

// One attention layer's q, k, v projections and attention: x (A fragments)
// -> o (A fragments); k and v pass through the group's shared buffers.
template <int HS>
__device__ __forceinline__ void self_attention(const Frag (&x)[4], const bf16* wl,
                                               bf16* ks, bf16* vs, int group, int r0, int A,
                                               int E, float scale, Frag (&o)[4]) {
  const int g = (threadIdx.x & 31) >> 2;
  Frag q[4];
  float acc[2][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    mma_16cols<4>(acc, x, wl, kLdE, 16 * t);
    to_frag(q[t], [&](int j, int h, int) {
      return etch_pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
    });
  }
  etch_group_sync(group);  // the group is done reading the previous k and v
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      bf16* dst = m ? vs : ks;
      mma_16cols<4>(acc, x, wl + (m ? kWv : kWk), kLdE, 16 * t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8 * h) * kLdE + 16 * t + 8 * j + t2) =
              etch_pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  etch_group_sync(group);  // k and v of all 64 rows are in place
  attention<HS>(q, ks, vs, A, E, o);
}

// grid min(SMs, ceil(M / kGroups)); block kThreads.  tokens (M, A, 64) bf16
// -> out (M, A) f32.
template <int HS>
__global__ void __launch_bounds__(kThreads, 1)
dircore_kernel(const bf16* __restrict__ tokens, const bf16* __restrict__ w,
               const float* __restrict__ f, float* __restrict__ out, int M, int A, int E,
               float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  float* fs = reinterpret_cast<float*>(ws + kWElems);
  const int group = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  bf16* ks = reinterpret_cast<bf16*>(fs + kFElems) + group * 2 * kTile;
  bf16* vs = ks + kTile;
  const int r0 = 16 * warp, g = lane >> 2, t2 = 2 * (lane & 3);

  for (int e = threadIdx.x; e < kWElems / 8; e += kThreads) etch_cp_async16(ws + 8 * e, w + 8 * e);
  for (int e = threadIdx.x; e < kFElems / 4; e += kThreads) etch_cp_async16(fs + 4 * e, f + 4 * e);
  etch_cp_async_commit();
  const int stride = gridDim.x * kGroups;
  int point = blockIdx.x * kGroups + group;
  Frag x[4];
  if (point < M) load_tokens(x, tokens + static_cast<size_t>(point) * A * kE, A, r0);
  etch_cp_async_wait<0>();
  __syncthreads();  // weights resident for the block's lifetime

  for (; point < M; point += stride) {
    Frag o[4];
    float acc[2][4];

    // layer 0, residual: x = bf16(x + (o Wc0 + bc0))
    self_attention<HS>(x, ws, ks, vs, group, r0, A, E, scale, o);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      mma_16cols<4>(acc, o, ws + kWc0, kLdE, 16 * t);
      to_frag(x[t], [&](int j, int h, int col) {
        const float2 xv = etch_unpack_bf16(x[t][2 * j + h]);
        const float2 b = *reinterpret_cast<const float2*>(fs + kBc0 + 16 * t + col);
        return etch_pack_bf16(xv.x + (acc[j][2 * h] + b.x), xv.y + (acc[j][2 * h + 1] + b.y));
      });
    }

    // layer 1, E -> V: h1 = bf16(o Wc1 + bc1)
    self_attention<HS>(x, ws + kLayerW, ks, vs, group, r0, A, E, scale, o);
    // x is spent: the next point's tokens load into it behind the MLP
    if (point + stride < M)
      load_tokens(x, tokens + static_cast<size_t>(point + stride) * A * kE, A, r0);
    Frag h1[8], h2[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      mma_16cols<4>(acc, o, ws + kWc1, kLdV, 16 * t);
      to_frag(h1[t], [&](int j, int h, int col) {
        const float2 b = *reinterpret_cast<const float2*>(fs + kBc1 + 16 * t + col);
        return etch_pack_bf16(acc[j][2 * h] + b.x, acc[j][2 * h + 1] + b.y);
      });
    }
    // BatchMLP: h2 = bf16(relu(h1 Wm0 + bm0)); y = h2 Wm1 + bm1; out = y . wr
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      mma_16cols<8>(acc, h1, ws + kWm0, kLdV, 16 * t);
      to_frag(h2[t], [&](int j, int h, int col) {
        const float2 b = *reinterpret_cast<const float2*>(fs + kBm0 + 16 * t + col);
        return etch_pack_bf16(fmaxf(acc[j][2 * h] + b.x, 0.f),
                              fmaxf(acc[j][2 * h + 1] + b.y, 0.f));
      });
    }
    float part[2] = {0.f, 0.f};   // rows g, g + 8
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      mma_16cols<8>(acc, h2, ws + kWm1, kLdV, 16 * t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * t + 8 * j + t2;
        const float2 b = *reinterpret_cast<const float2*>(fs + kBm1 + col);
        const float2 r = *reinterpret_cast<const float2*>(fs + kWr + col);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          part[h] = fmaf(acc[j][2 * h + 1] + b.y, r.y, fmaf(acc[j][2 * h] + b.x, r.x, part[h]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      const int row = r0 + g + 8 * h;
      if ((lane & 3) == 0 && row < A) out[static_cast<size_t>(point) * A + row] = part[h];
    }
  }
}

template <int HS>
int launch(const bf16* tokens, const bf16* w, const float* f, float* out, int M, int A, int E,
           float scale, cudaStream_t stream) {
  const size_t smem = kWElems * sizeof(bf16) + kFElems * sizeof(float) +
                      kGroups * 2 * kTile * sizeof(bf16);
  cudaError_t err = etch_allow_smem(dircore_kernel<HS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int need = (M + kGroups - 1) / kGroups, blocks = need < sms ? need : sms;
  if (blocks == 0) return 0;
  dircore_kernel<HS><<<blocks, kThreads, smem, stream>>>(tokens, w, f, out, M, A, E, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens (M, A, 64) bf16, w: packed bf16 weights (75,776 values, rows padded),
// f: packed f32 biases and wr (576 values), out (M, A) f32.  A <= 64,
// E = H * hs <= 64, hs in {1, 2, 4, 8, 16}.
ETCH_API int etch_dircore(const void* tokens, const void* w, const float* f, float* out, int M,
                          int A, int H, int hs, float scale, cudaStream_t stream) {
  const bf16* t = static_cast<const bf16*>(tokens);
  const bf16* wb = static_cast<const bf16*>(w);
  const int E = H * hs;
  switch (hs) {
    case 1: return launch<1>(t, wb, f, out, M, A, E, scale, stream);
    case 2: return launch<2>(t, wb, f, out, M, A, E, scale, stream);
    case 4: return launch<4>(t, wb, f, out, M, A, E, scale, stream);
    case 8: return launch<8>(t, wb, f, out, M, A, E, scale, stream);
    case 16: return launch<16>(t, wb, f, out, M, A, E, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
