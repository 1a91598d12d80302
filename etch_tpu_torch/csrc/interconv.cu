// Inter-SO(3)-conv contraction, with both neighbour gathers fused in.
//
// Replaces etch_tpu/nn/pallas_interconv.py:interconv_t_pallas, bodies _kernel
// (the feature contraction on f32 or bf16 rows), _kernel_ones (all-ones
// occupancy input), _kernel_ones_proj (occupancy input with the (K -> Co)
// projection fused in, bf16 serving path) and _kernel_c1 (1-channel feature
// rows that are not the occupancy input).  For a center p with neighbours
// n = nbr[p, 0..nn):
//
//   x_pn       = xyz[nbr[p, n]] - center[p]
//   w[n, a, k] = relu(1 - |x_pn - R_a kappa_k|^2 / sigma)     (A*K = 1440)
//   t[p,a,k,c] = sum_n w[n, a, k] * feats[nbr[p, n], a*C + c]  (contraction)
//   t[p,a,k]   = sum_n w[n, a, k]                             (occupancy)
//   o[p,a,o]   = sum_k bf16(t[p,a,k]) * bf16(W[k, o])          (ones_proj)
//   t[p,a,k]   = sum_n w[n, a, k] * feats[nbr[p, n], a]        (C == 1)
//
// bf16 features (the serving path's streaming type): w is rounded to bf16
// before the multiply, as _kernel does before its bf16 MXU dot, the sums stay
// f32 and t is written as bf16 (the TPU kernel's bf16 output).  The
// occupancy projection rounds the f32 neighbour sums and W to bf16 and sums
// the K products per anchor in f32; the TPU's block-diagonal (A*K, A*Co)
// weight is a matrix-unit trick and is not built here.  The weights are the
// exact f32 ones (the TPU's approximate fast_w variant is not ported).
//
// The JAX package gathers the neighbour coordinates and the (c, nn, A*C)
// feature block into device memory first (etch_tpu/nn/epn.py:223,239) and
// needs an f32 HIGHEST matmul on the TPU to form w.  Here one block owns one
// center: it gathers its neighbours' coordinates and feature rows straight
// from the contiguous (B, P, A*C) tensor, forms w with FP32 arithmetic, and
// neither w nor the gathered block ever exists in device memory.  Reading
// rows of the contiguous feature tensor is the layout contract that
// etch_tpu/ops/grouping.py:materialize_rows pins on the TPU.
//
// bf16 rows (interconv_mma_kernel).  Bound on the H100: the bytes of t.  A
// 512-center chunk at B=8, C=32 writes 377 MB of bf16 t (755 MB at C=64) and
// reads at most 77 MB of distinct rows: 0.136 ms (0.248 ms) at 3.35 TB/s,
// against 24 GFLOP (48) of products, 0.025 ms (0.05) on the tensor cores.
// Per center and anchor the contraction is a small GEMM, (K x nn)(nn x C),
// run as bf16 mma.sync m16n8k16 with f32 accumulators: M = K (24, padded to
// two m16 tiles, 32), N = C (C/8 n8 tiles), depth nn (padded to 16; padded
// neighbours have w = 0 and finite feature rows).  This orientation pads K,
// which costs only products the byte bound leaves free, and in exchange
// hands back each accumulator fragment in t's own (k, c) row-major order and
// takes C = 8 as one n8 tile; M = C, N = K would pad nothing at C >= 16 but
// return t transposed and pad C = 8 to 16.  A block of 4 warps owns one
// center; each warp owns anchors warp, warp + 4, ... and runs its own
// pipeline with no block barrier: it gathers anchor a+4's (nn, C) feature
// tile with 16-byte cp.async into the second of two tiles (each neighbour's
// C values are contiguous in the (B, P, A*C) row) while anchor a computes.
// The w tile never exists: each lane evaluates on the FP32 cores exactly the
// weights of its own A fragments (kernel points g + 8m, neighbours 16kt + t2
// + {0, 1, 8, 9}; the m16n8k16 A layout covers each (k, n) once) and packs
// them to bf16 in registers, as kernel_weight and etch_round_bf16 do; the
// quotient by sigma is formed by Markstein's correction from RN(1 / sigma),
// which gives the correctly rounded f32 quotient in three instructions
// instead of a division's ten.  At some twelve FP32 instructions a weight
// (377 M weights a C = 32 chunk) this evaluation, not the bytes, is what
// the kernel's time follows.  The feature B fragments come by
// ldmatrix.trans from rows padded by 8 elements (16 bytes), which keeps
// every ldmatrix phase free of bank conflicts.  The epilogue rounds to
// bf16, stages the (K, C) block in the warp's spent feature tile and writes
// it with 16-byte streaming stores (t exceeds L2 and is read once, by the
// projection).  Shared memory per block: 20 nn_pad bytes of offsets and
// indices plus, per warp, two feature tiles of max(nn_pad, K) x (C + 8)
// bf16: at nn = 64, 42.2 KB for C = 32 (5 blocks, 20 warps an SM) and
// 75 KB for C = 64 (3 blocks, 12 warps).  Left for later: fusing the
// (K*C -> Co) projection so that t never reaches device memory.
//
// f32 rows (interconv_tf32_kernel).  Bound on the H100: the bytes again.  A
// 512-center chunk at B=8 writes 755 MB of f32 t at C=32 (1.51 GB at C=64)
// and reads 154 MB of rows: 0.271 ms (0.497) at 3.35 TB/s, against 72.5
// GFLOP (145) of f32-accurate products counted as three TF32 passes, 0.147
// ms (0.293) at 495 TFLOP/s.  The TPU kernel keeps f32 accuracy on its
// matrix unit with Precision.HIGHEST, a multi-pass bf16 product; here the
// per-anchor GEMM runs as 3xTF32 mma.sync m16n8k8: both operands are split
// once, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and t
// accumulates w_lo f_hi + w_hi f_lo + w_hi f_hi in f32; only w_lo f_lo,
// about 2^-22 of a product, is dropped.  The block, warp and weight scheme
// is the bf16 body's (4 warps a center, anchors warp, warp + 4, ...; each
// lane forms exactly the weights of its own fragments, Markstein's quotient,
// padded points at 1e3), with three differences, each measured on the card:
//   - The orientation is M = C (m16 tiles of channels), N = K (kernel points
//     in blocks of 24 = three n8 tiles; K = 30 or 66 runs more blocks), depth
//     nn in k8 steps.  Unlike the bf16 body it pads nothing at K = 24 and
//     C = 32 or 64 (six m16n8k8 tiles a k step at C = 32, not eight), and a
//     lane's A-fragment rows g, g + 8 of every m-tile are mapped to the
//     channels 2 MT g .. 2 MT g + 2 MT - 1, so one 16-byte shared load fetches
//     them; the weights are the B fragments (kernel points 8j + g,
//     neighbours t, t + 4).  The price is t transposed in the accumulators,
//     which the staging store turns back (it staged anyway).  C = 4 to 12
//     pad one m16 tile with channels that are never stored.
//   - Shared memory: a whole (64, C + 8) f32 tile is twice the bf16 one, and
//     two per warp would leave 2 blocks (8 warps) an SM at C = 32 and one at
//     C = 64.  So each warp gathers in chunks of 32 neighbours through a ring
//     of two 32-row tiles: chunk i + 1 arrives by 16-byte cp.async while
//     chunk i computes, and the tile of a block's last chunk stages its
//     (24, C) output for 16-byte streaming stores.  Rows are 16 MT + 8 words
//     (8 or 24 mod 32), so the fragment loads are free of bank conflicts.
//     Per block 20 nn_pad bytes of offsets and indices plus 4 x 2 x 32 x
//     (16 MT + 8) f32: 42.2 KB at C = 32 (5 blocks, 20 warps an SM) and 75
//     KB at C = 64 (3 blocks, 12 warps), as in the bf16 body.
//   - The products are issued pass by pass (all lo hi, then hi lo, then hi
//     hi), so consecutive mma.sync update different accumulators; the k
//     steps of a chunk are unrolled, and no loop divides by a runtime width.
// Of its parts the weight evaluation costs the most; the products, the
// gather and the stores each cost less, and no one unit holds the kernel:
// the FP32 weights and the latency of its dependent chains do.
//
// The fused occupancy projection is bound by the weight evaluation, as the
// plain occupancy kernel is (nn*A*K = 92 K weights per center); its
// projection adds A*K*Co = 46 K FMAs per center out of shared memory and
// removes the (B, c, A, K) f32 intermediate and the separate projection.
//
// The C == 1 body keeps _kernel_c1's rounding: w is the exact f32 weight
// (not rounded to bf16, unlike the C >= 8 body), the products and sums are
// f32, and t is rounded to bf16 only on bf16 rows.  The TPU kernel expands
// the (nn, A) rows to (nn, A*K) lanes with a one-hot matmul; here one thread
// owns an (a, k) column and reads its anchor's feature from the block's
// gathered (nn, A) rows in shared memory.  Bound as the occupancy kernel:
// nn*A*K = 92 K weights per center, one shared-memory read each more.
#include "common.cuh"

namespace {

constexpr int kMmaWarps = 4;  // warps per block of the bf16 and f32 bodies
constexpr int kKp = 32;       // kernel points padded to two m16 tiles
constexpr int kChunk = 32;    // neighbours per gathered tile of the f32 body
constexpr int kKb = 24;       // kernel points per block of the f32 body: 3 n8 tiles
constexpr float kFar = 1e3f;  // a coordinate no kernel point reaches: w = 0

__device__ __forceinline__ void load_offsets(const float* __restrict__ xyz,
                                             const float* __restrict__ ctr,
                                             const int32_t* __restrict__ nbr, int nn,
                                             float* gx, int* sidx) {
  for (int n = threadIdx.x; n < nn; n += blockDim.x) {
    const int j = nbr[n];
    if (sidx != nullptr) sidx[n] = j;
    gx[3 * n] = xyz[3 * j] - ctr[0];
    gx[3 * n + 1] = xyz[3 * j + 1] - ctr[1];
    gx[3 * n + 2] = xyz[3 * j + 2] - ctr[2];
  }
}

__device__ __forceinline__ float kernel_weight(const float* g, const float* r, float sigma) {
  const float dx = g[0] - r[0], dy = g[1] - r[1], dz = g[2] - r[2];
  return fmaxf(1.f - (dx * dx + dy * dy + dz * dz) / sigma, 0.f);
}

// Shared memory of the bf16 body: neighbour offsets (float4) and indices,
// then per warp two (rows, C + 8) bf16 feature tiles, rows = max(nn_pad, K)
// (rows padded by 8 elements; a spent tile stages the (K, C) output).
__host__ __device__ __forceinline__ int mma_nn_pad(int nn) { return (nn + 15) & ~15; }
__host__ __device__ __forceinline__ int mma_tile_rows(int np, int K) { return np > K ? np : K; }

// w = relu(1 - |o - r|^2 / sigma) as kernel_weight computes it; the quotient
// by Markstein's correction from rs = RN(1 / sigma), which returns the
// correctly rounded d2 / sigma in three instructions.
__device__ __forceinline__ float mma_weight(float4 o, const float (&r)[3], float sigma,
                                            float rs) {
  const float dx = o.x - r[0], dy = o.y - r[1], dz = o.z - r[2];
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float q1 = d2 * rs;
  return __saturatef(1.f - fmaf(fmaf(-q1, sigma, d2), rs, q1));   // q >= 0: 1 - q <= 1
}

// grid (c, B); block kMmaWarps * 32.  bf16 rows, C = 8 * NT, K <= kKp.
template <int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
interconv_mma_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                     const float* __restrict__ centers,  // (B, c, 3)
                     const int32_t* __restrict__ nbr,    // (B, c, nn)
                     const bf16* __restrict__ feats,     // (B, P, A*C)
                     const float* __restrict__ rk,       // (A*K, 3)
                     bf16* __restrict__ out,             // (B, c, A, K, C)
                     int P, int c, int nn, int A, int K, float sigma) {
  constexpr int C = 8 * NT;
  constexpr int kLdF = C + 8;               // feature and staging row stride
  const int np = mma_nn_pad(nn);
  const int tile = mma_tile_rows(np, K) * kLdF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* gx = reinterpret_cast<float4*>(smem_raw);    // np
  int* sidx = reinterpret_cast<int*>(gx + np);         // np
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* fbuf = reinterpret_cast<bf16*>(sidx + np) + static_cast<size_t>(warp) * 2 * tile;

  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  const float* xb = xyz + static_cast<size_t>(b) * P * 3;
  const float* ctr = centers + bp * 3;
  // padded neighbours sit at kFar, padded kernel points at -kFar: their
  // weights come out exactly 0 with no test in the weight loop
  for (int n = threadIdx.x; n < np; n += blockDim.x) {
    if (n < nn) {
      const int j = nbr[bp * nn + n];
      sidx[n] = j;
      gx[n] = make_float4(xb[3 * j] - ctr[0], xb[3 * j + 1] - ctr[1], xb[3 * j + 2] - ctr[2], 0.f);
    } else {
      gx[n] = make_float4(kFar, kFar, kFar, 0.f);
    }
  }
  // padded neighbour rows of both feature tiles start at zero (their w is
  // 0, and 0 times a stale NaN would not be)
  const int pad = (np - nn) * C;
  for (int e = lane; e < 2 * pad; e += 32) {
    const int r = e % pad;
    fbuf[(e / pad) * tile + (nn + r / C) * kLdF + r % C] = __float2bfloat16(0.f);
  }
  __syncthreads();  // offsets and indices ready; from here each warp is on its own

  const size_t AC = static_cast<size_t>(A) * C;
  const bf16* fb = feats + static_cast<size_t>(b) * P * AC;
  auto gather = [&](int a, bf16* dst) {
    for (int e = lane; e < nn * NT; e += 32) {
      const int n = e / NT, ch = e % NT;
      etch_cp_async16(dst + n * kLdF + ch * 8,
                      fb + static_cast<size_t>(sidx[n]) * AC + static_cast<size_t>(a) * C + ch * 8);
    }
  };
  const int g = lane >> 2, t2 = 2 * (lane & 3);   // fragment row and column pair
  const float rs = 1.f / sigma;

  if (warp < A) gather(warp, fbuf);
  etch_cp_async_commit();
  for (int a = warp, i = 0; a < A; a += kMmaWarps, ++i) {
    // this lane's A-fragment rows are kernel points g + 8m, m = 0..3
    float r[4][3];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = g + 8 * m;
#pragma unroll
      for (int d = 0; d < 3; ++d) r[m][d] = k < K ? __ldg(rk + (static_cast<size_t>(a) * K + k) * 3 + d) : -kFar;
    }
    // next anchor's features into the other tile, then wait for this one's
    if (a + kMmaWarps < A) gather(a + kMmaWarps, fbuf + ((i + 1) & 1) * tile);
    etch_cp_async_commit();
    etch_cp_async_wait<1>();
    __syncwarp();

    bf16* fcur = fbuf + (i & 1) * tile;
    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    for (int kt = 0; kt < np / 16; ++kt) {
      // w for rows g + 8m and neighbours 16 kt + t2 + {0, 1, 8, 9}, formed
      // in registers straight into the A fragments (bf16, as etch_round_bf16)
      float w[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = 16 * kt + t2 + (u & 1) + 8 * (u >> 1);
        const float4 o = gx[n];
#pragma unroll
        for (int m = 0; m < 4; ++m)   // 8m < K is the same for every lane: rows 24..31 at K = 24 cost nothing
          w[m][u] = 8 * m < K ? mma_weight(o, r[m], sigma, rs) : 0.f;
      }
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          af[mt][h] = etch_pack_bf16(w[2 * mt + h][0], w[2 * mt + h][1]);
          af[mt][2 + h] = etch_pack_bf16(w[2 * mt + h][2], w[2 * mt + h][3]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bq[2];
        etch_ldsm_x2_trans(bq, fcur + (kt * 16 + (lane & 15)) * kLdF + j * 8);
        etch_mma_16816(acc[0][j], af[0], bq[0], bq[1]);
        etch_mma_16816(acc[1][j], af[1], bq[0], bq[1]);
      }
    }
    __syncwarp();  // every lane has read the tile: it becomes the staging tile
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 16 * m + g + 8 * h;
          if (k < K)
            *reinterpret_cast<uint32_t*>(fcur + k * kLdF + j * 8 + t2) =
                etch_pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        }
    __syncwarp();
    int4* op = reinterpret_cast<int4*>(out + (bp * A + a) * static_cast<size_t>(K) * C);
    for (int e = lane; e < K * NT; e += 32)
      __stcs(op + e, *reinterpret_cast<const int4*>(fcur + (e / NT) * kLdF + (e % NT) * 8));
    __syncwarp();  // staging read before the tile takes the gather after next
  }
}

// Row stride (f32 words) of the f32 body's tiles, 16 MT channels: 8 or 24
// mod 32.
__host__ __device__ constexpr int tf32_ld(int mt) { return 16 * mt + 8; }

// Four or two consecutive f32 from shared memory (16- or 8-byte aligned).
template <int N>
__device__ __forceinline__ void lds_vec(float* v, const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += (N % 4 == 0 ? 4 : 2)) {
    if constexpr (N % 4 == 0) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      v[i] = x.x, v[i + 1] = x.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void sts_vec(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += (N % 4 == 0 ? 4 : 2)) {
    if constexpr (N % 4 == 0)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    else
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  }
}

// grid (c, B); block kMmaWarps * 32.  f32 rows, C % 4 == 0, C <= 16 * MT.
template <int MT>
__global__ void __launch_bounds__(kMmaWarps * 32, MT <= 2 ? 5 : 3)
interconv_tf32_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                      const float* __restrict__ centers,  // (B, c, 3)
                      const int32_t* __restrict__ nbr,    // (B, c, nn)
                      const float* __restrict__ feats,    // (B, P, A*C)
                      const float* __restrict__ rk,       // (A*K, 3)
                      float* __restrict__ out,            // (B, c, A, K, C)
                      int P, int c, int nn, int A, int K, int C, float sigma) {
  constexpr int kLd = tf32_ld(MT);
  constexpr int kTile = kChunk * kLd;
  const int nc = (nn + kChunk - 1) / kChunk;   // neighbour chunks
  const int np = nc * kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* gx = reinterpret_cast<float4*>(smem_raw);    // np
  int* sidx = reinterpret_cast<int*>(gx + np);         // np
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(sidx + np) + warp * 2 * kTile;

  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  const float* xb = xyz + static_cast<size_t>(b) * P * 3;
  const float* ctr = centers + bp * 3;
  // padded neighbours sit at kFar, padded kernel points at -kFar: their
  // weights come out exactly 0 with no test in the weight loop
  for (int n = threadIdx.x; n < np; n += blockDim.x) {
    if (n < nn) {
      const int j = nbr[bp * nn + n];
      sidx[n] = j;
      gx[n] = make_float4(xb[3 * j] - ctr[0], xb[3 * j + 1] - ctr[1], xb[3 * j + 2] - ctr[2], 0.f);
    } else {
      gx[n] = make_float4(kFar, kFar, kFar, 0.f);
    }
  }
  // the ring starts at zero: rows past nn and channels past C are never
  // gathered and need finite values (w = 0, or outputs never stored)
  for (int e = lane; e < 2 * kTile / 4; e += 32)
    reinterpret_cast<float4*>(ring)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // offsets and indices ready; from here each warp is on its own

  const size_t AC = static_cast<size_t>(A) * C;
  const float* fb = feats + static_cast<size_t>(b) * P * AC;
  // 16-byte pieces: a lane copies piece pq of rows pr, pr + kRowsPer, ...
  // (compile-time divisors; pieces past C / 4 are skipped)
  constexpr int kPieces = 4 * MT, kRowsPer = 32 / kPieces;
  const int nq = C / 4, pr = lane / kPieces, pq = lane % kPieces;
  const bool copies = pr < kRowsPer && pq < nq;
  auto gather = [&](int a, int n0, float* dst) {
    const int rows = min(kChunk, nn - n0);
    const float* src = fb + static_cast<size_t>(a) * C + 4 * pq;
    if (copies)
      for (int r = pr; r < rows; r += kRowsPer)
        etch_cp_async16(dst + r * kLd + 4 * pq, src + static_cast<size_t>(sidx[n0 + r]) * AC);
  };
  const int g = lane >> 2, t = lane & 3;   // fragment row and column
  const float rs = 1.f / sigma;

  // a warp's steps: anchors warp, warp + 4, ...; per anchor the kernel-point
  // blocks k0 = 0, kKb, ...; per block the neighbour chunks n0 = 0, kChunk, ...
  int a = warp, k0 = 0, n0 = 0;
  if (a < A) gather(a, n0, ring);
  etch_cp_async_commit();
  float r[3][3];
  float acc[MT][3][4];
  for (int s = 0; a < A; ++s) {
    const int kn = min(kKb, K - k0);   // kernel points of this block
    int a1 = a, k1 = k0, n1 = n0 + kChunk;   // the next step
    if (n1 >= nn) {
      n1 = 0;
      k1 += kKb;
      if (k1 >= K) k1 = 0, a1 += kMmaWarps;
    }
    if (n0 == 0) {
      // this lane's B-fragment columns are kernel points k0 + 8j + g
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int k = 8 * j + g;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          r[j][d] = k < kn ? __ldg(rk + (static_cast<size_t>(a) * K + k0 + k) * 3 + d) : -kFar;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
    // the next chunk into the other tile, then wait for this one
    if (a1 < A) gather(a1, n1, ring + ((s + 1) & 1) * kTile);
    etch_cp_async_commit();
    etch_cp_async_wait<1>();
    __syncwarp();

    float* cur = ring + (s & 1) * kTile;
    const int ksteps = min(kChunk, nn - n0 + 7) / 8;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      if (ks >= ksteps) break;
      // w for kernel points 8j + g and neighbours n0 + 8 ks + t + {0, 4},
      // split into the hi and lo B fragments
      uint32_t bh[3][2], bl[3][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 o = gx[n0 + 8 * ks + t + 4 * u];
#pragma unroll
        for (int j = 0; j < 3; ++j)   // 8j < kn is the same for every lane
          etch_split_tf32(8 * j < kn ? mma_weight(o, r[j], sigma, rs) : 0.f, bh[j][u], bl[j][u]);
      }
      // features of neighbours 8 ks + t + {0, 4}, channels 2 MT g .. + 2 MT:
      // A-fragment rows g, g + 8 of m-tile m are channels 2 MT g + 2m + {0, 1}
      float f[2][2 * MT];
      lds_vec<2 * MT>(f[0], cur + (8 * ks + t) * kLd + 2 * MT * g);
      lds_vec<2 * MT>(f[1], cur + (8 * ks + t + 4) * kLd + 2 * MT * g);
      uint32_t ah[MT][4], al[MT][4];   // slot h + 2u: channel row h, neighbour t + 4u
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            etch_split_tf32(f[u][2 * m + h], ah[m][h + 2 * u], al[m][h + 2 * u]);
      // pass by pass (lo hi, hi lo, hi hi), so that consecutive products
      // update different accumulators
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (8 * j < kn)
              etch_mma_1688_tf32(acc[m][j], pass == 0 ? al[m] : ah[m],
                                 pass == 1 ? bl[j][0] : bh[j][0],
                                 pass == 1 ? bl[j][1] : bh[j][1]);
    }
    __syncwarp();  // every lane has read the tile: the gather after next may take it
    if (n1 == 0) {   // the anchor's block is done: stage it in the spent tile
      // acc[m][j] holds channels 2 MT g + 2m + {0, 1} (slots {0, 2} and
      // {1, 3}) of kernel points 8j + 2t + {0, 1}
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * t + e;
          if (k < kn) {
            float v[2 * MT];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              v[2 * m] = acc[m][j][e], v[2 * m + 1] = acc[m][j][e + 2];
            sts_vec<2 * MT>(cur + k * kLd + 2 * MT * g, v);
          }
        }
      __syncwarp();
      const size_t row0 = (bp * A + a) * K + k0;
      float4* op = reinterpret_cast<float4*>(out + row0 * C) + pq;
      if (copies)
        for (int k = pr; k < kn; k += kRowsPer)
          __stcs(op + k * nq, *reinterpret_cast<const float4*>(cur + k * kLd + 4 * pq));
      __syncwarp();  // staging read before the tile takes the gather after next
    }
    a = a1, k0 = k1, n0 = n1;
  }
}

// grid (c, B); one thread per (a, k) output column, looping over neighbours.
__global__ void interconv_ones_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                      const float* __restrict__ centers,  // (B, c, 3)
                                      const int32_t* __restrict__ nbr,    // (B, c, nn)
                                      const float* __restrict__ rk,       // (A*K, 3)
                                      float* __restrict__ out,            // (B, c, A*K)
                                      int P, int c, int nn, int AK, float sigma) {
  extern __shared__ float gx[];  // nn * 3
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, nullptr);
  __syncthreads();
  float* ob = out + bp * AK;
  for (int e = threadIdx.x; e < AK; e += blockDim.x) {
    const float rv[3] = {rk[3 * e], rk[3 * e + 1], rk[3 * e + 2]};
    float acc = 0.f;
    for (int n = 0; n < nn; ++n) acc += kernel_weight(gx + 3 * n, rv, sigma);
    ob[e] = acc;
  }
}

// grid (c, B); block 256.  The neighbour sums of interconv_ones_kernel (same
// f32 summation order), rounded to bf16 in shared memory, then a per-anchor
// (A, K) x (K, Co) product with f32 accumulators, written as bf16.
__global__ void interconv_ones_proj_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                           const float* __restrict__ centers,  // (B, c, 3)
                                           const int32_t* __restrict__ nbr,    // (B, c, nn)
                                           const float* __restrict__ rk,       // (A*K, 3)
                                           const bf16* __restrict__ w,         // (K, Co)
                                           bf16* __restrict__ out,             // (B, c, A*Co)
                                           int P, int c, int nn, int A, int K, int Co,
                                           float sigma) {
  extern __shared__ float smem[];
  float* gx = smem;             // nn * 3
  float* ws = gx + nn * 3;      // A * K, bf16-rounded neighbour sums
  float* wp = ws + A * K;       // K * Co, W as float
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, nullptr);
  for (int e = threadIdx.x; e < K * Co; e += blockDim.x) wp[e] = etch_f32(w[e]);
  __syncthreads();
  for (int e = threadIdx.x; e < A * K; e += blockDim.x) {
    const float rv[3] = {rk[3 * e], rk[3 * e + 1], rk[3 * e + 2]};
    float acc = 0.f;
    for (int n = 0; n < nn; ++n) acc += kernel_weight(gx + 3 * n, rv, sigma);
    ws[e] = etch_round_bf16(acc);
  }
  __syncthreads();
  bf16* ob = out + bp * static_cast<size_t>(A) * Co;
  for (int e = threadIdx.x; e < A * Co; e += blockDim.x) {
    const int a = e / Co, o = e % Co;
    const float* wr = ws + a * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(wr[k], wp[k * Co + o], acc);
    ob[e] = __float2bfloat16(acc);
  }
}

// grid (c, B); one thread per (a, k) output column.  T: feature and output
// type (float, or bf16 rows with f32 sums and a bf16 t).
template <typename T>
__global__ void interconv_c1_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                    const float* __restrict__ centers,  // (B, c, 3)
                                    const int32_t* __restrict__ nbr,    // (B, c, nn)
                                    const T* __restrict__ feats,        // (B, P, A)
                                    const float* __restrict__ rk,       // (A*K, 3)
                                    T* __restrict__ out,                // (B, c, A*K)
                                    int P, int c, int nn, int A, int K, float sigma) {
  extern __shared__ float smem[];
  float* gx = smem;                                    // nn * 3
  float* fs = gx + nn * 3;                             // nn * A
  int* sidx = reinterpret_cast<int*>(fs + nn * A);     // nn
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, sidx);
  __syncthreads();
  const T* fb = feats + static_cast<size_t>(b) * P * A;
  for (int e = threadIdx.x; e < nn * A; e += blockDim.x) {
    const int n = e / A, a = e % A;
    fs[e] = etch_f32(fb[static_cast<size_t>(sidx[n]) * A + a]);
  }
  __syncthreads();
  T* ob = out + bp * static_cast<size_t>(A) * K;
  for (int e = threadIdx.x; e < A * K; e += blockDim.x) {
    const float rv[3] = {rk[3 * e], rk[3 * e + 1], rk[3 * e + 2]};
    const float* fa = fs + e / K;
    float acc = 0.f;
    for (int n = 0; n < nn; ++n) acc = fmaf(kernel_weight(gx + 3 * n, rv, sigma), fa[n * A], acc);
    etch_store(ob + e, acc);
  }
}

template <typename T>
int launch_interconv_c1(const float* xyz, const float* centers, const int32_t* nbr,
                        const void* feats, const float* rk, void* out, int b, int P, int c,
                        int nn, int A, int K, float sigma, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nn) * (3 + A + 1) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_c1_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_c1_kernel<T><<<dim3(c, b), 256, smem, stream>>>(
      xyz, centers, nbr, static_cast<const T*>(feats), rk, static_cast<T*>(out), P, c, nn, A,
      K, sigma);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_interconv_mma(const float* xyz, const float* centers, const int32_t* nbr,
                         const void* feats, const float* rk, void* out, int b, int P, int c,
                         int nn, int A, int K, float sigma, cudaStream_t stream) {
  const int np = mma_nn_pad(nn);
  const size_t smem = static_cast<size_t>(np) * 20 +
                      static_cast<size_t>(kMmaWarps) * 2 * mma_tile_rows(np, K) *
                          (8 * NT + 8) * sizeof(bf16);
  cudaError_t err = etch_allow_smem(interconv_mma_kernel<NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_mma_kernel<NT><<<dim3(c, b), kMmaWarps * 32, smem, stream>>>(
      xyz, centers, nbr, static_cast<const bf16*>(feats), rk, static_cast<bf16*>(out), P, c, nn,
      A, K, sigma);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_interconv_tf32(const float* xyz, const float* centers, const int32_t* nbr,
                          const float* feats, const float* rk, float* out, int b, int P, int c,
                          int nn, int A, int K, int C, float sigma, cudaStream_t stream) {
  const int np = (nn + kChunk - 1) / kChunk * kChunk;
  const size_t smem = static_cast<size_t>(np) * 20 +
                      static_cast<size_t>(kMmaWarps) * 2 * kChunk * tf32_ld(MT) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_tf32_kernel<MT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_tf32_kernel<MT><<<dim3(c, b), kMmaWarps * 32, smem, stream>>>(
      xyz, centers, nbr, feats, rk, out, P, c, nn, A, K, C, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Contraction on f32 rows, on the tensor cores with f32 accuracy (3xTF32).
// Requires C % 4 == 0 and 4 <= C <= 64; any K.
ETCH_API int etch_interconv_t(const float* xyz, const float* centers, const int32_t* nbr,
                              const float* feats, const float* rk, float* out, int b, int P,
                              int c, int nn, int A, int K, int C, float sigma,
                              cudaStream_t stream) {
  if (C % 4 != 0 || C < 4 || C > 64) return static_cast<int>(cudaErrorInvalidValue);
  switch ((C + 15) / 16) {
#define ETCH_CASE(mt)                                                                        \
  case mt:                                                                                   \
    return launch_interconv_tf32<mt>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K, \
                                     C, sigma, stream);
    ETCH_CASE(1) ETCH_CASE(2) ETCH_CASE(3) ETCH_CASE(4)
#undef ETCH_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same contraction on bf16 feature rows, on the tensor cores: bf16 w
// times bf16 features, f32 sums, bf16 t.  Requires C in {8, 16, ..., 64} and
// K <= 32.
ETCH_API int etch_interconv_t_bf16(const float* xyz, const float* centers,
                                   const int32_t* nbr, const void* feats, const float* rk,
                                   void* out, int b, int P, int c, int nn, int A, int K, int C,
                                   float sigma, cudaStream_t stream) {
  if (K > kKp || C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C / 8) {
#define ETCH_CASE(nt)                                                                       \
  case nt:                                                                                  \
    return launch_interconv_mma<nt>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K, \
                                    sigma, stream);
    ETCH_CASE(1) ETCH_CASE(2) ETCH_CASE(3) ETCH_CASE(4)
    ETCH_CASE(5) ETCH_CASE(6) ETCH_CASE(7) ETCH_CASE(8)
#undef ETCH_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Occupancy (all-ones features): out (b, c, A*K).
ETCH_API int etch_interconv_ones(const float* xyz, const float* centers, const int32_t* nbr,
                                 const float* rk, float* out, int b, int P, int c, int nn,
                                 int AK, float sigma, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nn) * 3 * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_ones_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_ones_kernel<<<dim3(c, b), 256, smem, stream>>>(xyz, centers, nbr, rk, out, P, c,
                                                           nn, AK, sigma);
  return static_cast<int>(cudaGetLastError());
}

// Occupancy conv with the fused (K -> Co) projection: w (K, Co) bf16,
// out (b, c, A*Co) bf16.
ETCH_API int etch_interconv_ones_proj(const float* xyz, const float* centers,
                                      const int32_t* nbr, const float* rk, const void* w,
                                      void* out, int b, int P, int c, int nn, int A, int K,
                                      int Co, float sigma, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(nn) * 3 + A * K + K * Co) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_ones_proj_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_ones_proj_kernel<<<dim3(c, b), 256, smem, stream>>>(
      xyz, centers, nbr, rk, static_cast<const bf16*>(w), static_cast<bf16*>(out), P, c, nn, A,
      K, Co, sigma);
  return static_cast<int>(cudaGetLastError());
}

// Contraction on 1-channel rows: feats (b, P, A) f32, out (b, c, A*K) f32.
ETCH_API int etch_interconv_t_c1(const float* xyz, const float* centers, const int32_t* nbr,
                                 const float* feats, const float* rk, float* out, int b, int P,
                                 int c, int nn, int A, int K, float sigma,
                                 cudaStream_t stream) {
  return launch_interconv_c1<float>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K,
                                    sigma, stream);
}

// The same on bf16 rows: exact f32 weights and sums, bf16 t.
ETCH_API int etch_interconv_t_c1_bf16(const float* xyz, const float* centers,
                                      const int32_t* nbr, const void* feats, const float* rk,
                                      void* out, int b, int P, int c, int nn, int A, int K,
                                      float sigma, cudaStream_t stream) {
  return launch_interconv_c1<bf16>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K,
                                   sigma, stream);
}
