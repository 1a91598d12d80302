// Inter-SO(3)-conv contraction, with both neighbour gathers fused in.
//
// Replaces etch_tpu/nn/pallas_interconv.py:interconv_t_pallas, bodies _kernel
// (C >= 8 feature contraction, f32 or bf16 features), _kernel_ones (all-ones
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
// f32 rows (interconv_kernel).  Bound: FP32 FMA issue and shared-memory
// bandwidth (no tensor cores: the f32 path keeps full precision).  Per center
// the contraction is nn*A*K*C FMAs (2.9 M at nn=64, C=32) against nn*A*C*4
// bytes of gathered features, about 12 FMAs a byte.  Design: anchors are
// processed in groups of G, sized so the w tile (nn x G*K) and the feature
// tile (nn x G*C) fit in shared memory (a whole (64, 1440) f32 w block is
// 368 KB and does not); each thread accumulates a TK x TC = 3 x 4 register
// micro-tile of (k, c) outputs, so seven shared-memory reads feed twelve
// FMAs.
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

constexpr int kTK = 3;  // kernel points per thread micro-tile (f32 body)
constexpr int kTC = 4;  // channels per thread micro-tile (f32 body)
constexpr int kMmaWarps = 4;  // warps per block of the bf16 body
constexpr int kKp = 32;       // kernel points padded to two m16 tiles
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

// grid (c, B); block G * (K / kTK) * (C / kTC) threads.  f32 rows.
__global__ void interconv_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                 const float* __restrict__ centers,  // (B, c, 3)
                                 const int32_t* __restrict__ nbr,    // (B, c, nn)
                                 const float* __restrict__ feats,    // (B, P, A*C)
                                 const float* __restrict__ rk,       // (A*K, 3)
                                 float* __restrict__ out,            // (B, c, A, K, C)
                                 int P, int c, int nn, int A, int K, int C, int G,
                                 float sigma) {
  extern __shared__ float smem[];
  float* gx = smem;                       // nn * 3
  float* ws = gx + nn * 3;                // nn * G*K
  float* fs = ws + nn * G * K;            // nn * G*C
  int* sidx = reinterpret_cast<int*>(fs + nn * G * C);  // nn

  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, sidx);

  const int ct_n = C / kTC;
  const int per_anchor = (K / kTK) * ct_n;
  const int g = threadIdx.x / per_anchor;
  const int r = threadIdx.x % per_anchor;
  const int k0 = (r / ct_n) * kTK;
  const int c0 = (r % ct_n) * kTC;
  const int GK = G * K, GC = G * C;
  const size_t AC = static_cast<size_t>(A) * C;
  const float* fb = feats + static_cast<size_t>(b) * P * AC;
  float* ob = out + bp * static_cast<size_t>(A) * K * C;

  for (int a0 = 0; a0 < A; a0 += G) {
    __syncthreads();  // offsets ready / previous group's tiles consumed
    for (int e = threadIdx.x; e < nn * GK; e += blockDim.x) {
      const int n = e / GK, gk = e % GK;
      ws[e] = kernel_weight(gx + 3 * n, rk + 3 * (static_cast<size_t>(a0) * K + gk), sigma);
    }
    for (int e = threadIdx.x; e < nn * GC; e += blockDim.x) {
      const int n = e / GC, col = e % GC;
      fs[e] = fb[static_cast<size_t>(sidx[n]) * AC + static_cast<size_t>(a0) * C + col];
    }
    __syncthreads();

    float acc[kTK][kTC];
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
    const float* wr = ws + g * K + k0;
    const float* fr = fs + g * C + c0;
    for (int n = 0; n < nn; ++n) {
      float wv[kTK], fv[kTC];
#pragma unroll
      for (int i = 0; i < kTK; ++i) wv[i] = wr[n * GK + i];
#pragma unroll
      for (int j = 0; j < kTC; ++j) fv[j] = fr[n * GC + j];
#pragma unroll
      for (int i = 0; i < kTK; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(wv[i], fv[j], acc[i][j]);
    }
    float* op = ob + (static_cast<size_t>(a0 + g) * K + k0) * C + c0;
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) op[i * C + j] = acc[i][j];
  }
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
  return fmaxf(1.f - fmaf(fmaf(-q1, sigma, d2), rs, q1), 0.f);
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

}  // namespace

// Contraction on f32 rows.  Requires K % 3 == 0, C % 4 == 0, A % G == 0; the
// caller picks G and passes the block's thread count G * (K/3) * (C/4).
ETCH_API int etch_interconv_t(const float* xyz, const float* centers, const int32_t* nbr,
                              const float* feats, const float* rk, float* out, int b, int P,
                              int c, int nn, int A, int K, int C, int G, float sigma,
                              cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(nn) * (3 + G * K + G * C) + nn) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = G * (K / kTK) * (C / kTC);
  interconv_kernel<<<dim3(c, b), threads, smem, stream>>>(xyz, centers, nbr, feats, rk, out, P,
                                                          c, nn, A, K, C, G, sigma);
  return static_cast<int>(cudaGetLastError());
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
