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
// run as bf16 mma.sync m16n8k16 with f32 accumulators: M = K (a block of at
// most 32 kernel points, padded to two m16 tiles), N = C (C/8 n8 tiles),
// depth nn (padded to 16; padded neighbours have w = 0 and finite feature
// rows).  This orientation pads K, which costs only products the byte bound
// leaves free, and in exchange hands back each accumulator fragment in t's
// own (k, c) row-major order and takes C = 8 as one n8 tile; M = C, N = K
// would pad nothing at C >= 16 but return t transposed and pad C = 8 to 16.
// A block of 4 warps owns one center (and one channel slice); each warp owns
// anchors warp, warp + 4, ... and runs its own pipeline with no block
// barrier: it gathers its neighbours' (nn, C) feature rows with 16-byte
// cp.async (each neighbour's C values are contiguous in the (B, P, A*C)
// row) into one of two tiles, the next anchor's rows arriving while this
// one computes.  Above 64 neighbours or 32 kernel points
// (interconv_mma_ring_kernel, the same products): K runs as blocks of 32
// kernel points on the grid's third axis, beside the channel slices (66
// kernel points at kernel_size 3), each block gathering the rows again and
// writing its rows of t, and the rows pass through the two tiles a chunk of
// 64 neighbours at a time (262 at sampling_ratio 3.2), so shared memory
// does not grow with nn; at nn <= 64 and K <= 32 the one-tile kernel keeps
// its shorter loop, about 1% faster.  The w tile never exists: each lane
// evaluates on the FP32 cores exactly the weights of its own A fragments
// (kernel points g + 8m, neighbours 16kt + t2 + {0, 1, 8, 9}; the m16n8k16
// A layout covers each (k, n) once) and packs them to bf16 in registers, as
// etch_round_bf16 does; the quotient by sigma is formed by Markstein's
// correction from RN(1 / sigma), which gives the correctly rounded f32
// quotient in three instructions instead of a division's ten.  At some
// twelve FP32 instructions a weight (377 M weights a C = 32 chunk) this
// evaluation, not the bytes, is what the kernel's time follows.  The feature
// B fragments come by ldmatrix.trans from rows padded by 8 elements (16
// bytes), which keeps every ldmatrix phase free of bank conflicts.  The
// epilogue rounds to bf16, stages the (K, C) block in the warp's spent tile
// and writes it with 16-byte streaming stores (t exceeds L2 and is read
// once, by the projection).  Shared memory per block: 20 nn_pad bytes of
// offsets and indices plus, per warp, two tiles of max(min(nn_pad, 64),
// min(K, 32)) x (C + 8) bf16: at nn = 64, 42.2 KB for C = 32 (5 blocks, 20
// warps an SM) and 75 KB for C = 64 (3 blocks, 12 warps); at nn = 262 and C
// = 64, 79 KB.  Left for later: fusing the (K*C -> Co) projection so that t
// never reaches device memory.
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
// Rows wider than 64 channels (the 128- and 256-channel blocks of
// epn_layer_num 3 and 4) run in both bodies as channel slices of 64 on the
// grid's third axis of one launch (launch_slices): t[p, a, k, c] is
// independent per channel, so a slice gathers its 64-channel segment of every
// row (the row's full width Cw is the stride) and writes its segment of t.
// When 64 does not divide Cw the last slice ends at the row's end and
// overlaps the one before it, whose channels it computes again and writes
// with the same values; segments start on 16-byte boundaries, as Cw % 8 == 0
// (bf16) and Cw % 4 == 0 (f32) put them.  Each slice evaluates the weights
// again; the instances and their speed at C <= 64 are those above.  Rows of
// other widths reach the bodies padded by the wrapper with zero channels
// (nn/interconv.py:interconv_t_cuda).
//
// The occupancy conv (interconv_w_kernel<float, false>) and the C == 1 body
// (interconv_w_kernel<T, true>) are one template, bound by the weight
// evaluation (nn*A*K = 92 K weights per center); the fused occupancy
// projection (interconv_ones_proj_kernel) shares its design and runs the
// projection on the tensor cores.
#include "common.cuh"

namespace {

constexpr int kMmaWarps = 4;  // warps per block of the bf16 and f32 bodies
constexpr int kKp = 32;       // kernel points a block of the bf16 body: two m16 tiles
constexpr int kMmaChunk = 64; // neighbours per gathered tile of the bf16 body
constexpr int kChunk = 32;    // neighbours per gathered tile of the f32 body
constexpr int kKb = 24;       // kernel points per block of the f32 body: 3 n8 tiles
constexpr float kFar = 1e3f;  // a coordinate no kernel point reaches: w = 0
constexpr int kSlice = 64;    // channels a block of the bf16 and f32 bodies at most

// First channel of slice z of C channels in a row of Cw: C z, but the last
// slice ends at the row's end (Cw - C) when C does not divide Cw, overlapping
// its neighbour, whose channels it writes again with equal values.
__device__ __forceinline__ int slice_start(int C, int Cw, int z) {
  return min(C * z, Cw - C);
}

// Shared memory of the bf16 body: neighbour offsets (float4) and indices,
// then per warp a ring of two (rows, C + 8) bf16 feature tiles, rows =
// max(min(nn_pad, kMmaChunk), min(K, kKp)) (rows padded by 8 elements; a
// spent tile stages a kernel-point block's (kn, C) output).
__host__ __device__ __forceinline__ int mma_nn_pad(int nn) { return (nn + 15) & ~15; }
__host__ __device__ __forceinline__ int mma_tile_rows(int np, int K) {
  const int n = np < kMmaChunk ? np : kMmaChunk, k = K < kKp ? K : kKp;
  return n > k ? n : k;
}

// w = relu(1 - |o - r|^2 / sigma), the quotient by Markstein's correction
// from rs = RN(1 / sigma), which returns the correctly rounded d2 / sigma in
// three instructions.
__device__ __forceinline__ float mma_weight(float4 o, const float (&r)[3], float sigma,
                                            float rs) {
  const float dx = o.x - r[0], dy = o.y - r[1], dz = o.z - r[2];
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float q1 = d2 * rs;
  return __saturatef(1.f - fmaf(fmaf(-q1, sigma, d2), rs, q1));   // q >= 0: 1 - q <= 1
}

// grid (c, B, slices); block kMmaWarps * 32.  nn <= kMmaChunk and K <= kKp:
// one tile holds every neighbour row, one block every kernel point.  bf16
// rows of Cw channels an anchor; block z takes the C = 8 * NT channels from
// slice_start(z).
template <int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
interconv_mma_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                     const float* __restrict__ centers,  // (B, c, 3)
                     const int32_t* __restrict__ nbr,    // (B, c, nn)
                     const bf16* __restrict__ feats,     // (B, P, A*Cw)
                     const float* __restrict__ rk,       // (A*K, 3)
                     bf16* __restrict__ out,             // (B, c, A, K, Cw)
                     int P, int c, int nn, int A, int K, int Cw, float sigma) {
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

  const size_t AC = static_cast<size_t>(A) * Cw;
  const int cz = slice_start(C, Cw, blockIdx.z);
  const bf16* fb = feats + static_cast<size_t>(b) * P * AC + cz;
  auto gather = [&](int a, bf16* dst) {
    for (int e = lane; e < nn * NT; e += 32) {
      const int n = e / NT, ch = e % NT;
      etch_cp_async16(dst + n * kLdF + ch * 8,
                      fb + static_cast<size_t>(sidx[n]) * AC + static_cast<size_t>(a) * Cw + ch * 8);
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
    bf16* ob = out + (bp * A + a) * static_cast<size_t>(K) * Cw + cz;
    for (int e = lane; e < K * NT; e += 32)
      __stcs(reinterpret_cast<int4*>(ob + (e / NT) * Cw + (e % NT) * 8),
             *reinterpret_cast<const int4*>(fcur + (e / NT) * kLdF + (e % NT) * 8));
    __syncwarp();  // staging read before the tile takes the gather after next
  }
}

// grid (c, B, slices * nkb); block kMmaWarps * 32.  bf16 rows of Cw channels
// an anchor; block z takes kernel-point block z % nkb (kernel points
// kKp (z % nkb) .. + kKp - 1) and the C = 8 * NT channels from
// slice_start(z / nkb).
template <int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
interconv_mma_ring_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                          const float* __restrict__ centers,  // (B, c, 3)
                          const int32_t* __restrict__ nbr,    // (B, c, nn)
                          const bf16* __restrict__ feats,     // (B, P, A*Cw)
                          const float* __restrict__ rk,       // (A*K, 3)
                          bf16* __restrict__ out,             // (B, c, A, K, Cw)
                          int P, int c, int nn, int A, int K, int Cw, int nkb, float sigma) {
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
  const int k0 = kKp * static_cast<int>(blockIdx.z % nkb);   // this block's kernel points
  const int kn = min(kKp, K - k0);
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
  // the last chunk's rows past nn, to its 16-row pad, start at zero in both
  // tiles (their w is 0, and 0 times a stale NaN would not be); every other
  // row a product reads is gathered first or holds finite staged t
  const int nl = nn - (nn - 1) / kMmaChunk * kMmaChunk;   // the last chunk's rows
  const int pad = (mma_nn_pad(nl) - nl) * C;
  for (int e = lane; e < 2 * pad; e += 32) {
    const int r = e % pad;
    fbuf[(e / pad) * tile + (nl + r / C) * kLdF + r % C] = __float2bfloat16(0.f);
  }
  __syncthreads();  // offsets and indices ready; from here each warp is on its own

  const size_t AC = static_cast<size_t>(A) * Cw;
  const int cz = slice_start(C, Cw, blockIdx.z / nkb);
  const bf16* fb = feats + static_cast<size_t>(b) * P * AC + cz;
  // rows n0 .. n0 + 63 (or to nn) of anchor a into tile dst
  auto gather = [&](int a, int n0, bf16* dst) {
    const int rows = min(kMmaChunk, nn - n0);
    for (int e = lane; e < rows * NT; e += 32) {
      const int n = e / NT, ch = e % NT;
      etch_cp_async16(dst + n * kLdF + ch * 8,
                      fb + static_cast<size_t>(sidx[n0 + n]) * AC + static_cast<size_t>(a) * Cw + ch * 8);
    }
  };
  const int g = lane >> 2, t2 = 2 * (lane & 3);   // fragment row and column pair
  const float rs = 1.f / sigma;

  // a warp's steps: anchors warp, warp + 4, ...; per anchor the neighbour
  // chunks n0 = 0, kMmaChunk, ... (one at nn <= 64)
  int a = warp, n0 = 0;
  if (a < A) gather(a, 0, fbuf);
  etch_cp_async_commit();
  float r[4][3];
  float acc[2][NT][4];
  for (int s = 0; a < A; ++s) {
    int a1 = a, n1 = n0 + kMmaChunk;   // the next step
    if (n1 >= nn) n1 = 0, a1 += kMmaWarps;
    if (n0 == 0) {
      // this lane's A-fragment rows are kernel points k0 + g + 8m, m = 0..3
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = g + 8 * m;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          r[m][d] = k < kn ? __ldg(rk + (static_cast<size_t>(a) * K + k0 + k) * 3 + d) : -kFar;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
    // the next chunk's features into the other tile, then wait for this one's
    if (a1 < A) gather(a1, n1, fbuf + ((s + 1) & 1) * tile);
    etch_cp_async_commit();
    etch_cp_async_wait<1>();
    __syncwarp();

    bf16* fcur = fbuf + (s & 1) * tile;
    const int ksteps = min(kMmaChunk, np - n0) / 16;
    for (int kt = 0; kt < ksteps; ++kt) {
      // w for rows g + 8m and neighbours n0 + 16 kt + t2 + {0, 1, 8, 9},
      // formed in registers straight into the A fragments (bf16, as
      // etch_round_bf16)
      float w[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + 16 * kt + t2 + (u & 1) + 8 * (u >> 1);
        const float4 o = gx[n];
#pragma unroll
        for (int m = 0; m < 4; ++m)   // 8m < kn is the same for every lane: rows 24..31 at K = 24 cost nothing
          w[m][u] = 8 * m < kn ? mma_weight(o, r[m], sigma, rs) : 0.f;
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
    __syncwarp();  // every lane has read the tile: it may become the staging tile
    if (n1 == 0) {   // the anchor's block is done: stage it in the spent tile
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 16 * m + g + 8 * h;
            if (k < kn)
              *reinterpret_cast<uint32_t*>(fcur + k * kLdF + j * 8 + t2) =
                  etch_pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
          }
      __syncwarp();
      bf16* ob = out + ((bp * A + a) * K + k0) * static_cast<size_t>(Cw) + cz;
      for (int e = lane; e < kn * NT; e += 32)
        __stcs(reinterpret_cast<int4*>(ob + (e / NT) * Cw + (e % NT) * 8),
               *reinterpret_cast<const int4*>(fcur + (e / NT) * kLdF + (e % NT) * 8));
      __syncwarp();  // staging read before the tile takes the gather after next
    }
    a = a1, n0 = n1;
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

// grid (c, B, slices); block kMmaWarps * 32.  f32 rows of Cw channels an
// anchor; block z takes the C channels from slice_start(z), C % 4 == 0,
// C <= 16 * MT.
template <int MT>
__global__ void __launch_bounds__(kMmaWarps * 32, MT <= 2 ? 5 : 3)
interconv_tf32_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                      const float* __restrict__ centers,  // (B, c, 3)
                      const int32_t* __restrict__ nbr,    // (B, c, nn)
                      const float* __restrict__ feats,    // (B, P, A*Cw)
                      const float* __restrict__ rk,       // (A*K, 3)
                      float* __restrict__ out,            // (B, c, A, K, Cw)
                      int P, int c, int nn, int A, int K, int C, int Cw, float sigma) {
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

  const size_t AC = static_cast<size_t>(A) * Cw;
  const int cz = slice_start(C, Cw, blockIdx.z);
  const float* fb = feats + static_cast<size_t>(b) * P * AC + cz;
  // 16-byte pieces: a lane copies piece pq of rows pr, pr + kRowsPer, ...
  // (compile-time divisors; pieces past C / 4 are skipped)
  constexpr int kPieces = 4 * MT, kRowsPer = 32 / kPieces;
  const int nq = C / 4, pr = lane / kPieces, pq = lane % kPieces;
  const bool copies = pr < kRowsPer && pq < nq;
  auto gather = [&](int a, int n0, float* dst) {
    const int rows = min(kChunk, nn - n0);
    const float* src = fb + static_cast<size_t>(a) * Cw + 4 * pq;
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
      float* ob = out + row0 * Cw + cz + 4 * pq;
      if (copies)
        for (int k = pr; k < kn; k += kRowsPer)
          __stcs(reinterpret_cast<float4*>(ob + k * Cw),
                 *reinterpret_cast<const float4*>(cur + k * kLd + 4 * pq));
      __syncwarp();  // staging read before the tile takes the gather after next
    }
    a = a1, k0 = k1, n0 = n1;
  }
}

// Occupancy conv with its (K -> Co) projection, expanded form.  Replaces
// etch_tpu/nn/pallas_interconv.py:_kernel_ones_proj.  Bound on the H100: FP32
// issue.  Each center sums nn * A * K weights (92 K at nn = 64, A * K = 1440;
// 377 M in a 512-center chunk at B = 8), and a weight evaluated in the
// direct form (differences, squares, an IEEE division by sigma, three scalar
// loads of the offset) costs some 20 instructions.  Design:
//   - The weight in the expanded form of the TPU kernel
//     (pallas_interconv.py:89-111,160-172):
//       w = relu(x . (2 r s) + (1 - |r|^2 s) - |x|^2 s),  s = 1 / sigma,
//     which is the direct form's 1 - |x - r|^2 / sigma with the sums taken
//     in another order (f32 rounding of a few units of |x|^2 / sigma).
//   - relu(u - xx) = max(u, xx) - xx with u = x . (2 r s) + 1 - |r|^2 s and
//     xx = |x|^2 s, and the xx do not depend on the column: a column's sum
//     is sum_n max(u_n, xx_n) - sum_n xx_n, the second sum once a center.
//     That is 3 FFMA, FMNMX and FADD a weight.  Both sums are f32 over the
//     neighbours in index order; they are at most a few times the result
//     (|x| < radius, so xx < 2 at sigma = radius^2 / 2), and their rounding
//     stays some hundred times below the bf16 rounding of t.
//   - A thread keeps kOccCols (a, k) columns' constants, 2 r s and
//     1 - |r|^2 s, and their places in the sums' matrix in registers; the
//     block's threads split the A * K columns evenly (1440 = 288 threads x
//     5).  Per neighbour one broadcast LDS.128 of (x, y, z, xx) feeds all of
//     a thread's columns.
//   - A block takes several consecutive centers (as many as make one wave of
//     resident blocks), so the constants, W and the setup are paid once for
//     all of them.
//   - The sums, rounded to bf16, stay in shared memory as a (64, Kp) A
//     matrix (anchors padded to 64, kernel points to Kp, a multiple of 16,
//     with zeros); the projection o = t W runs as bf16 mma.sync m16n8k16
//     with f32 accumulators, W (Kp, Cop) from shared memory by
//     ldmatrix.trans (rows padded by 8 elements: no bank conflicts).
//   - The (A, Co) bf16 output is staged in shared memory and leaves as
//     16-byte stores of whole rows.
constexpr int kOccCols = 5;          // (a, k) columns a thread
constexpr int kOccMaxThreads = 512;

__host__ __device__ __forceinline__ int occ_round(int x, int m) { return (x + m - 1) / m * m; }

// grid (ceil(c / cpb), B); block occ_threads(A K) (a multiple of 32, at most
// kOccMaxThreads); centers cpb blockIdx.x .. + cpb - 1.  A <= 64.
__global__ void __launch_bounds__(kOccMaxThreads)
interconv_ones_proj_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                           const float* __restrict__ centers,  // (B, c, 3)
                           const int32_t* __restrict__ nbr,    // (B, c, nn)
                           const float* __restrict__ rk,       // (A*K, 3)
                           const bf16* __restrict__ w,         // (K, Co)
                           bf16* __restrict__ out,             // (B, c, A*Co)
                           int P, int c, int nn, int A, int K, int Co, float sigma, int cpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Kp = occ_round(K, 16), Cop = occ_round(Co, 16);
  const int ldt = Kp + 8, ldw = Cop + 8;
  float4* nb = reinterpret_cast<float4*>(smem_raw);   // (x, y, z, |x|^2 s)
  bf16* ts = reinterpret_cast<bf16*>(nb + nn);        // (64, ldt): bf16(t), zero-padded
  bf16* ws = ts + 64 * ldt;                            // (Kp, ldw): W, zero-padded
  bf16* st = ws + Kp * ldw;                            // (64, ldw): the output, staged
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.y;
  const float is = 1.f / sigma;
  const float* xb = xyz + static_cast<size_t>(b) * P * 3;
  for (int e = tid; e < 32 * ldt; e += nthr) reinterpret_cast<uint32_t*>(ts)[e] = 0u;
  for (int kr = 0; kr < Kp; ++kr)
    for (int co = tid; co < Cop; co += nthr)
      ws[kr * ldw + co] = kr < K && co < Co ? w[kr * Co + co] : __float2bfloat16(0.f);

  // this thread's columns in round r (columns kOccCols nthr r ..):
  // constants and places in the sums' matrix (-1: none).  One round takes
  // every column up to A * K = kOccCols * kOccMaxThreads (the main path's
  // 1440 in one); the constants then stay for all the block's centers.
  const int AK = A * K, rounds = (AK + kOccCols * nthr - 1) / (kOccCols * nthr);
  float ax[kOccCols], ay[kOccCols], az[kOccCols], cc[kOccCols];
  int place[kOccCols];
  const auto columns = [&](int r) {
#pragma unroll
    for (int i = 0; i < kOccCols; ++i) {
      const int e = (r * kOccCols + i) * nthr + tid;
      if (e < AK) {
        const float rx = rk[3 * e], ry = rk[3 * e + 1], rz = rk[3 * e + 2];
        ax[i] = 2.f * rx * is;
        ay[i] = 2.f * ry * is;
        az[i] = 2.f * rz * is;
        cc[i] = 1.f - (rx * rx + ry * ry + rz * rz) * is;
        place[i] = (e / K) * ldt + e % K;
      } else {   // no column
        ax[i] = ay[i] = az[i] = cc[i] = 0.f;
        place[i] = -1;
      }
    }
  };
  columns(0);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int n16s = Cop / 16;

  const int p_end = min(c, (blockIdx.x + 1) * cpb);
  for (int p = blockIdx.x * cpb; p < p_end; ++p) {
    const size_t bp = static_cast<size_t>(b) * c + p;
    const float* ctr = centers + bp * 3;
    const int32_t* nbp = nbr + bp * nn;
    __syncthreads();   // the previous center's sums and output are spent
    for (int n = tid; n < nn; n += nthr) {
      const int j = nbp[n];
      const float x = xb[3 * j] - ctr[0], y = xb[3 * j + 1] - ctr[1], z = xb[3 * j + 2] - ctr[2];
      nb[n] = make_float4(x, y, z, (x * x + y * y + z * z) * is);
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      if (rounds > 1) columns(r);
      float acc[kOccCols], sxx = 0.f;
#pragma unroll
      for (int i = 0; i < kOccCols; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int n = 0; n < nn; ++n) {
        const float4 v = nb[n];
        sxx += v.w;
#pragma unroll
        for (int i = 0; i < kOccCols; ++i)
          acc[i] += fmaxf(fmaf(v.x, ax[i], fmaf(v.y, ay[i], fmaf(v.z, az[i], cc[i]))), v.w);
      }
#pragma unroll
      for (int i = 0; i < kOccCols; ++i)
        if (place[i] >= 0) ts[place[i]] = __float2bfloat16(acc[i] - sxx);
    }
    __syncthreads();

    // o (64 x Cop) = bf16(t) (64 x Kp) W (Kp x Cop): a warp a 16 x 16 tile
    for (int tt = warp; tt < 4 * n16s; tt += nthr >> 5) {
      const int r0 = 16 * (tt / n16s), n0 = 16 * (tt % n16s);
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kt = 0; kt < Kp / 16; ++kt) {
        uint32_t a[4], bb[4];
        etch_ldsm_x4(a, ts + (r0 + (lane & 15)) * ldt + 16 * kt + (lane >> 4) * 8);
        etch_ldsm_x4_trans(bb, ws + (16 * kt + (lane & 15)) * ldw + n0 + (lane >> 4) * 8);
        etch_mma_16816(o[0], a, bb[0], bb[1]);
        etch_mma_16816(o[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(st + (r0 + g + 8 * h) * ldw + n0 + 8 * j + t2) =
              etch_pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
    }
    __syncthreads();
    bf16* ob = out + bp * static_cast<size_t>(A) * Co;
    if (Co % 8 == 0) {   // 16-byte stores of whole rows
      const int per_row = Co / 8;
      for (int e = tid; e < A * per_row; e += nthr) {
        const int a = e / per_row, c8 = 8 * (e % per_row);
        *reinterpret_cast<uint4*>(ob + a * Co + c8) =
            *reinterpret_cast<const uint4*>(st + a * ldw + c8);
      }
    } else {
      for (int e = tid; e < A * Co; e += nthr) ob[e] = st[(e / Co) * ldw + e % Co];
    }
  }
}

__host__ __forceinline__ int occ_threads(int AK) {
  const int t = occ_round((AK + kOccCols - 1) / kOccCols, 32);
  return t < kOccMaxThreads ? t : kOccMaxThreads;
}

__host__ __forceinline__ size_t occ_smem_bytes(int nn, int K, int Co) {
  const int Kp = occ_round(K, 16), Cop = occ_round(Co, 16);
  return static_cast<size_t>(nn) * 16 +
         (64 * static_cast<size_t>(Kp + 8) + static_cast<size_t>(Kp + 64) * (Cop + 8)) *
             sizeof(bf16);
}

// Occupancy conv on f32 rows (interconv_w_kernel<float, false>: t = sum_n
// w, no projection; replaces etch_tpu/nn/pallas_interconv.py:_kernel_ones)
// and the C == 1 body (interconv_w_kernel<T, true>: t = sum_n w f[n, a] on
// 1-channel rows; replaces _kernel_c1), one template.  Bound on the H100:
// FP32 issue, 377 M weights a 512-center chunk at B = 8 (nn*A*K = 92 K a
// center).  Design:
//   - The weight in the TPU kernels' expanded form (pallas_interconv.py:
//     149-157, 183-191) with the ReLU per weight,
//       w = max((x . (2 r s) + (1 - |r|^2 s)) - xx, 0),   xx = |x|^2 s,
//     s = 1 / sigma: 3 FFMA, an FADD and an FMNMX, then the sum's FADD
//     (occupancy) or FFMA with the feature (C == 1).  Not the projection's
//     sum_n max(u, xx) - sum_n xx: its two sums are several times t and
//     cancel to some 3e-6 max|t| of a float64 direct form at conv0's radius
//     and sigma (CPU emulation, tests/test_torch_hopper8.py), a third of the
//     f32 gate (1e-5 max|t|); the ReLU per weight stays near 4e-7, and near
//     1e-7 of max|t| with signed 1-channel features at conv1's radius and
//     sigma (tests/test_torch_hopper9.py).
//   - Several consecutive centers a block (as many as make one wave of
//     resident blocks); a thread's kCols columns' constants in registers,
//     paid once for all the block's centers.  The occupancy's columns are
//     strided over the threads (1440 = 288 threads x 5); the C == 1 body's
//     are 6 consecutive kernel points of one anchor (1440 = 240 threads x
//     6), so one LDS of the neighbour's feature f[n, a] serves all six.
//   - The neighbours stream through shared memory in chunks of kWChunk: per
//     neighbour one broadcast LDS.128 of (x, y, z, xx), and for C == 1 its
//     (A) feature row widened to f32; a column's chunk sums add into the
//     staged row, so no nn is refused.
//   - The (A K) row is staged in shared memory in f32 and leaves as 16-byte
//     streaming stores (f32, or bf16 rounded from the f32 sums on bf16
//     rows); t is read once, by the projection that follows.
constexpr int kWChunk = 64;          // neighbours staged at a time
constexpr int kC1Cols = 6;           // consecutive kernel points of one anchor a thread (C == 1)

// Threads of a block of interconv_w_kernel<., kFeat>: columns a thread,
// at most kOccMaxThreads (more columns take rounds).
__host__ __forceinline__ int w_threads(bool feat, int A, int K) {
  const int t = feat ? occ_round(A * ((K + kC1Cols - 1) / kC1Cols), 32)
                     : occ_round((A * K + kOccCols - 1) / kOccCols, 32);
  return t < kOccMaxThreads ? t : kOccMaxThreads;
}

__host__ __forceinline__ size_t w_smem_bytes(bool feat, int nn, int A, int K) {
  const size_t cn = nn < kWChunk ? nn : kWChunk;
  return cn * 16 + static_cast<size_t>(occ_round(A * K, 4)) * 4 + (feat ? cn * A * 4 : 0);
}

// A thread's kCols column sums over a chunk's count neighbours (kCount if it
// is not 0): w in the expanded form with the ReLU per weight, summed
// (occupancy) or times the neighbour's feature of the columns' anchor, fcol
// (C == 1).
template <int kCols, bool kFeat, int kCount>
__device__ __forceinline__ void w_scan(float (&acc)[kCols], const float4* nb, const float* fcol,
                                       int A, int count, const float (&ax)[kCols],
                                       const float (&ay)[kCols], const float (&az)[kCols],
                                       const float (&cc)[kCols]) {
  const int cnt = kCount > 0 ? kCount : count;
#pragma unroll 4
  for (int n = 0; n < cnt; ++n) {
    const float4 v = nb[n];
    float f = 0.f;
    if constexpr (kFeat) f = fcol[n * A];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const float w = fmaxf(fmaf(v.x, ax[i], fmaf(v.y, ay[i], fmaf(v.z, az[i], cc[i]))) - v.w, 0.f);
      if constexpr (kFeat)
        acc[i] = fmaf(w, f, acc[i]);
      else
        acc[i] += w;
    }
  }
}

// grid (ceil(c / cpb), B); block w_threads(kFeat, A, K); centers cpb
// blockIdx.x .. + cpb - 1.  feats (B, P, A) of T (kFeat), out (B, c, A*K) of T.
template <typename T, bool kFeat>
__global__ void __launch_bounds__(kOccMaxThreads)
interconv_w_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                   const float* __restrict__ centers,  // (B, c, 3)
                   const int32_t* __restrict__ nbr,    // (B, c, nn)
                   const T* __restrict__ feats,        // (B, P, A) or null
                   const float* __restrict__ rk,       // (A*K, 3)
                   T* __restrict__ out,                // (B, c, A*K)
                   int P, int c, int nn, int A, int K, float sigma, int cpb) {
  constexpr int kCols = kFeat ? kC1Cols : kOccCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int AK = A * K, cn_max = min(nn, kWChunk);
  float4* nb = reinterpret_cast<float4*>(smem_raw);   // (x, y, z, |x|^2 s) of a chunk
  float* st = reinterpret_cast<float*>(nb + cn_max);  // the staged (A K) row
  float* fs = st + occ_round(AK, 4);                  // the chunk's (cn, A) rows (kFeat)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.y;
  const float is = 1.f / sigma;
  const float* xb = xyz + static_cast<size_t>(b) * P * 3;
  // this thread's columns in round r: constants, index (-1: none) and, for
  // C == 1, their anchor; one round takes up to kCols * kOccMaxThreads
  const int kg = (K + kCols - 1) / kCols;   // column groups an anchor (C == 1)
  const int rounds = kFeat ? (A * kg + nthr - 1) / nthr : (AK + kCols * nthr - 1) / (kCols * nthr);
  float ax[kCols], ay[kCols], az[kCols], cc[kCols];
  int col[kCols], fa = 0;
  const auto columns = [&](int r) {
    const int gi = r * nthr + tid;
    if constexpr (kFeat) fa = gi < A * kg ? gi / kg : 0;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      int e = -1;
      if constexpr (kFeat) {
        const int k = (gi % kg) * kCols + i;
        if (gi < A * kg && k < K) e = fa * K + k;
      } else {
        e = (r * kCols + i) * nthr + tid;
        if (e >= AK) e = -1;
      }
      if (e >= 0) {
        const float rx = rk[3 * e], ry = rk[3 * e + 1], rz = rk[3 * e + 2];
        ax[i] = 2.f * rx * is;
        ay[i] = 2.f * ry * is;
        az[i] = 2.f * rz * is;
        cc[i] = 1.f - (rx * rx + ry * ry + rz * rz) * is;
      } else {   // no column: w = 0
        ax[i] = ay[i] = az[i] = cc[i] = 0.f;
      }
      col[i] = e;
    }
  };
  columns(0);
  const T* fb = kFeat ? feats + static_cast<size_t>(b) * P * A : nullptr;
  const int p_end = min(c, (blockIdx.x + 1) * cpb);
  for (int p = blockIdx.x * cpb; p < p_end; ++p) {
    const size_t bp = static_cast<size_t>(b) * c + p;
    const float* ctr = centers + bp * 3;
    const int32_t* nbp = nbr + bp * nn;
    // neighbours in chunks of kWChunk; a ball of at most kWChunk is one
    // chunk whose loop counts to the argument nn, which nvcc pipelines as it
    // did in the occupancy conv before chunks (a count formed per chunk ran
    // 8% slower on the card)
    const bool one = nn <= kWChunk;
    for (int n0 = 0; n0 < nn; n0 += kWChunk) {
      const int cn = one ? nn : min(kWChunk, nn - n0);
      __syncthreads();   // the previous chunk's rows, or center's staged row, are spent
      for (int n = tid; n < cn; n += nthr) {
        const int j = nbp[n0 + n];
        const float x = xb[3 * j] - ctr[0], y = xb[3 * j + 1] - ctr[1], z = xb[3 * j + 2] - ctr[2];
        nb[n] = make_float4(x, y, z, (x * x + y * y + z * z) * is);
      }
      if constexpr (kFeat)   // a warp a neighbour's (A) row, lanes along it
        for (int n = tid >> 5; n < cn; n += nthr >> 5) {
          const T* fr = fb + static_cast<size_t>(nbp[n0 + n]) * A;
          float* fd = fs + n * A;
          if (sizeof(T) == 2 && A % 2 == 0) {   // bf16 pairs, 4-byte loads
            for (int a = tid & 31; a < A / 2; a += 32) {
              const float2 v = etch_unpack_bf16(reinterpret_cast<const uint32_t*>(fr)[a]);
              fd[2 * a] = v.x;
              fd[2 * a + 1] = v.y;
            }
          } else {
            for (int a = tid & 31; a < A; a += 32) fd[a] = etch_f32(fr[a]);
          }
        }
      __syncthreads();
      for (int r = 0; r < rounds; ++r) {
        if (rounds > 1) columns(r);
        float acc[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
        // a whole chunk of a longer ball counts to a compile-time constant
        if (one)
          w_scan<kCols, kFeat, 0>(acc, nb, fs + fa, A, nn, ax, ay, az, cc);
        else if (cn == kWChunk)
          w_scan<kCols, kFeat, kWChunk>(acc, nb, fs + fa, A, cn, ax, ay, az, cc);
        else
          w_scan<kCols, kFeat, 0>(acc, nb, fs + fa, A, cn, ax, ay, az, cc);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (col[i] >= 0) st[col[i]] = n0 == 0 ? acc[i] : st[col[i]] + acc[i];
      }
    }
    __syncthreads();
    T* ob = out + bp * AK;
    if (sizeof(T) == 4 && AK % 4 == 0) {   // 16-byte streaming stores of the whole row
      for (int e = tid; e < AK / 4; e += nthr)
        __stcs(reinterpret_cast<float4*>(ob) + e, reinterpret_cast<const float4*>(st)[e]);
    } else if (sizeof(T) == 2 && AK % 8 == 0) {   // 8 bf16 a 16-byte store
      for (int e = tid; e < AK / 8; e += nthr) {
        const float4 lo = reinterpret_cast<const float4*>(st)[2 * e];
        const float4 hi = reinterpret_cast<const float4*>(st)[2 * e + 1];
        __stcs(reinterpret_cast<uint4*>(ob) + e,
               make_uint4(etch_pack_bf16(lo.x, lo.y), etch_pack_bf16(lo.z, lo.w),
                          etch_pack_bf16(hi.x, hi.y), etch_pack_bf16(hi.z, hi.w)));
      }
    } else {
      for (int e = tid; e < AK; e += nthr) etch_store(ob + e, st[e]);
    }
  }
}

// Centers a block for a kernel over b * c centers: as many as give one wave
// of resident blocks.  0 on success.
template <typename Kernel>
int occ_centers_a_block(Kernel kernel, int threads, size_t smem, int b, int c, int* cpb) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *cpb = static_cast<int>((static_cast<long long>(b) * c + wave - 1) / wave);
  return 0;
}

template <typename T, bool kFeat>
int launch_interconv_w(const float* xyz, const float* centers, const int32_t* nbr,
                       const void* feats, const float* rk, void* out, int b, int P, int c,
                       int nn, int A, int K, float sigma, cudaStream_t stream) {
  if (A < 1 || K < 1 || nn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = w_smem_bytes(kFeat, nn, A, K);
  const int threads = w_threads(kFeat, A, K);
  cudaError_t err = etch_allow_smem(interconv_w_kernel<T, kFeat>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || c == 0) return 0;
  int cpb = 1;
  if (const int e = occ_centers_a_block(interconv_w_kernel<T, kFeat>, threads, smem, b, c, &cpb))
    return e;
  interconv_w_kernel<T, kFeat><<<dim3((c + cpb - 1) / cpb, b), threads, smem, stream>>>(
      xyz, centers, nbr, static_cast<const T*>(feats), rk, static_cast<T*>(out), P, c, nn, A, K,
      sigma, cpb);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_interconv_mma(const float* xyz, const float* centers, const int32_t* nbr,
                         const void* feats, const float* rk, void* out, int b, int P, int c,
                         int nn, int A, int K, int Cw, int slices, float sigma,
                         cudaStream_t stream) {
  const int np = mma_nn_pad(nn), nkb = (K + kKp - 1) / kKp;
  const size_t smem = static_cast<size_t>(np) * 20 +
                      static_cast<size_t>(kMmaWarps) * 2 * mma_tile_rows(np, K) *
                          (8 * NT + 8) * sizeof(bf16);
  const auto* f = static_cast<const bf16*>(feats);
  auto* o = static_cast<bf16*>(out);
  if (nn <= kMmaChunk && nkb == 1) {   // one tile of rows, one block of kernel points
    cudaError_t err = etch_allow_smem(interconv_mma_kernel<NT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    interconv_mma_kernel<NT><<<dim3(c, b, slices), kMmaWarps * 32, smem, stream>>>(
        xyz, centers, nbr, f, rk, o, P, c, nn, A, K, Cw, sigma);
  } else {
    cudaError_t err = etch_allow_smem(interconv_mma_ring_kernel<NT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    interconv_mma_ring_kernel<NT><<<dim3(c, b, slices * nkb), kMmaWarps * 32, smem, stream>>>(
        xyz, centers, nbr, f, rk, o, P, c, nn, A, K, Cw, nkb, sigma);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_interconv_tf32(const float* xyz, const float* centers, const int32_t* nbr,
                          const float* feats, const float* rk, float* out, int b, int P, int c,
                          int nn, int A, int K, int C, int Cw, int slices, float sigma,
                          cudaStream_t stream) {
  const int np = (nn + kChunk - 1) / kChunk * kChunk;
  const size_t smem = static_cast<size_t>(np) * 20 +
                      static_cast<size_t>(kMmaWarps) * 2 * kChunk * tf32_ld(MT) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_tf32_kernel<MT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_tf32_kernel<MT><<<dim3(c, b, slices), kMmaWarps * 32, smem, stream>>>(
      xyz, centers, nbr, feats, rk, out, P, c, nn, A, K, C, Cw, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A row of C channels in one launch: ceil(C / kSlice) slices of min(C,
// kSlice) channels on the grid's z axis (slice_start places them).
template <typename Launch>
int launch_slices(int C, Launch launch) {
  return launch(C < kSlice ? C : kSlice, (C + kSlice - 1) / kSlice);
}

// Contraction on f32 rows, on the tensor cores with f32 accuracy (3xTF32).
// Requires C % 4 == 0 (C > 64 runs in channel slices); any K.
ETCH_API int etch_interconv_t(const float* xyz, const float* centers, const int32_t* nbr,
                              const float* feats, const float* rk, float* out, int b, int P,
                              int c, int nn, int A, int K, int C, float sigma,
                              cudaStream_t stream) {
  if (C % 4 != 0 || C < 4) return static_cast<int>(cudaErrorInvalidValue);
  return launch_slices(C, [&](int Cs, int slices) {
    switch ((Cs + 15) / 16) {
#define ETCH_CASE(mt)                                                                            \
  case mt:                                                                                       \
    return launch_interconv_tf32<mt>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K, Cs, \
                                     C, slices, sigma, stream);
      ETCH_CASE(1) ETCH_CASE(2) ETCH_CASE(3) ETCH_CASE(4)
#undef ETCH_CASE
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// The same contraction on bf16 feature rows, on the tensor cores: bf16 w
// times bf16 features, f32 sums, bf16 t.  Requires C % 8 == 0 (C > 64 runs
// in channel slices); any K (blocks of 32 kernel points) and any nn (chunks
// of 64 neighbours).
ETCH_API int etch_interconv_t_bf16(const float* xyz, const float* centers,
                                   const int32_t* nbr, const void* feats, const float* rk,
                                   void* out, int b, int P, int c, int nn, int A, int K, int C,
                                   float sigma, cudaStream_t stream) {
  if (K < 1 || C % 8 != 0 || C < 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_slices(C, [&](int Cs, int slices) {
    switch (Cs / 8) {
#define ETCH_CASE(nt)                                                                       \
  case nt:                                                                                  \
    return launch_interconv_mma<nt>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K, \
                                    C, slices, sigma, stream);
      ETCH_CASE(1) ETCH_CASE(2) ETCH_CASE(3) ETCH_CASE(4)
      ETCH_CASE(5) ETCH_CASE(6) ETCH_CASE(7) ETCH_CASE(8)
#undef ETCH_CASE
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// Occupancy (all-ones features): out (b, c, A*K) f32.
ETCH_API int etch_interconv_ones(const float* xyz, const float* centers, const int32_t* nbr,
                                 const float* rk, float* out, int b, int P, int c, int nn,
                                 int AK, float sigma, cudaStream_t stream) {
  return launch_interconv_w<float, false>(xyz, centers, nbr, nullptr, rk, out, b, P, c, nn, 1,
                                          AK, sigma, stream);
}

// Occupancy conv with the fused (K -> Co) projection: w (K, Co) bf16,
// out (b, c, A*Co) bf16.  A <= 64.
ETCH_API int etch_interconv_ones_proj(const float* xyz, const float* centers,
                                      const int32_t* nbr, const float* rk, const void* w,
                                      void* out, int b, int P, int c, int nn, int A, int K,
                                      int Co, float sigma, cudaStream_t stream) {
  if (A < 1 || A > 64 || K < 1 || Co < 1 || nn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = occ_smem_bytes(nn, K, Co);
  const int threads = occ_threads(A * K);
  cudaError_t err = etch_allow_smem(interconv_ones_proj_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || c == 0) return 0;
  int cpb = 1;
  if (const int e = occ_centers_a_block(interconv_ones_proj_kernel, threads, smem, b, c, &cpb))
    return e;
  interconv_ones_proj_kernel<<<dim3((c + cpb - 1) / cpb, b), threads, smem, stream>>>(
      xyz, centers, nbr, rk, static_cast<const bf16*>(w), static_cast<bf16*>(out), P, c, nn, A,
      K, Co, sigma, cpb);
  return static_cast<int>(cudaGetLastError());
}

// Contraction on 1-channel rows: feats (b, P, A) f32, out (b, c, A*K) f32.
ETCH_API int etch_interconv_t_c1(const float* xyz, const float* centers, const int32_t* nbr,
                                 const float* feats, const float* rk, float* out, int b, int P,
                                 int c, int nn, int A, int K, float sigma,
                                 cudaStream_t stream) {
  return launch_interconv_w<float, true>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K,
                                         sigma, stream);
}

// The same on bf16 rows: f32 weights and sums, bf16 t.
ETCH_API int etch_interconv_t_c1_bf16(const float* xyz, const float* centers,
                                      const int32_t* nbr, const void* feats, const float* rk,
                                      void* out, int b, int P, int c, int nn, int A, int K,
                                      float sigma, cudaStream_t stream) {
  return launch_interconv_w<bf16, true>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K,
                                        sigma, stream);
}
