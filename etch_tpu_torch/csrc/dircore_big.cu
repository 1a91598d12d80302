// Direction-head core at the widths neither dircore.cu nor dircore_wide.cu
// takes: tokens E, the head layout or V above 512, or heads above 256
// columns (a last EPN block of 768 or 1024 channels; one head of 512 at
// E = 512; 10 heads of 96 at E = 960).  It computes what dircore.cu
// computes, with the same rounding points (see there): q (scaled), k, v,
// the attention weights and output, each layer's output and the MLP hidden
// layer rounded to bf16; logits, softmax and sums in f32.  The last two
// steps are folded as in dircore_wide.cu: out = bf16(relu(h1 Wm0 + bm0)) u
// + bm1 . wr with u = bf16(Wm1) wr (formed by the wrapper).
//
// Replaces etch_tpu/nn/pallas_dircore.py:direction_core_pallas (_kernel) at
// those widths.
//
// Why another design: at E = 512 the wide kernel already keeps a point's
// tokens in 128 registers a thread and fills shared memory with k, v and
// q; E = 768 or 1024 cannot be more instances of it.  Its other cost grows
// too: each of a point's warps reads all the weights (8 E^2 + 2 V^2 bf16,
// 20 MB at E = V = 1024) from the L2, which at 1024 would be some 80 MB a
// point.  Here the products are batched over many points instead, so a
// weight tile serves 128 token rows:
//   - The wrapper allocates a device-memory scratch for a chunk of points
//     (bounded to about 1 GB): the tokens X (zero-padded to Ep), q, k, v, the
//     attention output o (head layout, Ehp wide) and h1 (Vp wide), all bf16.
//   - Products are one bf16 GEMM kernel (gemm_kernel) with the rounding of
//     each step in its epilogue: 128 x 128 output tiles, 8 warps of 64 x 32,
//     mma.sync m16n8k16 with f32 accumulators, A and B tiles of 32-deep
//     slices through a 3-stage cp.async ring (rows padded by 8 elements, so
//     ldmatrix runs free of bank conflicts).  Epilogues: q = bf16(acc scale);
//     x = bf16(x + (acc + bc0)) in place; h1 = bf16(acc + bc1); and for the
//     last product a row's sum of bf16(relu(acc + bm0)) u over the warp's 32
//     columns, one partial a column warp, which reduce_kernel adds up.
//   - The attention of every point and head is csrc/attention.cu's kernel
//     (etch_attention_rows) on the scratch rows, o written as bf16; heads
//     above 256 columns run there in 256-column slices.
// Bound on the H100: the tensor cores (the products, some 2.5 GFLOP a point
// at E = V = 1024), then the scratch's bytes through the L2 and memory.  No
// main-path width runs it.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kLdA = kBK + 8;   // bf16: 80-byte rows
constexpr int kLdB = kBN + 8;   // bf16: 272-byte rows
constexpr size_t kGemmSmem = static_cast<size_t>(kStages) * (kBM * kLdA + kBK * kLdB) * 2;

enum Mode { kScale = 0, kResidual = 1, kBias = 2, kDot = 3 };

struct Epi {
  bf16* out;           // kScale, kResidual (in and out), kBias: (R, ldo)
  int ldo;
  float scale;         // kScale
  const float* bias;   // kResidual, kBias, kDot
  float* part;         // kDot: (gridDim.y * 4, R) partial row sums
  const float* u;      // kDot
};

// 16-byte cp.async that writes zeros where `valid` is false.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// C = A (R x K, row stride lda) B (K x N, row stride ldb), bf16 operands, f32
// sums, then the epilogue of MODE.  grid (ceil(R / 128), N / 128); K % 32 == 0.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const bf16* __restrict__ a, int lda, const bf16* __restrict__ b, int ldb, int R, int K,
            Epi e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + kStages * kBM * kLdA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bm = blockIdx.x * kBM, bn = blockIdx.y * kBN;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: rows 64 wm, columns 32 wn
  const int nkb = K / kBK;
  const auto load = [&](int stage, int kb) {
    const int k0 = kb * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      const int ar = id >> 2, ac = (id & 3) * 8, grow = bm + ar;
      const bool ok = grow < R;
      cp_async16_zfill(as + (stage * kBM + ar) * kLdA + ac,
                       a + static_cast<size_t>(ok ? grow : 0) * lda + k0 + ac, ok);
      const int br = id >> 4, bc = (id & 15) * 8;
      etch_cp_async16(bs + (stage * kBK + br) * kLdB + bc,
                      b + static_cast<size_t>(k0 + br) * ldb + bn + bc);
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkb) load(s, s);
    etch_cp_async_commit();
  }
  for (int kb = 0; kb < nkb; ++kb) {
    etch_cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kb is in place; slice kb - 1's stage is free
    if (kb + kStages - 1 < nkb) load((kb + kStages - 1) % kStages, kb + kStages - 1);
    etch_cp_async_commit();
    const bf16* at = as + (kb % kStages) * kBM * kLdA;
    const bf16* bt = bs + (kb % kStages) * kBK * kLdB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        etch_ldsm_x4(af[mt], at + (wm * 64 + mt * 16 + (lane & 15)) * kLdA + kk * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        etch_ldsm_x4_trans(bfr[np], bt + (kk * 16 + (lane & 15)) * kLdB + wn * 32 + np * 16 +
                                        (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          etch_mma_16816(acc[mt][nt], af[mt], bfr[nt >> 1][2 * (nt & 1)],
                         bfr[nt >> 1][2 * (nt & 1) + 1]);
    }
  }

  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = bm + wm * 64 + mt * 16 + g + 8 * h;
      float dot = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = bn + wn * 32 + nt * 8 + t2;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (MODE == kDot) {
          const float2 z = etch_unpack_bf16(
              etch_pack_bf16(fmaxf(v0 + e.bias[col], 0.f), fmaxf(v1 + e.bias[col + 1], 0.f)));
          dot = fmaf(z.y, e.u[col + 1], fmaf(z.x, e.u[col], dot));
        } else if (row < R) {
          uint32_t* o = reinterpret_cast<uint32_t*>(e.out + static_cast<size_t>(row) * e.ldo + col);
          if (MODE == kScale) {
            *o = etch_pack_bf16(v0 * e.scale, v1 * e.scale);
          } else if (MODE == kResidual) {
            const float2 x = etch_unpack_bf16(*o);
            *o = etch_pack_bf16(x.x + (v0 + e.bias[col]), x.y + (v1 + e.bias[col + 1]));
          } else {
            *o = etch_pack_bf16(v0 + e.bias[col], v1 + e.bias[col + 1]);
          }
        }
      }
      if (MODE == kDot) {
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if ((lane & 3) == 0 && row < R)
          e.part[static_cast<size_t>(blockIdx.y * 4 + wn) * R + row] = dot;
      }
    }
}

// x (rows, Ep) = tokens (rows, E) zero-padded; E % 8 == 0 copies 16 bytes
// at a time.
__global__ void pad_rows_kernel(const bf16* __restrict__ tok, bf16* __restrict__ x, int rows,
                                int E, int Ep) {
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  if (E % 8 == 0) {
    const int q = Ep / 8, qe = E / 8;
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         i < static_cast<size_t>(rows) * q; i += step) {
      const size_t r = i / q;
      const int c = static_cast<int>(i - r * q);
      reinterpret_cast<uint4*>(x)[i] =
          c < qe ? reinterpret_cast<const uint4*>(tok + r * E)[c] : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         i < static_cast<size_t>(rows) * Ep; i += step) {
      const size_t r = i / Ep;
      const int c = static_cast<int>(i - r * Ep);
      x[i] = c < E ? tok[r * E + c] : __float2bfloat16(0.f);
    }
  }
}

// out[r] = sum_p part[p R + r] + *c.
__global__ void reduce_kernel(const float* __restrict__ part, int np, int R,
                              const float* __restrict__ c, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float s = 0.f;
  for (int p = 0; p < np; ++p) s += part[static_cast<size_t>(p) * R + r];
  out[r] = s + *c;
}

template <int MODE>
int gemm(const bf16* a, int lda, const bf16* b, int N, int R, int K, const Epi& e,
         cudaStream_t stream) {
  cudaError_t err = etch_allow_smem(gemm_kernel<MODE>, kGemmSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<MODE><<<dim3((R + kBM - 1) / kBM, N / kBN), kThreads, kGemmSmem, stream>>>(
      a, lda, b, N, R, K, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tokens (M, A, E) bf16; w: the bf16 matrices wq0, wk0, wv0 (Ep x Ehp), wc0
// (Ehp x Ep), wq1, wk1, wv1, wc1 (Ehp x Vp), wm0 (Vp x Vp), row-major and
// zero-padded, q, k, v and o in the head layout (Eh = H hp columns of Ehp);
// f: bc0 (Ep), bc1, bm0, u (Vp) and bm1 . wr (f32); out (M, A) f32.
// scratch: bf16, chunk A (Ep + 4 Ehp + Vp) values, zero past each row's
// head layout; part: f32, (Vp / 32) chunk A values.  A <= 64; Ep, Ehp and
// Vp multiples of 128; H divides Eh.
ETCH_API int etch_dircore_big(const void* tokens, const void* w, const float* f, float* out,
                              void* scratch, float* part, int M, int A, int E, int Ep, int Eh,
                              int Ehp, int Vp, int H, float scale, int chunk,
                              cudaStream_t stream) {
  if (A < 1 || A > 64 || E > Ep || Eh > Ehp || Ep % kBN || Ehp % kBN || Vp % kBN || H < 1 ||
      Eh % H || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* wb = static_cast<const bf16*>(w);
  const size_t sq = static_cast<size_t>(Ep) * Ehp, layer = 3 * sq + static_cast<size_t>(Ehp) * Ep;
  const bf16* wl[2] = {wb, wb + layer};
  const bf16* wc1 = wl[1] + 3 * sq;
  const bf16* wm0 = wc1 + static_cast<size_t>(Ehp) * Vp;
  const float *bc0 = f, *bc1 = f + Ep, *bm0 = bc1 + Vp, *u = bm0 + Vp;
  const size_t rc = static_cast<size_t>(chunk) * A;
  bf16* x = static_cast<bf16*>(scratch);
  bf16* q = x + rc * Ep;
  bf16* k = q + rc * Ehp;
  bf16* v = k + rc * Ehp;
  bf16* o = v + rc * Ehp;
  bf16* h1 = o + rc * Ehp;
  for (int p0 = 0; p0 < M; p0 += chunk) {
    const int np = M - p0 < chunk ? M - p0 : chunk, R = np * A;
    pad_rows_kernel<<<1024, 256, 0, stream>>>(
        static_cast<const bf16*>(tokens) + static_cast<size_t>(p0) * A * E, x, R, E, Ep);
    int err = static_cast<int>(cudaGetLastError());
    for (int l = 0; l < 2 && !err; ++l) {
      Epi e{};
      e.ldo = Ehp;
      e.out = q, e.scale = scale;
      err = gemm<kScale>(x, Ep, wl[l], Ehp, R, Ep, e, stream);
      e.out = k, e.scale = 1.f;
      if (!err) err = gemm<kScale>(x, Ep, wl[l] + sq, Ehp, R, Ep, e, stream);
      e.out = v;
      if (!err) err = gemm<kScale>(x, Ep, wl[l] + 2 * sq, Ehp, R, Ep, e, stream);
      if (!err) err = etch_attention_rows(q, k, v, o, 1, np, A, Eh, H, Ehp, stream);
      if (l == 0 && !err) {
        Epi r{};
        r.out = x, r.ldo = Ep, r.bias = bc0;
        err = gemm<kResidual>(o, Ehp, wl[0] + 3 * sq, Ep, R, Ehp, r, stream);
      }
    }
    Epi e{};
    e.out = h1, e.ldo = Vp, e.bias = bc1;
    if (!err) err = gemm<kBias>(o, Ehp, wc1, Vp, R, Ehp, e, stream);
    e = Epi{};
    e.bias = bm0, e.u = u, e.part = part;
    if (!err) err = gemm<kDot>(h1, Vp, wm0, Vp, R, Vp, e, stream);
    if (!err) {
      reduce_kernel<<<(R + 255) / 256, 256, 0, stream>>>(part, Vp / 32, R, u + Vp,
                                                         out + static_cast<size_t>(p0) * A);
      err = static_cast<int>(cudaGetLastError());
    }
    if (err) return err;
  }
  return 0;
}
