// Per-part confidence branch: a GEMM whose epilogue applies the grouped
// (128 -> 1) projection of every 128-column group.
//
// Replaces etch_tpu/nn/pallas_grouped_head.py:grouped_head_pallas (_kernel):
//
//   z[r, g*128 + c] = bf16(relu(h[r] W0[:, g*128 + c] + b0[g*128 + c]))
//   out[r, g]       = sum_c z[r, g*128 + c] * Wg[g, c] + bg[g]
//
// h, W0 and Wg are bf16; the products accumulate in f32 and z is rounded to
// bf16 before the Wg product, as the TPU kernel rounds it for its second MXU
// dot (against a block-diagonal Wg, a matrix-unit trick not built here).
//
// Bound on the H100: the tensor cores.  At B=8, N=5000 it is a (40000 x 128)
// by (128 x 11008) product, 112.7 GFLOP, whose (R, 11008) output would be
// 1.76 GB in f32; the per-part outputs are 14 MB.  Design: a block owns 128
// rows; their h tile stays in shared memory (and in registers as WMMA A
// fragments) while the 86 W0 column groups stream through a double-buffered
// cp.async ring; 8 warps each compute a 16 x 128 slice of the group's
// product as bf16 WMMA 16x16x16 tiles with f32 accumulators, and fold every
// 16 x 16 tile into per-row partial sums at once (bias, ReLU, bf16 round,
// times Wg), so z never leaves the SM.  wgmma and TMA are later work.
//
// The group width and depth are compiled in as 128; the wrapper zero-pads a
// narrower head (exact: padded columns give relu(0) * 0).
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kC = 128;          // group width = input depth
constexpr int kBM = 128;         // rows per block
constexpr int kLd = kC + 8;      // shared row stride (bf16)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kScrLd = 20;
constexpr int kTileElems = kBM * kLd;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// W0[:, g*128 : (g+1)*128] -> dst (128 x kLd)
__device__ __forceinline__ void load_group(bf16* dst, const bf16* __restrict__ w0, int g,
                                           int k) {
  const size_t ld = static_cast<size_t>(k) * kC;
  for (int e = threadIdx.x; e < kC * (kC / 8); e += kThreads) {
    const int row = e >> 4, col = (e & 15) * 8;
    cp_async16(dst + row * kLd + col, w0 + row * ld + static_cast<size_t>(g) * kC + col);
  }
}

// grid (ceil(R / 128)); block kThreads.
__global__ void __launch_bounds__(kThreads)
grouped_head_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w0,
                    const float* __restrict__ b0, const bf16* __restrict__ wg,
                    const float* __restrict__ bg, float* __restrict__ out, int R, int k) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);  // kBM x kLd
  bf16* bs = hs + kTileElems;                    // 2 x (kC x kLd)
  float* scr = reinterpret_cast<float*>(bs + 2 * kTileElems) + (threadIdx.x >> 5) * 16 * kScrLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBM;

  load_group(bs, w0, 0, k);
  asm volatile("cp.async.commit_group;\n");
  for (int e = threadIdx.x; e < kBM * (kC / 8); e += kThreads) {
    const int row = e >> 4, col = (e & 15) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + row < R)
      v = *reinterpret_cast<const uint4*>(h + static_cast<size_t>(row0 + row) * kC + col);
    *reinterpret_cast<uint4*>(hs + row * kLd + col) = v;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[kC / 16];
#pragma unroll
  for (int kt = 0; kt < kC / 16; ++kt)
    wmma::load_matrix_sync(fa[kt], hs + warp * 16 * kLd + kt * 16, kLd);

  // lane -> (row lane / 2 of the warp's 16, columns (lane % 2) * 8 .. + 8 of a tile)
  const int rr = lane >> 1, cc0 = (lane & 1) * 8;
  const int row = row0 + warp * 16 + rr;
  for (int g = 0; g < k; ++g) {
    if (g + 1 < k) load_group(bs + ((g + 1) & 1) * kTileElems, w0, g + 1, k);
    asm volatile("cp.async.commit_group;\n");  // possibly empty: keeps the count
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();
    const bf16* bt = bs + (g & 1) * kTileElems;
    float part = 0.f;
#pragma unroll 1
    for (int nt = 0; nt < kC / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kt = 0; kt < kC / 16; ++kt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bt + kt * 16 * kLd + nt * 16, kLd);
        wmma::mma_sync(acc, fa[kt], fb, acc);
      }
      wmma::store_matrix_sync(scr, acc, kScrLd, wmma::mem_row_major);
      __syncwarp();
      const int col = g * kC + nt * 16 + cc0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float z = etch_round_bf16(fmaxf(scr[rr * kScrLd + cc0 + i] + b0[col + i], 0.f));
        part = fmaf(z, etch_f32(wg[col + i]), part);
      }
      __syncwarp();
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && row < R) out[static_cast<size_t>(row) * k + g] = part + bg[g];
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

}  // namespace

// h (R, 128) bf16, w0 (128, k*128) bf16, b0 (k*128) f32, wg (k, 128) bf16,
// bg (k) f32 -> out (R, k) f32.
ETCH_API int etch_grouped_head(const void* h, const void* w0, const float* b0, const void* wg,
                               const float* bg, float* out, int R, int k,
                               cudaStream_t stream) {
  const size_t smem =
      3 * kTileElems * sizeof(bf16) + kWarps * 16 * kScrLd * sizeof(float);
  cudaError_t err = etch_allow_smem(grouped_head_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_head_kernel<<<(R + kBM - 1) / kBM, kThreads, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w0), b0,
      static_cast<const bf16*>(wg), bg, out, R, k);
  return static_cast<int>(cudaGetLastError());
}
