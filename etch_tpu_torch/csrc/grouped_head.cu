// Per-part confidence branch: a GEMM whose epilogue applies the grouped
// (c0 -> 1) projection of every c0-column group.
//
// Replaces etch_tpu/nn/pallas_grouped_head.py:grouped_head_pallas (_kernel):
//
//   z[r, g*c0 + c] = bf16(relu(h[r] W0[:, g*c0 + c] + b0[g*c0 + c]))
//   out[r, g]      = sum_c z[r, g*c0 + c] * Wg[g, c] + bg[g]
//
// h, W0 and Wg are bf16; the products accumulate in f32 and z is rounded to
// bf16 before the Wg product, as the TPU kernel rounds it for its second MXU
// dot (against a block-diagonal Wg, a matrix-unit trick not built here).
//
// Bound on the H100: the tensor cores.  At B=8, N=5000, c0=128, k=86 it is a
// (40000 x 128) by (128 x 11008) product, 112.7 GFLOP (0.114 ms at 989
// TFLOP/s), whose (R, 11008) output would be 1.76 GB in f32; the per-part
// outputs are 14 MB.  Design (Hopper: wgmma, TMA, mbarriers):
//   - Persistent blocks walk over work items (a tile of 256 rows, a chunk of
//     consecutive groups); the chunking is chosen on the host so that the
//     busiest block's share is the smallest (313 tiles of 128 rows alone
//     would leave a 37%-full last wave on 132 SMs).
//   - One producer thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle): the item's h rows (a 128 x c0 half for each consumer
//     warpgroup, reloaded once that warpgroup is done with the last item),
//     and one group's 128 x 128 W0 tile per pipeline stage, with the
//     group's b0 and Wg slices (512 + 256 bytes, plain bulk copies), through
//     a ring of 4 stages under full / empty mbarriers.  W0 is read
//     transposed, W0^T (k*c0, c0), formed by the wrapper, so that both
//     operands are K-major; it stays in the L2 (2.8 MB) across all blocks,
//     and each tile read from it serves 256 rows (a 128-row item read 880
//     MB of W0 from the L2 a call at B=8, N=5000).  The producer's
//     warpgroup gives its registers to the consumers (setmaxnreg: 40 and
//     232 a thread), whose two m64n128 accumulators take 128.
//   - Two consumer warpgroups, 128 rows each, run every stage's products,
//     wgmma.mma_async m64n128k16 (bf16 -> f32, a warpgroup's rows as two m64
//     halves).  At c0 = 128 a warpgroup holds its h rows as A fragments in
//     registers for the whole item (64 a thread, by ldmatrix from the
//     swizzled tile), so the products read only W0 from shared memory, and
//     it pipelines its groups an m64 half at a time: the next group's
//     products for a half go out as soon as that half's epilogue has read
//     its accumulators, so the tensor cores run while it works on the other
//     half (an epilogue of a whole group, about 640 instructions a thread,
//     takes longer than the group's products).
//   - The epilogue works on the accumulator registers: in the m64nN layout a
//     row's 128 columns lie in the 4 lanes of a quad, so each lane adds b0,
//     applies the ReLU and the bf16 rounding (one cvt.rn.relu.bf16x2 a pair)
//     and the Wg FMA over its own columns, and two quad shuffles give the
//     row's sum; z never touches shared memory.  The item's (256 x chunk)
//     sums are staged in shared memory and leave as row segments with bg
//     added.
//   - c0 above 128 (256 .. 2048): the depth runs in 64-column slices of h
//     (the slice of the item's 256 rows streams with the W0 slice in each
//     stage), and the group width in 128-column n-tiles whose partial sums
//     add into the same (row, group) output in registers.
//
// The group width and depth are multiples of 128; the wrapper zero-pads a
// narrower head (exact: padded columns give relu(0) * 0).
#include "common.cuh"

#include <cuda.h>

#include <type_traits>

namespace {

constexpr int kTile = 128;                     // a consumer's rows; W0 tile width and depth
constexpr int kSubBytes = kTile * 64 * 2;      // a 128 x 64 bf16 swizzle-atom column: 16 KB
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kRows = kTile * kConsumers;      // rows a work item
constexpr int kThreads = 128 * (kConsumers + 1);   // and the producer warpgroup
constexpr int kExtraBytes = kTile * 4 + kTile * 2;   // a group's b0 (f32) and Wg (bf16) slices

// Shared memory of one block.  A stage holds W0 columns, which both
// consumer warpgroups read: the 128 x 128 tile as two 64-deep 16 KB columns,
// or (kStream: c0 > 128) one 64-deep slice of it and the same slice of the
// item's 256 h rows (two 16 KB columns, a warpgroup's 128 rows each); else
// the item's h rows stay resident (a 32 KB half a warpgroup).
template <bool kStream>
struct Smem {
  static constexpr int kStages = 4;
  static constexpr int kK16 = kStream ? 4 : 8;          // k16 steps a stage
  static constexpr int kMaxChunk = kStream ? 16 : 22;  // groups an item (staging columns)
  static constexpr size_t a_off = 0;
  static constexpr size_t stage_off = a_off + (kStream ? 0 : kConsumers * 2 * kSubBytes);
  static constexpr size_t stage_bytes = (kStream ? 3 : 2) * static_cast<size_t>(kSubBytes);
  static constexpr size_t extra_off = stage_off + kStages * stage_bytes;
  static constexpr size_t out_off = extra_off + kStages * kExtraBytes;
  static constexpr int ldo = kMaxChunk + 1;
  // 1 KB of slack: the swizzled tiles need a 1024-byte aligned base
  static constexpr size_t bytes = out_off + static_cast<size_t>(kRows) * ldo * 4 + 1024;
};

struct Work {
  int R, k, c0;
  int chunk, nchunks, items;   // groups a chunk, chunks a row tile, row tiles x chunks
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that outlasts some 2^30 polls (far longer than any load) traps, so a
// fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}

// TMA: the (64-column, 128-row) box at (col, row) of a 2-D bf16 tensor map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}
// Bulk copy of `bytes` (a multiple of 16) contiguous bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile stored as TMA's 128-byte
// swizzle writes it (rows of 64 bf16, 8-row groups 1024 bytes apart).  A k16
// step further along the row is 32 bytes: 2 more in the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed product groups run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across the wgmma waits.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16) B (16 x 128), bf16 operands from shared memory, f32 d
// (scale_d 0: d = A B).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers: a[0..3] the A fragment of the warp's 16
// rows of the m64 tile (rows g, g + 8; k 2t, 2t + 8), as for mma.sync.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The A fragment (as above) of rows r0 .. r0 + 15, k16 step kk (0-3) of a
// 128-row, 64-column tile in TMA's 128-byte swizzle: row r's 16-byte chunk
// c sits at chunk c ^ (r % 8).
__device__ __forceinline__ void lds_a_sw128(uint32_t (&a)[4], const unsigned char* tile, int r0,
                                            int kk) {
  const int lane = threadIdx.x & 31, r = r0 + (lane & 15), c = 2 * kk + (lane >> 4);
  etch_ldsm_x4(a, tile + r * 128 + ((c ^ (r & 7)) << 4));
}

// bf16(relu(lo)), bf16(relu(hi)) as a packed pair (lo at the lower half).
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// One m64 half's accumulators of a 128-column n-tile: part[r] (rows g and
// g + 8 of the warp's 16) += sum over the lane's columns of
// bf16(relu(d + b0)) * wg.  Accumulator j of the m64n128 layout: n8 tile
// j / 4, row g + 8 ((j / 2) % 2), column 8 (j / 4) + 2 (lane % 4) + j % 2.
__device__ __forceinline__ void epilogue(const float (&d)[64], const float* b0s, const bf16* wgs,
                                         float (&part)[2]) {
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + t2;
    const float2 b = *reinterpret_cast<const float2*>(b0s + col);
    const float2 w = etch_unpack_bf16(*reinterpret_cast<const uint32_t*>(wgs + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 z = etch_unpack_bf16(relu_bf16x2(d[4 * j + 2 * r] + b.x,
                                                    d[4 * j + 2 * r + 1] + b.y));
      part[r] = fmaf(z.y, w.y, fmaf(z.x, w.x, part[r]));
    }
  }
}

// grid: persistent blocks; block kThreads (warpgroups 0 and 1: the
// consumers, each the item's rows 128 wgi ..; warpgroup 2: the producer, of
// which one thread issues the loads).
template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
grouped_head_kernel(const __grid_constant__ CUtensorMap hmap,   // h (R, c0), box 64 x 128
                    const __grid_constant__ CUtensorMap wmap,   // W0^T (k c0, c0), box 64 x 128
                    const float* __restrict__ b0, const bf16* __restrict__ wg,
                    const float* __restrict__ bg, float* __restrict__ out, Work w) {
  using S = Smem<kStream>;
  constexpr int NS = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[NS], empty[NS], afull[kConsumers], aempty[kConsumers];
  // aligned by an offset from the shared array itself, so that the compiler
  // keeps shared-memory loads and stores (not generic ones) in the epilogue
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* ost = reinterpret_cast<float*>(smem + S::out_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsl = w.c0 / kTile;                 // 128-column n-tiles of a group
  const int nkq = kStream ? w.c0 / 64 : 1;      // stages an n-tile

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * kConsumers);
    }
    for (int i = 0; i < kConsumers; ++i) {
      mbar_init(&afull[i], 1);
      mbar_init(&aempty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * kConsumers && lane == 0) {
      int s = 0, il = 0;
      for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++il) {
        const int tile = item / w.nchunks, ch = item % w.nchunks;
        const int g0 = ch * w.chunk, cg = min(w.chunk, w.k - g0), row0 = tile * kRows;
        if (!kStream)   // each warpgroup's 128 h rows, once it is done with the last item's
          for (int c = 0; c < kConsumers; ++c) {
            mbar_wait(&aempty[c], (il & 1) ^ 1);
            mbar_expect_tx(&afull[c], 2 * kSubBytes);
            unsigned char* a = smem + S::a_off + c * 2 * kSubBytes;
            tma_load(a, &hmap, &afull[c], 0, row0 + c * kTile);
            tma_load(a + kSubBytes, &hmap, &afull[c], 64, row0 + c * kTile);
          }
        for (int j = 0; j < cg; ++j)
          for (int nt = 0; nt < nsl; ++nt)
            for (int kq = 0; kq < nkq; ++kq, ++s) {
              const int st = s % NS;
              mbar_wait(&empty[st], ((s / NS) & 1) ^ 1);
              mbar_expect_tx(&full[st], S::stage_bytes + kExtraBytes);
              unsigned char* b = smem + S::stage_off + st * S::stage_bytes;
              const int wrow = (g0 + j) * w.c0 + nt * kTile;
              if (kStream) {
                tma_load(b, &wmap, &full[st], kq * 64, wrow);
                for (int c = 0; c < kConsumers; ++c)
                  tma_load(b + (1 + c) * kSubBytes, &hmap, &full[st], kq * 64, row0 + c * kTile);
              } else {
                tma_load(b, &wmap, &full[st], 0, wrow);
                tma_load(b + kSubBytes, &wmap, &full[st], 64, wrow);
              }
              unsigned char* x = smem + S::extra_off + st * kExtraBytes;
              bulk_load(x, b0 + wrow, kTile * 4, &full[st]);
              bulk_load(x + kTile * 4, wg + wrow, kTile * 2, &full[st]);
            }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // consumer warpgroup wgi: rows 128 wgi .. of every item, every stage
  const int wgi = warp >> 2, qrow = 16 * (warp & 3) + (lane >> 2);   // row of part[.][0]
  const unsigned char* abuf = smem + S::a_off + wgi * 2 * kSubBytes;
  const auto extras = [&](int st) {   // the stage's b0 slice; its Wg slice follows
    return reinterpret_cast<const float*>(smem + S::extra_off + st * kExtraBytes);
  };
  const auto stage_part = [&](const float (&part)[2][2], int j) {   // row sums -> staging
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = part[h][r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) ost[(kTile * wgi + 64 * h + qrow + 8 * r) * S::ldo + j] = v;
      }
  };
  int s = 0, il = 0;
  for (int item = blockIdx.x; item < w.items; item += gridDim.x, ++il) {
    const int tile = item / w.nchunks, ch = item % w.nchunks;
    const int g0 = ch * w.chunk, cg = min(w.chunk, w.k - g0), row0 = tile * kRows;
    if constexpr (kStream) {
      for (int j = 0; j < cg; ++j) {
        float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // m64 half, rows qrow / qrow + 8
        for (int nt = 0; nt < nsl; ++nt) {
          float acc[2][64];
          for (int kq = 0; kq < nkq; ++kq, ++s) {
            const int st = s % NS;
            mbar_wait(&full[st], (s / NS) & 1);
            const unsigned char* b = smem + S::stage_off + st * S::stage_bytes;
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < S::kK16; ++kk) {   // k16 steps of the 64-deep slice
              const uint64_t db = sw128_desc(b) + 2 * kk;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint64_t da = sw128_desc(b + (1 + wgi) * kSubBytes + h * 64 * 128) + 2 * kk;
                wgmma_m64n128k16(acc[h], da, db, kq > 0 || kk > 0);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            if (kq == nkq - 1) {
              const float* x = extras(st);
              epilogue(acc[0], x, reinterpret_cast<const bf16*>(x + kTile), part[0]);
              epilogue(acc[1], x, reinterpret_cast<const bf16*>(x + kTile), part[1]);
            }
            mbar_arrive(&empty[st]);
          }
        }
        stage_part(part, j);
      }
    } else {
      // the warpgroup's h rows as A fragments for the whole item (2 halves x
      // 8 k16 steps); the shared half is released with the item's last wait
      uint32_t ha[2][8][4];
      mbar_wait(&afull[wgi], il & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          lds_a_sw128(ha[h][kk], abuf + (kk >> 2) * kSubBytes, 64 * h + 16 * (warp & 3), kk & 3);
      // The products read the A registers while they run: keep the compiler
      // from giving them to other values before the products' last wait.
      const auto fence_ha = [&] {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(ha[h][kk][e])::"memory");
      };
      fence_ha();
      // software pipeline over the item's groups, an m64 half at a time: the
      // next group's products for a half go out as soon as that half's
      // epilogue has read its accumulators
      float acc[2][64];
      const auto issue = [&](auto half, int st) {   // half: std::integral_constant
        constexpr int h = decltype(half)::value;
        const unsigned char* b = smem + S::stage_off + st * S::stage_bytes;
        fence_acc(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n128k16_rs(acc[h], ha[h][kk],
                              sw128_desc(b + (kk >> 2) * kSubBytes) + 2 * (kk & 3), kk > 0);
        wgmma_commit();
      };
      // an epilogue of one half, reading the stage's b0 and Wg slices
      const auto epi = [&](int st, const float (&d)[64], float (&part)[2]) {
        const float* x = extras(st);
        epilogue(d, x, reinterpret_cast<const bf16*>(x + kTile), part);
      };
      mbar_wait(&full[s % NS], (s / NS) & 1);
      issue(std::integral_constant<int, 0>{}, s % NS);
      issue(std::integral_constant<int, 1>{}, s % NS);
      // no product is issued under a condition (ptxas would serialize them):
      // the last group is peeled off the loop
      for (int j = 0; j + 1 < cg; ++j, ++s) {
        const int st = s % NS, nx = (s + 1) % NS;
        float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        wgmma_wait<1>();   // half 0 of group j
        fence_acc(acc[0]);
        epi(st, acc[0], part[0]);
        mbar_wait(&full[nx], ((s + 1) / NS) & 1);
        issue(std::integral_constant<int, 0>{}, nx);
        wgmma_wait<1>();   // half 1 of group j
        fence_acc(acc[1]);
        epi(st, acc[1], part[1]);
        mbar_arrive(&empty[st]);
        issue(std::integral_constant<int, 1>{}, nx);
        stage_part(part, j);
      }
      {
        const int st = s % NS;
        float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        wgmma_wait<0>();
        fence_ha();
        mbar_arrive(&aempty[wgi]);   // the item's products are done with its h rows
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        epi(st, acc[0], part[0]);
        epi(st, acc[1], part[1]);
        mbar_arrive(&empty[st]);
        stage_part(part, cg - 1);
        ++s;
      }
    }
    // the item's sums, row segments of cg values, bg added
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    const int rows = min(kRows, w.R - row0);
    for (int e = threadIdx.x; e < rows * cg; e += 128 * kConsumers) {
      const int r = e / cg, c = e - r * cg;
      out[static_cast<size_t>(row0 + r) * w.k + g0 + c] = ost[r * S::ldo + c] + bg[g0 + c];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so the library needs no link to libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) row-major bf16 tensor as TMA boxes of 64 columns x 128
// rows, 128-byte swizzle; rows past the end read as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int cols, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, kTile}, elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Groups a chunk: the chunking (at most `cap` groups a chunk) whose busiest
// block, over persistent blocks taking items round robin, has the least work
// (a group's steps, and one group's worth an item for its h tile and flush).
void split_work(Work& w, int tiles, int cap, int sms) {
  long long best = -1;
  const int nmin = (w.k + cap - 1) / cap;
  for (int nc = nmin; nc <= nmin + 5 && nc <= w.k; ++nc) {
    const int chunk = (w.k + nc - 1) / nc, n = (w.k + chunk - 1) / chunk;
    const int items = tiles * n, blocks = items < sms ? items : sms;
    long long worst = 0;
    for (int b = 0; b < blocks; ++b) {
      long long load = 0;
      for (int i = b; i < items; i += blocks) {
        const int left = w.k - (i % n) * chunk;
        load += (left < chunk ? left : chunk) + 1;
      }
      worst = load > worst ? load : worst;
    }
    if (best < 0 || worst < best) {
      best = worst;
      w.chunk = chunk, w.nchunks = n, w.items = items;
    }
  }
}

template <bool kStream>
int launch(const CUtensorMap& hmap, const CUtensorMap& wmap, const float* b0, const bf16* wg,
           const float* bg, float* out, Work w, cudaStream_t stream) {
  using S = Smem<kStream>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  split_work(w, (w.R + kRows - 1) / kRows, S::kMaxChunk, sms);
  if ((err = etch_allow_smem(grouped_head_kernel<kStream>, S::bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = w.items < sms ? w.items : sms;
  grouped_head_kernel<kStream><<<blocks, kThreads, S::bytes, stream>>>(hmap, wmap, b0, wg, bg,
                                                                       out, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h (R, c0) bf16, w0t = W0^T (k*c0, c0) bf16, b0 (k*c0) f32, wg (k, c0)
// bf16, bg (k) f32 -> out (R, k) f32.  c0 a multiple of 128.
ETCH_API int etch_grouped_head(const void* h, const void* w0t, const float* b0, const void* wg,
                               const float* bg, float* out, int R, int k, int c0,
                               cudaStream_t stream) {
  if (R < 0 || k < 1 || c0 < kTile || c0 % kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap hmap, wmap;
  if (!make_map(enc, &hmap, h, c0, R) || !make_map(enc, &wmap, w0t, c0, k * c0))
    return static_cast<int>(cudaErrorInvalidValue);
  Work w;
  w.R = R, w.k = k, w.c0 = c0;
  const bf16* wgb = static_cast<const bf16*>(wg);
  return c0 == kTile ? launch<false>(hmap, wmap, b0, wgb, bg, out, w, stream)
                     : launch<true>(hmap, wmap, b0, wgb, bg, out, w, stream);
}
