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
// Bound on the H100: the bytes.  A 2048-point chunk at L=60, E=64 reads 47 MB
// of bf16 q, k, v and writes 31 MB of f32: 0.0235 ms at 3.35 TB/s.  Next come
// the exponentials, 67 M with the keys padded to 64, about 0.017 ms through
// the special-function units (16 a clock an SM); the products are a few
// GFLOP.  Design, the direction core's attention (csrc/dircore.cu) as a
// kernel of its own; both call the per-head attention of common.cuh
// (etch_attention_tile8, etch_attention_head16):
//   - kGroups points a block, 4 warps each; a warp owns 16 of the 64 padded
//     query rows.  Each group copies its point's k and v into shared memory
//     by 16-byte cp.async as bf16 rows padded by 8 elements (ldmatrix phases
//     free of bank conflicts), with rows L..63 zero; q goes from device
//     memory straight into A fragments.
//   - Per head, S = q_h k_h^T on the tensor cores: m16n8k8 for head sizes up
//     to 8 (sizes 1, 2 and 4 mask q to their head's columns of an 8-column
//     tile, exact since the other columns add zeros), k16 steps of m16n8k16
//     above.  Head sizes that are neither 1, 2, 4 nor a multiple of 16 are
//     laid out in shared memory with each head padded by zero columns to 8
//     or to a multiple of 16 (also exact); that layout is gathered element by
//     element.
//   - The softmax runs on the S fragments (etch_softmax_frags: keys L..63 at
//     -inf, max and sum over a row's 4 lanes, exp as ex2.approx), and
//     a = bf16(exp(z - m) / den) is packed straight into the A fragments of
//     o_h = a v_h (m16n8k16 over the 64 keys, v by ldmatrix.trans).
//   - o is staged per warp in shared memory and leaves as 16-byte streaming
//     stores of whole rows (the f32 output is 40% of the bytes).
//   - Heads are independent, so a point's heads run in groups of at most
//     128 layout columns on the grid's second axis (E = 256: two groups);
//     each group's block holds only its columns of k, v and the output.
//     A head wider than 128 columns is a group of its own, and its block
//     takes one point, not kGroups: two points' tiles would not fit shared
//     memory.  Above 256 columns the head runs in 256-column slices: its
//     logits add up over the slices of q and k (each slice of k in shared
//     memory in turn), then the softmax, then o = a v slice by slice (each
//     slice of v in turn), so shared memory holds at most 256 columns.
// Shared memory per point: k and v, 2 x 64 x (gw + 8) bf16, and the staged
// output, 4 x 16 x (gw + 8) f32, gw the group's columns (at most 256): 36,864
// bytes at E = 64 (73,728 a block), 135,168 at a head of 256 or more.
// The direction core's wide route (csrc/dircore_big.cu) calls the kernel
// through etch_attention_rows: rows of q, k and v with a stride of their own
// (its head layout), and o written as bf16.
#include "common.cuh"

namespace {

constexpr int kRows = 64;                 // query and key rows, padded: 4 warps x 16
constexpr int kGroups = 2;                // points a block
constexpr int kSliceCols = 256;           // columns of a head in shared memory at once
constexpr int kWide = 2 * kSliceCols;     // the instance for heads above kSliceCols

// How a point's heads sit in shared memory: head h in columns h*hp ..
// h*hp + hs - 1 of ep, zero up to hp; direct when that is the row layout of
// q, k and v themselves and rows are 16-byte multiples (cp.async, vector
// loads and stores).
struct Layout {
  int L, E, H, hs, hp, ep;
  int ldr;   // row stride of q, k, v and the output (elements): E, or wider
  int gw;    // layout columns a head group: a multiple of hp, at most 128 (or one head)
  int ld;    // k, v row stride (bf16): an odd multiple of 8
  int ldo;   // staging row stride (f32): 8 mod 32
  int direct;
  int out_bf16;   // the output as bf16 (else f32)
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Packed bf16 pair of q at `row` and layout columns col, col + 1; zero past
// the point's L rows and in padding columns.
__device__ __forceinline__ uint32_t q_pair(const bf16* __restrict__ qp, const Layout& ly, int row,
                                           int col) {
  if (row >= ly.L) return 0u;
  if (ly.direct) return __ldg(reinterpret_cast<const unsigned*>(qp + row * ly.ldr + col));
  float x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = (col + i) / ly.hp, d = (col + i) % ly.hp;
    x[i] = h < ly.H && d < ly.hs ? etch_f32(qp[row * ly.ldr + h * ly.hs + d]) : 0.f;
  }
  return etch_pack_bf16(x[0], x[1]);
}

__device__ __forceinline__ void stage(float* st, int ldo, int col, const float (&o)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
  *reinterpret_cast<float2*>(st + g * ldo + col + t2) = make_float2(o[0], o[1]);
  *reinterpret_cast<float2*>(st + (g + 8) * ldo + col + t2) = make_float2(o[2], o[3]);
}

// Points a block: kGroups, or one for a head wider than 128 columns.
__host__ __device__ constexpr int points_a_block(int HT) { return HT > 128 ? 1 : kGroups; }

// Layout columns col0 .. col0 + w - 1 of the point's rows of k (and of v
// when kBoth) into ks (vs), 64 x ld bf16 each, rows L..63 zero (padded keys
// are masked to -inf, but their v rows meet a = 0 and must be finite); by
// the group's 128 threads, complete once they have waited for their
// cp.async groups and the group has synchronised.
template <bool kBoth>
__device__ __forceinline__ void load_rows(bf16* ks, const bf16* __restrict__ k, bf16* vs,
                                          const bf16* __restrict__ v, const Layout& ly, int col0,
                                          int w) {
  const int tid = threadIdx.x & 127;
  if (ly.direct) {
    const int nq = w / 8;   // 16-byte pieces of a row
    for (int e = tid; e < ly.L * nq; e += 128) {
      const int r = e / nq, c8 = 8 * (e % nq);
      etch_cp_async16(ks + r * ly.ld + c8, k + r * ly.ldr + col0 + c8);
      if (kBoth) etch_cp_async16(vs + r * ly.ld + c8, v + r * ly.ldr + col0 + c8);
    }
    etch_cp_async_commit();
    const int half = w / 2;
    for (int e = tid; e < (kRows - ly.L) * half; e += 128) {
      const int r = ly.L + e / half, c2 = 2 * (e % half);
      *reinterpret_cast<uint32_t*>(ks + r * ly.ld + c2) = 0u;
      if (kBoth) *reinterpret_cast<uint32_t*>(vs + r * ly.ld + c2) = 0u;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kRows * w; e += 128) {
      const int r = e / w, col = e % w, h = (col0 + col) / ly.hp, d = (col0 + col) % ly.hp;
      const bool in = r < ly.L && h < ly.H && d < ly.hs;
      const int src = r * ly.ldr + h * ly.hs + d;
      ks[r * ly.ld + col] = in ? k[src] : zero;
      if (kBoth) vs[r * ly.ld + col] = in ? v[src] : zero;
    }
  }
}

// The warp's staged rows (`rows` of them, staging columns 0 .. w - 1) to
// layout columns col0 .. col0 + w - 1 of the output rows at op (OutT: f32,
// or bf16 for the direction core's wide route).
template <typename OutT>
__device__ __forceinline__ void store_rows(OutT* op, const float* st, const Layout& ly, int rows,
                                           int col0, int w) {
  const int lane = threadIdx.x & 31;
  if (ly.direct) {
    const int nq = w / 4;
    for (int e = lane; e < rows * nq; e += 32) {
      const int r = e / nq, c4 = 4 * (e % nq);
      const float4 o = *reinterpret_cast<const float4*>(st + r * ly.ldo + c4);
      OutT* at = op + static_cast<size_t>(r) * ly.ldr + col0 + c4;
      if constexpr (sizeof(OutT) == 2)
        *reinterpret_cast<uint2*>(at) = make_uint2(etch_pack_bf16(o.x, o.y), etch_pack_bf16(o.z, o.w));
      else
        __stcs(reinterpret_cast<float4*>(at), o);
    }
  } else {   // the layout columns that are columns of a head
    for (int e = lane; e < rows * w; e += 32) {
      const int r = e / w, col = e % w, h = (col0 + col) / ly.hp, d = (col0 + col) % ly.hp;
      if (h < ly.H && d < ly.hs)
        etch_store(op + static_cast<size_t>(r) * ly.ldr + h * ly.hs + d, st[r * ly.ldo + col]);
    }
  }
}

// The warp's staged rows to the output, of the type ly.out_bf16 names.
__device__ __forceinline__ void store_out(void* out, size_t at, const float* st, const Layout& ly,
                                          int rows, int col0, int w) {
  if (ly.out_bf16)
    store_rows(static_cast<bf16*>(out) + at, st, ly, rows, col0, w);
  else
    store_rows(static_cast<float*>(out) + at, st, ly, rows, col0, w);
}

// grid (ceil(M / points_a_block(HT)), head groups); block 128 points.  HT:
// the head size for 1, 2, 4 and 8 (8 also takes 3, 5, 6, 7 padded to 8),
// a bound on the padded head size hp (a multiple of 16) up to 256, or kWide
// for heads above 256 columns.
template <int HT>
__global__ void __launch_bounds__(128 * points_a_block(HT))
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ out, int M, Layout ly) {
  constexpr int kPoints = points_a_block(HT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int point = blockIdx.x * kPoints + group;
  if (point >= M) return;   // the whole group: only group barriers follow
  const int tile = kRows * ly.ld;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw) + group * 2 * tile;
  bf16* vs = ks + tile;
  float* st = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem_raw) + kPoints * 2 * tile) +
              (group * 4 + warp) * 16 * ly.ldo;
  const size_t base = static_cast<size_t>(point) * ly.L * ly.ldr;
  // this block's head group: layout columns c0 .. c0 + ew - 1
  const int c0 = blockIdx.y * ly.gw, ew = min(ly.gw, ly.ep - c0);
  const bf16* qp = q + base;
  const int r0 = 16 * warp, g = lane >> 2, t2 = 2 * (lane & 3);
  // the warp's rows r0 .. r0 + 15 that exist
  const int rows = min(16, ly.L - r0);
  const size_t obase = base + static_cast<size_t>(r0) * ly.ldr;
  const auto qa16 = [&](int col, uint32_t (&a)[4]) {   // q's A fragment at layout column col
    a[0] = q_pair(qp, ly, r0 + g, col + t2);
    a[1] = q_pair(qp, ly, r0 + g + 8, col + t2);
    a[2] = q_pair(qp, ly, r0 + g, col + t2 + 8);
    a[3] = q_pair(qp, ly, r0 + g + 8, col + t2 + 8);
  };

  if constexpr (HT == kWide) {   // one head of hp > kSliceCols columns, in slices
    float s[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][e] = 0.f;
    for (int sc = 0; sc < ly.hp; sc += kSliceCols) {
      const int sw = min(kSliceCols, ly.hp - sc);
      load_rows<false>(ks, k + base, nullptr, nullptr, ly, c0 + sc, sw);
      etch_cp_async_wait<0>();
      etch_group_sync(group);   // the slice of k is in place
      etch_attention_logits16<kSliceCols / 16>(
          [&](int kt, uint32_t (&a)[4]) { qa16(c0 + sc + 16 * kt, a); }, ks, ly.ld, sw / 16, s);
      etch_group_sync(group);   // every warp is done with it
    }
    uint32_t p[4][4];
    etch_softmax_frags(s, ly.L, p);
    for (int sc = 0; sc < ly.hp; sc += kSliceCols) {
      const int sw = min(kSliceCols, ly.hp - sc);
      load_rows<false>(vs, v + base, nullptr, nullptr, ly, c0 + sc, sw);
      etch_cp_async_wait<0>();
      etch_group_sync(group);
      etch_attention_pv16<kSliceCols / 16>(p, vs, ly.ld, sw / 16,
                                           [&](int j, const float (&o0)[4], const float (&o1)[4]) {
                                             stage(st, ly.ldo, 16 * j, o0);
                                             stage(st, ly.ldo, 16 * j + 8, o1);
                                           });
      __syncwarp();
      store_out(out, obase, st, ly, rows, c0 + sc, sw);
      __syncwarp();             // the staging is read before the next slice's output
      etch_group_sync(group);   // every warp is done with the slice of v
    }
  } else {
    load_rows<true>(ks, k + base, vs, v + base, ly, c0, ew);
    etch_cp_async_wait<0>();
    etch_group_sync(group);   // k and v of all 64 rows are in place

    if constexpr (HT <= 8) {
      for (int nt = 0; nt < ew / 8; ++nt) {   // 8-column tile of q, k, v, o
        float ot[4];
        etch_attention_tile8<HT>(
            [&](uint32_t& a0, uint32_t& a1) {
              a0 = q_pair(qp, ly, r0 + g, c0 + 8 * nt + t2);
              a1 = q_pair(qp, ly, r0 + g + 8, c0 + 8 * nt + t2);
            },
            ks + 8 * nt, vs + 8 * nt, ly.ld, ly.L, ot);
        stage(st, ly.ldo, 8 * nt, ot);
      }
    } else {
      for (int hc = 0; hc < ew; hc += ly.hp) {   // the group's heads, at columns hc
        etch_attention_head16<HT / 16>(
            [&](int kt, uint32_t (&a)[4]) { qa16(c0 + hc + 16 * kt, a); },  // 16 columns at a time
            ks + hc, vs + hc, ly.ld, ly.L, ly.hp / 16,
            [&](int j, const float (&o0)[4], const float (&o1)[4]) {
              stage(st, ly.ldo, hc + 16 * j, o0);
              stage(st, ly.ldo, hc + 16 * j + 8, o1);
            });
      }
    }
    __syncwarp();
    store_out(out, obase, st, ly, rows, c0, ew);
  }
}

template <int HT>
int launch(const bf16* q, const bf16* k, const bf16* v, void* out, int M, const Layout& ly,
           cudaStream_t stream) {
  constexpr int kPoints = points_a_block(HT);
  const size_t smem = kPoints * (2 * static_cast<size_t>(kRows) * ly.ld * sizeof(bf16) +
                                 4 * 16 * static_cast<size_t>(ly.ldo) * sizeof(float));
  cudaError_t err = etch_allow_smem(attention_kernel<HT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0) return 0;
  const dim3 grid((M + kPoints - 1) / kPoints, (ly.ep + ly.gw - 1) / ly.gw);
  attention_kernel<HT><<<grid, 128 * kPoints, smem, stream>>>(q, k, v, out, M, ly);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: M points of L rows, row stride ldr >= E (elements), E = H heads
// of E / H columns -> out, the same rows: f32, or bf16 when out_bf16.
int etch_attention_rows(const void* q, const void* k, const void* v, void* out, int out_bf16,
                        int M, int L, int E, int H, int ldr, cudaStream_t stream) {
  if (L < 1 || L > kRows || H < 1 || E % H != 0 || ldr < E)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout ly;
  ly.L = L;
  ly.E = E;
  ly.H = H;
  ly.hs = E / H;
  ly.ldr = ldr;
  ly.out_bf16 = out_bf16;
  const int hs = ly.hs;
  int ht;
  if (hs == 1 || hs == 2 || hs == 4) {   // several heads an 8-column tile
    ht = ly.hp = hs;
    ly.ep = round_up(E, 8);
  } else if (hs <= 8) {                  // one head an 8-column tile
    ht = ly.hp = 8;
    ly.ep = 8 * H;
  } else {                               // k16 steps
    ly.hp = round_up(hs, 16);
    ht = ly.hp <= 16 ? 16 : ly.hp <= 32 ? 32 : ly.hp <= 64 ? 64 : ly.hp <= 128 ? 128
       : ly.hp <= kSliceCols ? 256 : kWide;
    ly.ep = H * ly.hp;
  }
  ly.direct = ly.hp == hs && E % 8 == 0 && ldr % 8 == 0;
  ly.gw = ly.ep <= 128 ? ly.ep : ly.hp > 128 ? ly.hp : 128 / ly.hp * ly.hp;
  const int cols = ly.gw < kSliceCols ? ly.gw : kSliceCols;   // in shared memory at once
  ly.ld = round_up(cols, 16) + 8;
  ly.ldo = round_up(cols, 32) + 8;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  switch (ht) {
    case 1: return launch<1>(qb, kb, vb, out, M, ly, stream);
    case 2: return launch<2>(qb, kb, vb, out, M, ly, stream);
    case 4: return launch<4>(qb, kb, vb, out, M, ly, stream);
    case 8: return launch<8>(qb, kb, vb, out, M, ly, stream);
    case 16: return launch<16>(qb, kb, vb, out, M, ly, stream);
    case 32: return launch<32>(qb, kb, vb, out, M, ly, stream);
    case 64: return launch<64>(qb, kb, vb, out, M, ly, stream);
    case 128: return launch<128>(qb, kb, vb, out, M, ly, stream);
    case 256: return launch<256>(qb, kb, vb, out, M, ly, stream);
    default: return launch<kWide>(qb, kb, vb, out, M, ly, stream);
  }
}

// q, k, v (M, L, E) bf16 -> out (M, L, E) f32.  L <= 64 and H divides E.
ETCH_API int etch_attention(const void* q, const void* k, const void* v, float* out, int M,
                            int L, int E, int H, cudaStream_t stream) {
  return etch_attention_rows(q, k, v, out, 0, M, L, E, H, E, stream);
}
