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
// Shared memory per group: k and v, 2 x 64 x (gw + 8) bf16, and the staged
// output, 4 x 16 x (gw + 8) f32, gw the group's columns: 36,864 bytes at
// E = 64, 73,728 a block.
#include "common.cuh"

namespace {

constexpr int kRows = 64;                 // query and key rows, padded: 4 warps x 16
constexpr int kGroups = 2;                // points a block
constexpr int kThreads = 128 * kGroups;

// How a point's heads sit in shared memory: head h in columns h*hp ..
// h*hp + hs - 1 of ep, zero up to hp; direct when that is the row layout of
// q, k and v themselves and rows are 16-byte multiples (cp.async, vector
// loads and stores).
struct Layout {
  int L, E, H, hs, hp, ep;
  int gw;    // layout columns a head group: a multiple of hp, at most 128
  int ld;    // k, v row stride (bf16): an odd multiple of 8
  int ldo;   // staging row stride (f32): 8 mod 32
  int direct;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Packed bf16 pair of q at `row` and layout columns col, col + 1; zero past
// the point's L rows and in padding columns.
__device__ __forceinline__ uint32_t q_pair(const bf16* __restrict__ qp, const Layout& ly, int row,
                                           int col) {
  if (row >= ly.L) return 0u;
  if (ly.direct) return __ldg(reinterpret_cast<const unsigned*>(qp + row * ly.E + col));
  float x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = (col + i) / ly.hp, d = (col + i) % ly.hp;
    x[i] = h < ly.H && d < ly.hs ? etch_f32(qp[row * ly.E + h * ly.hs + d]) : 0.f;
  }
  return etch_pack_bf16(x[0], x[1]);
}

__device__ __forceinline__ void stage(float* st, int ldo, int col, const float (&o)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
  *reinterpret_cast<float2*>(st + g * ldo + col + t2) = make_float2(o[0], o[1]);
  *reinterpret_cast<float2*>(st + (g + 8) * ldo + col + t2) = make_float2(o[2], o[3]);
}

// grid (ceil(M / kGroups), head groups); block kThreads.  HT: the head
// size for 1, 2, 4 and 8 (8 also takes 3, 5, 6, 7 padded to 8), else a bound
// on the padded head size hp (a multiple of 16).
template <int HT>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ out, int M, Layout ly) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int point = blockIdx.x * kGroups + group;
  if (point >= M) return;   // the whole group: only group barriers follow
  const int tile = kRows * ly.ld;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw) + group * 2 * tile;
  bf16* vs = ks + tile;
  float* st = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem_raw) + kGroups * 2 * tile) +
              (group * 4 + warp) * 16 * ly.ldo;
  const size_t base = static_cast<size_t>(point) * ly.L * ly.E;
  // this block's head group: layout columns c0 .. c0 + ew - 1, heads h0 ..
  const int c0 = blockIdx.y * ly.gw, ew = min(ly.gw, ly.ep - c0), h0 = c0 / ly.hp;

  const int tid = threadIdx.x & 127;
  if (ly.direct) {
    const int nq = ew / 8;   // 16-byte pieces of a row
    for (int e = tid; e < ly.L * nq; e += 128) {
      const int r = e / nq, c8 = 8 * (e % nq);
      etch_cp_async16(ks + r * ly.ld + c8, k + base + r * ly.E + c0 + c8);
      etch_cp_async16(vs + r * ly.ld + c8, v + base + r * ly.E + c0 + c8);
    }
    etch_cp_async_commit();
    // padded keys are masked to -inf, but their v rows meet a = 0 and must
    // be finite
    const int half = ew / 2;
    for (int e = tid; e < (kRows - ly.L) * half; e += 128) {
      const int r = ly.L + e / half, c2 = 2 * (e % half);
      *reinterpret_cast<uint32_t*>(ks + r * ly.ld + c2) = 0u;
      *reinterpret_cast<uint32_t*>(vs + r * ly.ld + c2) = 0u;
    }
    etch_cp_async_wait<0>();
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kRows * ew; e += 128) {
      const int r = e / ew, col = e % ew, h = (c0 + col) / ly.hp, d = (c0 + col) % ly.hp;
      const bool in = r < ly.L && h < ly.H && d < ly.hs;
      const size_t src = base + r * ly.E + h * ly.hs + d;
      ks[r * ly.ld + col] = in ? k[src] : zero;
      vs[r * ly.ld + col] = in ? v[src] : zero;
    }
  }
  etch_group_sync(group);   // k and v of all 64 rows are in place

  const bf16* qp = q + base;
  const int r0 = 16 * warp, g = lane >> 2, t2 = 2 * (lane & 3);
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
          [&](int kt, uint32_t (&a)[4]) {   // 16 columns of the head at a time
            const int c = c0 + hc + 16 * kt + t2;
            a[0] = q_pair(qp, ly, r0 + g, c);
            a[1] = q_pair(qp, ly, r0 + g + 8, c);
            a[2] = q_pair(qp, ly, r0 + g, c + 8);
            a[3] = q_pair(qp, ly, r0 + g + 8, c + 8);
          },
          ks + hc, vs + hc, ly.ld, ly.L, ly.hp / 16,
          [&](int j, const float (&o0)[4], const float (&o1)[4]) {
            stage(st, ly.ldo, hc + 16 * j, o0);
            stage(st, ly.ldo, hc + 16 * j + 8, o1);
          });
    }
  }
  __syncwarp();

  // the warp's rows r0 .. r0 + 15 that exist, from the staging rows
  const int rows = min(16, ly.L - r0);
  float* op = out + base + static_cast<size_t>(r0) * ly.E;
  if (ly.direct) {
    const int nq = ew / 4;
    for (int e = lane; e < rows * nq; e += 32) {
      const int r = e / nq, c4 = 4 * (e % nq);
      __stcs(reinterpret_cast<float4*>(op + r * ly.E + c0 + c4),
             *reinterpret_cast<const float4*>(st + r * ly.ldo + c4));
    }
  } else {   // the group's heads' own columns
    const int e0 = h0 * ly.hs, ec = min(ly.E - e0, (ew / ly.hp) * ly.hs);
    for (int e = lane; e < rows * ec; e += 32) {
      const int r = e / ec, col = e % ec;
      op[r * ly.E + e0 + col] = st[r * ly.ldo + (col / ly.hs) * ly.hp + col % ly.hs];
    }
  }
}

template <int HT>
int launch(const bf16* q, const bf16* k, const bf16* v, float* out, int M, const Layout& ly,
           cudaStream_t stream) {
  const size_t smem = kGroups * (2 * static_cast<size_t>(kRows) * ly.ld * sizeof(bf16) +
                                 4 * 16 * static_cast<size_t>(ly.ldo) * sizeof(float));
  cudaError_t err = etch_allow_smem(attention_kernel<HT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kGroups - 1) / kGroups, (ly.ep + ly.gw - 1) / ly.gw);
  attention_kernel<HT><<<grid, kThreads, smem, stream>>>(q, k, v, out, M, ly);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v (M, L, E) bf16 -> out (M, L, E) f32.  L <= 64, H divides E and
// the head size is at most 128.
ETCH_API int etch_attention(const void* q, const void* k, const void* v, float* out, int M,
                            int L, int E, int H, cudaStream_t stream) {
  if (L < 1 || L > kRows || H < 1 || E % H != 0 || E / H > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout ly;
  ly.L = L;
  ly.E = E;
  ly.H = H;
  ly.hs = E / H;
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
    ht = ly.hp <= 16 ? 16 : ly.hp <= 32 ? 32 : ly.hp <= 64 ? 64 : 128;
    ly.ep = H * ly.hp;
  }
  ly.direct = ly.hp == hs && E % 8 == 0;
  ly.gw = ly.ep <= 128 ? ly.ep : 128 / ly.hp * ly.hp;
  ly.ld = round_up(ly.gw, 16) + 8;
  ly.ldo = round_up(ly.gw, 32) + 8;
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
    default: return launch<128>(qb, kb, vb, out, M, ly, stream);
  }
}
