// Point-Transformer vector attention, with the neighbour gathers fused in.
//
// Replaces etch_tpu/nn/pallas_vector_attention.py:vector_attention_pallas
// (_kernel).  For row r (point n of cloud b) with neighbours
// m_j = b*N + idx[r, j], j < ns:
//
//   w_j  = bf16(relu((xk[m_j] - xq[r] + pe[r, j]) * a0[0] + a0[1]))   (c)
//   z_j  = bf16(relu((w_j W0) * a1[0] + a1[1]))                      (cs)
//   l_j  = z_j W1 + b1                                               (cs, f32)
//   s_j  = softmax over j of l_j                                      (per lane)
//   out[r, ch] = sum_j (xv[m_j, ch] + pe[r, j, ch]) * s_j[ch % cs]    (f32)
//
// Operands xq, xk, xv, pe, W0, W1 are bf16; a0, a1, b1 and every sum are
// f32.  Attention lane l weighs channels l, l + cs, l + 2cs, ... (the
// reference's reshape(R, ns, s, cs)).  b1 is added as the reference adds it;
// the TPU kernel drops it, which gives the same softmax.  The TPU kernel
// takes neighbour-major operands gathered beforehand, (ns, R, c) for each of
// k, v and pe; here a warp gathers its rows of k and v itself from the
// (B, N, c) projections by index, so neither gathered tensor exists in
// device memory.
//
// Bound on the H100: the bytes.  Per point it reads ns pe rows and, through
// the L2, 2 ns gathered rows of c bf16 values, for about 2 ns c (cs + 4)
// FLOPs: a few FLOPs a byte.  Design:
//   - A warp owns an m16 tile of (point, neighbour) rows: the point's ns
//     neighbours padded to rp rows (a power of two up to 16, so 16 / rp
//     points a tile: 2 at ns = 8, 1 at ns = 16), or, for ns > 16, one point
//     over rp / 16 tiles.  Padded rows read a valid row and get -inf logits.
//   - The w rows are formed in registers straight into the bf16 A fragments
//     of mma.sync m16n8k16, from 16-byte loads of the gathered xk row, the
//     xq row and the pe row: lane t of a quad loads channels 8t .. 8t + 7 of
//     each 32-channel chunk, which serve as the fragment's k columns t2,
//     t2 + 1, t2 + 8, t2 + 9 of two k16 steps (a permutation of the summed
//     channels; W0's fragments are packed in the same order).  The affine,
//     ReLU and bf16 rounding happen where the plain version has them.
//   - W0 (c x cs) and W1 (cs x cs) are copied once into shared memory per
//     persistent block, as bf16 in fragment order (each lane's B fragments of
//     a k16 step and n8 tile one 8-byte word), with a0, a1 and b1.
//   - z's accumulators take the a1 affine, ReLU and bf16 rounding and are
//     reused as the A fragments of the second product (the m16n8
//     accumulator layout is the m16k16 A layout); cs = 8 takes m16n8k8, and
//     cs not a multiple of 8 runs on zero-padded columns (exact).
//   - The softmax over each point's rows runs in registers: within the thread
//     over rows g and g + 8 (rp = 16), across lanes by xor-shuffles over the
//     row-group bits; exp as ex2.approx.  For ns > 16 the logits pass
//     through shared memory and a lane a column takes the softmax there.
//   - The weighted sum runs with lanes over (point, 8-channel chunk) items
//     and, where those are fewer than 32, over neighbour subsets reduced by
//     xor-shuffles; v rows by 16-byte loads, s through a per-warp (rows x cs)
//     f32 tile in shared memory, the output as 16-byte f32 stores.  The pe
//     rows are staged once per tile by cp.async, so both uses read them from
//     shared memory.
//   - At c >= 256 (c a multiple of 64), 2 or 4 warps split one tile's
//     channels: each forms its slice of w and its partial first product,
//     the partial z sums meet in shared memory (summed in one order by every
//     warp), and each warp then weighs its own channels.  That puts 4x the
//     warps on the small-R levels, which are latency-bound.
//
// Rows above 520 channels (cs = c / 8 above 64: a U-Net level of 1024
// planes) run vector_attention_wide_kernel: the accumulators of a whole
// (16, cs) tile no longer fit the registers, nor W0 shared memory (256 KB at
// c = 1024).  It keeps the first design's fragments, rounding points and
// softmax, and differs in this:
//   - W0 and W1 are packed once by the wrapper into the same fragment order
//     in device memory (nn/vector_attention.py:pack_fragments) and read
//     from the L2 by each warp;
//   - z = w W0 runs in column blocks of 64 (8 n8 tiles), forming the w
//     fragments again for each block; each block's z, after the a1 affine,
//     ReLU and bf16 rounding, goes to a (16, cs) bf16 tile of the warp's in
//     shared memory, so every logit is the full sum over c before the
//     softmax;
//   - l = z W1 runs in column blocks of 64 too, its A fragments by ldmatrix
//     from the z tile, and each block's softmax over the point's rows is
//     taken where the first design takes it;
//   - pe is read from device memory in both uses (not staged), so shared
//     memory grows with cs and the rows a point, not with c.
// Rows whose c is not a multiple of 8 reach both kernels padded by the
// wrapper with zero channels (their w is relu(0 * 0 + 0) = 0 and their W0
// rows are zero), and the padded outputs are dropped.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps a block

// The launch's sizes, computed once on the host (launch_va).
struct VaShape {
  int R, N, ns, c, cs;
  int rp;     // rows a point: ns rounded up to a power of two <= 16, or to a multiple of 16
  int rows;   // rows a warp's unit: max(16, rp)
  int ks;     // warps that split a tile's channels (1, 2 or 4)
  int cw;     // channels a warp: c / ks
  int ldp;    // pe tile row stride (bf16): 32 mod 64, so quad rows take other banks
  int cpad;   // c rounded up to 32 (W0's packed rows)
  int span;   // weighted-sum items a pass: min(32, items rounded up to a power of two)
};

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = etch_unpack_bf16(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// 1 / x, approximate (about 1 ulp; no call to the IEEE division's slow path).
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier of the ks warps of channel group `grp` (named barrier grp + 1).
__device__ __forceinline__ void group_sync(int grp, int ks) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(32 * ks) : "memory");
}

template <int NT>
struct Smem {
  static constexpr int kCp = 8 * NT;                         // cs padded
  static constexpr int kK1 = (NT + 1) / 2;                   // k16 steps of the second product
  static constexpr int kLdS = (kCp + 31) / 32 * 32 + 8;      // s tile row stride (f32)
  __host__ __device__ static size_t shared_bytes(const VaShape& sh) {
    return static_cast<size_t>(sh.cpad) * NT * 16 + kK1 * NT * 256 +
           (2 * sh.cpad + 3 * kCp) * 4;
  }
  __host__ __device__ static size_t warp_bytes(const VaShape& sh) {
    return static_cast<size_t>(sh.rows) * (4 + 2 * sh.ldp + 4 * kLdS) +
           (sh.ks > 1 ? NT * 32 * 16 : 0);
  }
};

// grid: persistent blocks; block kWarps * 32.  NT: n8 tiles of cs.
template <int NT>
__global__ void __launch_bounds__(kWarps * 32)
vector_attention_kernel(const bf16* __restrict__ xq, const bf16* __restrict__ xk,
                        const bf16* __restrict__ xv, const int32_t* __restrict__ idx,
                        const bf16* __restrict__ pe, const float* __restrict__ a0,
                        const float* __restrict__ w0, const float* __restrict__ a1,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        float* __restrict__ out, VaShape sh) {
  using S = Smem<NT>;
  constexpr int kCp = S::kCp, kK1 = S::kK1, kLdS = S::kLdS;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* w0s = reinterpret_cast<uint2*>(smem_raw);            // [cpad / 16][NT][32]
  uint2* w1s = w0s + (sh.cpad / 16) * NT * 32;                // [kK1][NT][32]
  float* a0s = reinterpret_cast<float*>(w1s + kK1 * NT * 32); // [2][cpad]
  float* a1s = a0s + 2 * sh.cpad;                             // [2][kCp]
  float* b1s = a1s + 2 * kCp;                                 // [kCp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem_raw + S::shared_bytes(sh) + warp * S::warp_bytes(sh);
  int* sidx = reinterpret_cast<int*>(wb);                                  // rows
  bf16* pes = reinterpret_cast<bf16*>(sidx + sh.rows);                     // rows x ldp
  float* st = reinterpret_cast<float*>(pes + sh.rows * sh.ldp);            // rows x kLdS
  float4* xch = reinterpret_cast<float4*>(st + sh.rows * kLdS);            // [NT][32]

  {
    // W0 and W1 into shared memory as bf16 B fragments, zero-padded: W0[r,
    // col] is value r % 4 of lane 4 (col % 8) + (r / 8) % 4's word of k16 step
    // 2 (r / 32) + (r / 4) % 2, tile col / 8; W1[r, col] is value 2 ((r / 8)
    // % 2) + r % 2 of lane 4 (col % 8) + (r / 2) % 4's word of k16 step r /
    // 16, tile col / 8
    const int n16 = (sh.cpad / 16 + kK1) * NT * 32 / 2;   // 16-byte pieces of both
    for (int e = threadIdx.x; e < n16; e += blockDim.x)
      reinterpret_cast<uint4*>(w0s)[e] = make_uint4(0u, 0u, 0u, 0u);
    for (int e = threadIdx.x; e < 2 * sh.cpad; e += blockDim.x) {
      const int h = e / sh.cpad, ch = e % sh.cpad;
      a0s[e] = ch < sh.c ? a0[h * sh.c + ch] : 0.f;
    }
    for (int e = threadIdx.x; e < 3 * kCp; e += blockDim.x) {
      const int h = e / kCp, col = e % kCp;
      const float v = col >= sh.cs ? 0.f : h < 2 ? a1[h * sh.cs + col] : b1[col];
      a1s[e] = v;   // a1s then b1s, contiguous
    }
    __syncthreads();
    bf16* w0b = reinterpret_cast<bf16*>(w0s);
    bf16* w1b = reinterpret_cast<bf16*>(w1s);
    const auto w0at = [&](int r, int col) {
      return ((((2 * (r >> 5) + ((r >> 2) & 1)) * NT + (col >> 3)) * 32 + 4 * (col & 7) +
               ((r >> 3) & 3)) << 2) + (r & 3);
    };
    const auto w1at = [&](int r, int col) {
      return ((((r >> 4) * NT + (col >> 3)) * 32 + 4 * (col & 7) + ((r >> 1) & 3)) << 2) +
             2 * ((r >> 3) & 1) + (r & 1);
    };
    if (sh.cs % 4 == 0) {   // 16-byte loads of 4 columns
      const int q4 = sh.cs / 4, n0 = sh.c * q4;
#pragma unroll 4
      for (int e = threadIdx.x; e < n0 + sh.cs * q4; e += blockDim.x) {
        const bool first = e < n0;
        const int e1 = first ? e : e - n0, r = e1 / q4, col = 4 * (e1 % q4);
        const float4 v = __ldg(reinterpret_cast<const float4*>(first ? w0 : w1) + e1);
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (first)
            w0b[w0at(r, col + i)] = __float2bfloat16(f[i]);
          else
            w1b[w1at(r, col + i)] = __float2bfloat16(f[i]);
        }
      }
    } else {
      const int n0 = sh.c * sh.cs;
      for (int e = threadIdx.x; e < n0 + sh.cs * sh.cs; e += blockDim.x) {
        if (e < n0)
          w0b[w0at(e / sh.cs, e % sh.cs)] = __float2bfloat16(__ldg(w0 + e));
        else
          w1b[w1at((e - n0) / sh.cs, (e - n0) % sh.cs)] = __float2bfloat16(__ldg(w1 + e - n0));
      }
    }
    __syncthreads();
  }

  const int gpb = kWarps / sh.ks;                       // channel groups a block
  const int grp = warp / sh.ks, cb = (warp % sh.ks) * sh.cw;
  const int ppu = sh.rows / sh.rp;                      // points a unit
  const int units = (sh.R + ppu - 1) / ppu;
  const int g = lane >> 2, t = lane & 3, t2 = 2 * t;
  const int nq = sh.cw / 8;                             // 8-channel chunks of the warp

  for (int u = blockIdx.x * gpb + grp; u < units; u += gridDim.x * gpb) {
    const int p0 = u * ppu;
    // the unit's rows: point p0 + rr / rp, neighbour rr % rp; -1 where padded
    for (int rr = lane; rr < sh.rows; rr += 32) {
      const int p = p0 + rr / sh.rp, j = rr % sh.rp;
      sidx[rr] = j < sh.ns && p < sh.R ? (p / sh.N) * sh.N + idx[static_cast<size_t>(p) * sh.ns + j]
                                       : -1;
    }
    __syncwarp();
    for (int e = lane; e < sh.rows * nq; e += 32) {
      const int rr = e / nq, q = e % nq;
      bf16* dst = pes + rr * sh.ldp + 8 * q;
      if (sidx[rr] >= 0) {
        const int p = p0 + rr / sh.rp, j = rr % sh.rp;
        etch_cp_async16(dst, pe + (static_cast<size_t>(p) * sh.ns + j) * sh.c + cb + 8 * q);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    etch_cp_async_commit();
    etch_cp_async_wait<0>();
    __syncwarp();

    for (int r16 = 0; r16 < sh.rows; r16 += 16) {
      const int rw[2] = {r16 + g, r16 + g + 8};   // this lane's rows
      const bf16* kr[2];
      const bf16* qr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = sidx[rw[h]], p = min(p0 + rw[h] / sh.rp, sh.R - 1);
        kr[h] = xk + static_cast<size_t>(m < 0 ? 0 : m) * sh.c + cb;
        qr[h] = xq + static_cast<size_t>(p) * sh.c + cb;
      }

      // z = w W0: 32-channel chunks, two k16 steps each
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
      for (int c32 = 0; c32 < sh.cw; c32 += 32) {
        const int ch = c32 + 8 * t;   // this lane's 8 channels of the chunk
        uint32_t a[2][4];
        if (ch < sh.cw) {
          uint4 raw[2][3];   // k, q and pe of rows g and g + 8
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            raw[h][0] = ldg16(kr[h] + ch);
            raw[h][1] = ldg16(qr[h] + ch);
            raw[h][2] = *reinterpret_cast<const uint4*>(pes + rw[h] * sh.ldp + ch);
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {   // channels ch + 4s .. ch + 4s + 3
            const float4 sc = *reinterpret_cast<const float4*>(a0s + cb + ch + 4 * s);
            const float4 bi = *reinterpret_cast<const float4*>(a0s + sh.cpad + cb + ch + 4 * s);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t* kw = reinterpret_cast<const uint32_t*>(&raw[h][0]) + 2 * s;
              const uint32_t* qw = reinterpret_cast<const uint32_t*>(&raw[h][1]) + 2 * s;
              const uint32_t* pw = reinterpret_cast<const uint32_t*>(&raw[h][2]) + 2 * s;
              const float2 k0 = etch_unpack_bf16(kw[0]), k1 = etch_unpack_bf16(kw[1]);
              const float2 q0 = etch_unpack_bf16(qw[0]), q1 = etch_unpack_bf16(qw[1]);
              const float2 p0 = etch_unpack_bf16(pw[0]), p1 = etch_unpack_bf16(pw[1]);
              a[s][h] = etch_pack_bf16(fmaxf(((k0.x - q0.x) + p0.x) * sc.x + bi.x, 0.f),
                                       fmaxf(((k0.y - q0.y) + p0.y) * sc.y + bi.y, 0.f));
              a[s][2 + h] = etch_pack_bf16(fmaxf(((k1.x - q1.x) + p1.x) * sc.z + bi.z, 0.f),
                                           fmaxf(((k1.y - q1.y) + p1.y) * sc.w + bi.w, 0.f));
            }
          }
        } else {
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[s][e] = 0u;
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint2* bs = w0s + ((cb + c32) / 16 + s) * NT * 32 + lane;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint2 b = bs[j * 32];
            etch_mma_16816(acc[j], a[s], b.x, b.y);
          }
        }
      }

      if (sh.ks > 1) {   // the group's partial sums, added in one order by every warp
        const int wg = grp * sh.ks;   // the group's first warp
#pragma unroll
        for (int j = 0; j < NT; ++j)
          xch[j * 32 + lane] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        group_sync(grp, sh.ks);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        for (int kw = 0; kw < sh.ks; ++kw) {
          const float4* x = xch + (wg + kw - warp) * static_cast<int>(S::warp_bytes(sh) / 16);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float4 v = x[j * 32 + lane];
            acc[j][0] += v.x, acc[j][1] += v.y, acc[j][2] += v.z, acc[j][3] += v.w;
          }
        }
        group_sync(grp, sh.ks);   // read before the next tile writes
      }

      // z = bf16(relu(acc * a1[0] + a1[1])) as the A fragments of l = z W1
      uint32_t za[kK1][4];
#pragma unroll
      for (int kk = 0; kk < kK1; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) za[kk][e] = 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(a1s + 8 * j + t2);
        const float2 b = *reinterpret_cast<const float2*>(a1s + kCp + 8 * j + t2);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          za[j >> 1][2 * (j & 1) + h] =
              etch_pack_bf16(fmaxf(acc[j][2 * h] * s.x + b.x, 0.f),
                             fmaxf(acc[j][2 * h + 1] * s.y + b.y, 0.f));
      }
      float l[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[j][e] = 0.f;
      if constexpr (NT == 1) {
        etch_mma_1688(l[0], za[0][0], za[0][1], w1s[lane].x);
      } else {
#pragma unroll
        for (int kk = 0; kk < kK1; ++kk)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint2 b = w1s[(kk * NT + j) * 32 + lane];
            etch_mma_16816(l[j], za[kk], b.x, b.y);
          }
      }
      const bool ok[2] = {sidx[rw[0]] >= 0, sidx[rw[1]] >= 0};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(b1s + 8 * j + t2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l[j][e] = ok[e >> 1] ? l[j][e] + ((e & 1) ? b.y : b.x) : -INFINITY;
      }

      if (sh.rp <= 16) {
        // softmax over the point's rows: rows g and g + 8 are one point at
        // rp = 16; the point's rows sit in the lanes whose g differ in the
        // bits below rp
        const int span = 4 * min(sh.rp, 8);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            float mlo = l[j][c2], mhi = l[j][2 + c2];
            if (sh.rp == 16) mlo = mhi = fmaxf(mlo, mhi);
            for (int off = 4; off < span; off <<= 1) {
              mlo = fmaxf(mlo, __shfl_xor_sync(0xffffffffu, mlo, off));
              mhi = fmaxf(mhi, __shfl_xor_sync(0xffffffffu, mhi, off));
            }
            // a point past R has only -inf rows; its output is never stored
            mlo = mlo == -INFINITY ? 0.f : mlo * kLog2e;
            mhi = mhi == -INFINITY ? 0.f : mhi * kLog2e;
            const float elo = etch_ex2(fmaf(l[j][c2], kLog2e, -mlo));
            const float ehi = etch_ex2(fmaf(l[j][2 + c2], kLog2e, -mhi));
            float dlo = elo, dhi = ehi;
            if (sh.rp == 16) dlo = dhi = dlo + dhi;
            for (int off = 4; off < span; off <<= 1) {
              dlo += __shfl_xor_sync(0xffffffffu, dlo, off);
              dhi += __shfl_xor_sync(0xffffffffu, dhi, off);
            }
            l[j][c2] = elo * rcp(dlo);
            l[j][2 + c2] = ehi * rcp(dhi);
          }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(st + rw[h] * kLdS + 8 * j + t2) =
              make_float2(l[j][2 * h], l[j][2 * h + 1]);
    }
    __syncwarp();

    if (sh.rp > 16) {   // one point over several tiles: the softmax per column in shared memory
      for (int col = lane; col < kCp; col += 32) {
        float m = -INFINITY, den = 0.f;
        for (int j = 0; j < sh.ns; ++j) m = fmaxf(m, st[j * kLdS + col]);
        const float ml = m == -INFINITY ? 0.f : m * kLog2e;
        for (int j = 0; j < sh.ns; ++j) {
          const float e = etch_ex2(fmaf(st[j * kLdS + col], kLog2e, -ml));
          st[j * kLdS + col] = e;
          den += e;
        }
        const float inv = rcp(den);
        for (int j = 0; j < sh.ns; ++j) st[j * kLdS + col] *= inv;
      }
      __syncwarp();
    }

    // out[p, ch] = sum_j (v_j + pe_j)[ch] s_j[ch % cs]: items (point, 8-channel
    // chunk) over the span's lanes, neighbours j = jp, jp + js, ... over the
    // rest, reduced by xor-shuffles
    const int items = ppu * nq, js = 32 / sh.span, jp = lane / sh.span;
    for (int base = 0; base < items; base += sh.span) {
      const int it = base + lane % sh.span;
      const int p = it / nq, q = it % nq;
      const bool act = it < items && p0 + p < sh.R;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = 0.f;
      if (act) {
        const int ch = cb + 8 * q;
        for (int j = jp; j < sh.ns; j += js) {
          const int rr = p * sh.rp + j;
          float vf[8], pf[8], sf[8];
          unpack8(ldg16(xv + static_cast<size_t>(sidx[rr]) * sh.c + ch), vf);
          unpack8(*reinterpret_cast<const uint4*>(pes + rr * sh.ldp + 8 * q), pf);
          const float* sr = st + rr * kLdS;
          if (sh.cs % 8 == 0) {
            const float4* s4 = reinterpret_cast<const float4*>(sr + ch % sh.cs);
            const float4 s0 = s4[0], s1 = s4[1];
            sf[0] = s0.x, sf[1] = s0.y, sf[2] = s0.z, sf[3] = s0.w;
            sf[4] = s1.x, sf[5] = s1.y, sf[6] = s1.z, sf[7] = s1.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) sf[e] = sr[(ch + e) % sh.cs];
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = fmaf(vf[e] + pf[e], sf[e], o[e]);
        }
      }
      for (int off = sh.span; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] += __shfl_xor_sync(0xffffffffu, o[e], off);
      if (act && jp == 0) {
        float4* op = reinterpret_cast<float4*>(out + static_cast<size_t>(p0 + p) * sh.c + cb + 8 * q);
        op[0] = make_float4(o[0], o[1], o[2], o[3]);
        op[1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncwarp();   // the unit's tiles are read before the next unit's copies
  }
}

template <int NT>
int launch_va(const bf16* xq, const bf16* xk, const bf16* xv, const int32_t* idx, const bf16* pe,
              const float* a0, const float* w0, const float* a1, const float* w1,
              const float* b1, float* out, const VaShape& sh, cudaStream_t stream) {
  using S = Smem<NT>;
  const size_t smem = S::shared_bytes(sh) + kWarps * S::warp_bytes(sh);
  cudaError_t err = etch_allow_smem(vector_attention_kernel<NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vector_attention_kernel<NT>,
                                                           kWarps * 32, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ppu = sh.rows / sh.rp, gpb = kWarps / sh.ks;
  const long long need = ((sh.R + ppu - 1) / ppu + gpb - 1) / gpb;
  const int blocks = static_cast<int>(need < static_cast<long long>(per_sm) * sms ? need : per_sm * sms);
  if (blocks == 0) return 0;
  vector_attention_kernel<NT><<<blocks, kWarps * 32, smem, stream>>>(
      xq, xk, xv, idx, pe, a0, w0, a1, w1, b1, out, sh);
  return static_cast<int>(cudaGetLastError());
}

// The wide rows' per-warp shared memory: the unit's indices, the (16, cs)
// z tile (bf16, k16 steps of cs, rows padded by 8) and the (rows, cs) s tile
// (f32).
__host__ __device__ inline int wide_ldz(int nta) { return 16 * ((nta + 1) / 2) + 8; }
__host__ __device__ inline int wide_lds(int nta) { return (8 * nta + 31) / 32 * 32 + 8; }
__host__ __device__ inline size_t wide_warp_bytes(const VaShape& sh, int nta) {
  return static_cast<size_t>(sh.rows) * 4 + 16 * wide_ldz(nta) * 2 +
         static_cast<size_t>(sh.rows) * wide_lds(nta) * 4;
}

// grid: persistent blocks; block of up to kWarps warps (as many as fit shared
// memory), one unit a warp.  nta: n8 tiles
// of cs; w0f (cpad / 16, nta, 32) and w1f (ceil(nta / 2), nta, 32) uint2:
// W0's and W1's B fragments, bf16, zero-padded.
__global__ void __launch_bounds__(kWarps * 32)
vector_attention_wide_kernel(const bf16* __restrict__ xq, const bf16* __restrict__ xk,
                             const bf16* __restrict__ xv, const int32_t* __restrict__ idx,
                             const bf16* __restrict__ pe, const float* __restrict__ a0,
                             const uint2* __restrict__ w0f, const float* __restrict__ a1,
                             const uint2* __restrict__ w1f, const float* __restrict__ b1,
                             float* __restrict__ out, VaShape sh, int nta) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kNb = 8;   // n8 tiles a column block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int ldz = wide_ldz(nta), lds = wide_lds(nta), k1 = (nta + 1) / 2;
  unsigned char* wb = smem_raw + warp * wide_warp_bytes(sh, nta);
  int* sidx = reinterpret_cast<int*>(wb);                          // rows
  bf16* zt = reinterpret_cast<bf16*>(sidx + sh.rows);              // 16 x ldz
  float* st = reinterpret_cast<float*>(zt + 16 * ldz);             // rows x lds
  // z's columns past 8 nta, to the last k16 step, are read and must be 0
  for (int e = lane; e < 16 * ldz / 2; e += 32) reinterpret_cast<uint32_t*>(zt)[e] = 0u;
  const int ppu = sh.rows / sh.rp;
  const int units = (sh.R + ppu - 1) / ppu;
  const int g = lane >> 2, t = lane & 3, t2 = 2 * t;
  const int nq = sh.c / 8;
  const auto col_val = [&](const float* v, int col) { return col < sh.cs ? __ldg(v + col) : 0.f; };

  for (int u = blockIdx.x * warps + warp; u < units; u += gridDim.x * warps) {
    const int p0 = u * ppu;
    for (int rr = lane; rr < sh.rows; rr += 32) {
      const int p = p0 + rr / sh.rp, j = rr % sh.rp;
      sidx[rr] = j < sh.ns && p < sh.R ? (p / sh.N) * sh.N + idx[static_cast<size_t>(p) * sh.ns + j]
                                       : -1;
    }
    __syncwarp();
    for (int r16 = 0; r16 < sh.rows; r16 += 16) {
      const int rw[2] = {r16 + g, r16 + g + 8};   // this lane's rows
      const bf16* kr[2];
      const bf16* qr[2];
      const bf16* pr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = sidx[rw[h]], p = min(p0 + rw[h] / sh.rp, sh.R - 1);
        const int j = min(rw[h] % sh.rp, sh.ns - 1);
        kr[h] = xk + static_cast<size_t>(m < 0 ? 0 : m) * sh.c;
        qr[h] = xq + static_cast<size_t>(p) * sh.c;
        pr[h] = pe + (static_cast<size_t>(p) * sh.ns + j) * sh.c;
      }
      // z = bf16(relu((w W0) a1)) a block of 64 columns at a time, into zt
      for (int jb = 0; jb < nta; jb += kNb) {
        float acc[kNb][4];
#pragma unroll
        for (int j = 0; j < kNb; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        for (int c32 = 0; c32 < sh.c; c32 += 32) {
          const int ch = c32 + 8 * t;   // this lane's 8 channels of the chunk
          uint32_t a[2][4];
          if (ch < sh.c) {
            uint4 raw[2][3];   // k, q and pe of rows g and g + 8
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              raw[h][0] = ldg16(kr[h] + ch);
              raw[h][1] = ldg16(qr[h] + ch);
              raw[h][2] = ldg16(pr[h] + ch);
            }
#pragma unroll
            for (int s = 0; s < 2; ++s) {   // channels ch + 4s .. ch + 4s + 3
              const float4 sc = __ldg(reinterpret_cast<const float4*>(a0 + ch + 4 * s));
              const float4 bi = __ldg(reinterpret_cast<const float4*>(a0 + sh.c + ch + 4 * s));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t* kw = reinterpret_cast<const uint32_t*>(&raw[h][0]) + 2 * s;
                const uint32_t* qw = reinterpret_cast<const uint32_t*>(&raw[h][1]) + 2 * s;
                const uint32_t* pw = reinterpret_cast<const uint32_t*>(&raw[h][2]) + 2 * s;
                const float2 k0 = etch_unpack_bf16(kw[0]), k1v = etch_unpack_bf16(kw[1]);
                const float2 q0 = etch_unpack_bf16(qw[0]), q1 = etch_unpack_bf16(qw[1]);
                const float2 pv0 = etch_unpack_bf16(pw[0]), pv1 = etch_unpack_bf16(pw[1]);
                a[s][h] = etch_pack_bf16(fmaxf(((k0.x - q0.x) + pv0.x) * sc.x + bi.x, 0.f),
                                         fmaxf(((k0.y - q0.y) + pv0.y) * sc.y + bi.y, 0.f));
                a[s][2 + h] = etch_pack_bf16(fmaxf(((k1v.x - q1.x) + pv1.x) * sc.z + bi.z, 0.f),
                                             fmaxf(((k1v.y - q1.y) + pv1.y) * sc.w + bi.w, 0.f));
              }
            }
          } else {
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int e = 0; e < 4; ++e) a[s][e] = 0u;
          }
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const uint2* bs = w0f + (static_cast<size_t>(c32 / 16 + s) * nta + jb) * 32 + lane;
#pragma unroll
            for (int j = 0; j < kNb; ++j)
              if (jb + j < nta) {
                const uint2 bv = __ldg(bs + j * 32);
                etch_mma_16816(acc[j], a[s], bv.x, bv.y);
              }
          }
        }
#pragma unroll
        for (int j = 0; j < kNb; ++j) {
          const int col = 8 * (jb + j) + t2;
          if (jb + j < nta) {
            const float s0 = col_val(a1, col), s1 = col_val(a1, col + 1);
            const float c0 = col_val(a1 + sh.cs, col), c1 = col_val(a1 + sh.cs, col + 1);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(zt + (g + 8 * h) * ldz + col) =
                  etch_pack_bf16(fmaxf(acc[j][2 * h] * s0 + c0, 0.f),
                                 fmaxf(acc[j][2 * h + 1] * s1 + c1, 0.f));
          }
        }
      }
      __syncwarp();
      const bool ok[2] = {sidx[rw[0]] >= 0, sidx[rw[1]] >= 0};
      // l = z W1 + b1 a block of 64 columns at a time, then its softmax
      for (int jl = 0; jl < nta; jl += kNb) {
        float l[kNb][4];
#pragma unroll
        for (int j = 0; j < kNb; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[j][e] = 0.f;
        for (int kk = 0; kk < k1; ++kk) {
          uint32_t za[4];
          etch_ldsm_x4(za, zt + (lane & 15) * ldz + 16 * kk + (lane >> 4) * 8);
          const uint2* bs = w1f + (static_cast<size_t>(kk) * nta + jl) * 32 + lane;
#pragma unroll
          for (int j = 0; j < kNb; ++j)
            if (jl + j < nta) {
              const uint2 bv = __ldg(bs + j * 32);
              etch_mma_16816(l[j], za, bv.x, bv.y);
            }
        }
#pragma unroll
        for (int j = 0; j < kNb; ++j) {
          const int col = 8 * (jl + j) + t2;
          const float bx = col_val(b1, col), by = col_val(b1, col + 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) l[j][e] = ok[e >> 1] ? l[j][e] + ((e & 1) ? by : bx) : -INFINITY;
        }
        if (sh.rp <= 16) {
          // softmax over the point's rows, as vector_attention_kernel
          const int span = 4 * min(sh.rp, 8);
#pragma unroll
          for (int j = 0; j < kNb; ++j)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              float mlo = l[j][c2], mhi = l[j][2 + c2];
              if (sh.rp == 16) mlo = mhi = fmaxf(mlo, mhi);
              for (int off = 4; off < span; off <<= 1) {
                mlo = fmaxf(mlo, __shfl_xor_sync(0xffffffffu, mlo, off));
                mhi = fmaxf(mhi, __shfl_xor_sync(0xffffffffu, mhi, off));
              }
              mlo = mlo == -INFINITY ? 0.f : mlo * kLog2e;
              mhi = mhi == -INFINITY ? 0.f : mhi * kLog2e;
              const float elo = etch_ex2(fmaf(l[j][c2], kLog2e, -mlo));
              const float ehi = etch_ex2(fmaf(l[j][2 + c2], kLog2e, -mhi));
              float dlo = elo, dhi = ehi;
              if (sh.rp == 16) dlo = dhi = dlo + dhi;
              for (int off = 4; off < span; off <<= 1) {
                dlo += __shfl_xor_sync(0xffffffffu, dlo, off);
                dhi += __shfl_xor_sync(0xffffffffu, dhi, off);
              }
              l[j][c2] = elo * rcp(dlo);
              l[j][2 + c2] = ehi * rcp(dhi);
            }
        }
#pragma unroll
        for (int j = 0; j < kNb; ++j)
          if (jl + j < nta)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(st + rw[h] * lds + 8 * (jl + j) + t2) =
                  make_float2(l[j][2 * h], l[j][2 * h + 1]);
      }
      __syncwarp();   // z read before the next tile's z is written
    }

    if (sh.rp > 16) {   // one point over several tiles: the softmax per column in shared memory
      for (int col = lane; col < 8 * nta; col += 32) {
        float m = -INFINITY, den = 0.f;
        for (int j = 0; j < sh.ns; ++j) m = fmaxf(m, st[j * lds + col]);
        const float ml = m == -INFINITY ? 0.f : m * kLog2e;
        for (int j = 0; j < sh.ns; ++j) {
          const float e = etch_ex2(fmaf(st[j * lds + col], kLog2e, -ml));
          st[j * lds + col] = e;
          den += e;
        }
        const float inv = rcp(den);
        for (int j = 0; j < sh.ns; ++j) st[j * lds + col] *= inv;
      }
      __syncwarp();
    }

    // out[p, ch] = sum_j (v_j + pe_j)[ch] s_j[ch % cs]: items (point, 8-channel
    // chunk) over the lanes, as vector_attention_kernel
    const int items = ppu * nq;
    for (int base = 0; base < items; base += 32) {
      const int it = base + lane;
      const int p = it / nq, q = it % nq;
      if (it < items && p0 + p < sh.R) {
        const int ch = 8 * q;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = 0.f;
        for (int j = 0; j < sh.ns; ++j) {
          const int rr = p * sh.rp + j;
          float vf[8], pf[8], sf[8];
          unpack8(ldg16(xv + static_cast<size_t>(sidx[rr]) * sh.c + ch), vf);
          unpack8(ldg16(pe + (static_cast<size_t>(p0 + p) * sh.ns + j) * sh.c + ch), pf);
          const float* sr = st + rr * lds;
#pragma unroll
          for (int e = 0; e < 8; ++e) sf[e] = sr[(ch + e) % sh.cs];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = fmaf(vf[e] + pf[e], sf[e], o[e]);
        }
        float4* op = reinterpret_cast<float4*>(out + static_cast<size_t>(p0 + p) * sh.c + ch);
        op[0] = make_float4(o[0], o[1], o[2], o[3]);
        op[1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncwarp();   // the unit's tiles are read before the next unit's
  }
}

int launch_va_wide(const bf16* xq, const bf16* xk, const bf16* xv, const int32_t* idx,
                   const bf16* pe, const float* a0, const uint2* w0f, const float* a1,
                   const uint2* w1f, const float* b1, float* out, const VaShape& sh,
                   cudaStream_t stream) {
  const int nta = (sh.cs + 7) / 8;
  const size_t per_warp = wide_warp_bytes(sh, nta);
  constexpr size_t kMaxSmem = 227 * 1024;
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(kMaxSmem / per_warp < kWarps ? kMaxSmem / per_warp : kWarps);
  const size_t smem = warps * per_warp;
  cudaError_t err = etch_allow_smem(vector_attention_wide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vector_attention_wide_kernel,
                                                           warps * 32, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ppu = sh.rows / sh.rp;
  const long long need = ((sh.R + ppu - 1) / ppu + warps - 1) / warps;
  const int blocks = static_cast<int>(need < static_cast<long long>(per_sm) * sms ? need : per_sm * sms);
  if (blocks == 0) return 0;
  vector_attention_wide_kernel<<<blocks, warps * 32, smem, stream>>>(
      xq, xk, xv, idx, pe, a0, w0f, a1, w1f, b1, out, sh, nta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq (R, c), xk / xv (B, N, c), pe (R, ns, c): bf16, 16-byte aligned;
// idx (R, ns) int32 within each cloud; a0 (2, c), a1 (2, cs), b1 (cs), out
// (R, c), W0 (c, cs) and W1 (cs, cs): f32, W0 and W1 16-byte aligned.
// R = B * N; c a multiple of 8 up to 512, cs = c / 8.
ETCH_API int etch_vector_attention(const void* xq, const void* xk, const void* xv,
                                   const int32_t* idx, const void* pe, const float* a0,
                                   const float* w0, const float* a1, const float* w1,
                                   const float* b1, float* out, int R, int N, int ns, int c,
                                   int cs, cudaStream_t stream) {
  if (c % 8 != 0 || c < 8 || c > 512 || cs < 1 || cs > 64 || ns < 1 || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  VaShape sh;
  sh.R = R, sh.N = N, sh.ns = ns, sh.c = c, sh.cs = cs;
  sh.rp = 1;
  while (sh.rp < ns && sh.rp < 16) sh.rp *= 2;
  if (ns > 16) sh.rp = (ns + 15) / 16 * 16;
  sh.rows = sh.rp > 16 ? sh.rp : 16;
  sh.ks = c >= 256 && c % 128 == 0 ? 4 : c >= 256 && c % 64 == 0 ? 2 : 1;
  sh.cw = c / sh.ks;
  const int cwp = (sh.cw + 31) / 32 * 32;
  sh.ldp = cwp % 64 == 0 ? cwp + 32 : cwp;
  sh.cpad = (c + 31) / 32 * 32;
  const int items = sh.rows / sh.rp * (sh.cw / 8);
  int ip = 1;
  while (ip < items) ip *= 2;
  sh.span = ip < 32 ? ip : 32;
  const bf16* q = static_cast<const bf16*>(xq);
  const bf16* k = static_cast<const bf16*>(xk);
  const bf16* v = static_cast<const bf16*>(xv);
  const bf16* p = static_cast<const bf16*>(pe);
  switch ((cs + 7) / 8) {
#define ETCH_CASE(nt) \
  case nt: return launch_va<nt>(q, k, v, idx, p, a0, w0, a1, w1, b1, out, sh, stream);
    ETCH_CASE(1) ETCH_CASE(2) ETCH_CASE(3) ETCH_CASE(4)
    ETCH_CASE(5) ETCH_CASE(6) ETCH_CASE(7) ETCH_CASE(8)
#undef ETCH_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same function at cs above 64 (vector_attention_wide_kernel): w0f and
// w1f are W0's and W1's B fragments, bf16, packed by the wrapper
// (nn/vector_attention.py:pack_fragments), 16-byte aligned; c a multiple of 8.
ETCH_API int etch_vector_attention_wide(const void* xq, const void* xk, const void* xv,
                                        const int32_t* idx, const void* pe, const float* a0,
                                        const void* w0f, const float* a1, const void* w1f,
                                        const float* b1, float* out, int R, int N, int ns,
                                        int c, int cs, cudaStream_t stream) {
  if (c % 8 != 0 || c < 8 || cs < 1 || ns < 1 || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  VaShape sh{};
  sh.R = R, sh.N = N, sh.ns = ns, sh.c = c, sh.cs = cs;
  sh.rp = 1;
  while (sh.rp < ns && sh.rp < 16) sh.rp *= 2;
  if (ns > 16) sh.rp = (ns + 15) / 16 * 16;
  sh.rows = sh.rp > 16 ? sh.rp : 16;
  sh.ks = 1, sh.cw = c;
  return launch_va_wide(static_cast<const bf16*>(xq), static_cast<const bf16*>(xk),
                        static_cast<const bf16*>(xv), idx, static_cast<const bf16*>(pe), a0,
                        static_cast<const uint2*>(w0f), a1, static_cast<const uint2*>(w1f), b1,
                        out, sh, stream);
}
