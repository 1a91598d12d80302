// Direction-head core at embed widths above 64 (E and V up to 512; head
// sizes 1, 2, 4, 8 and multiples of 16 up to 256, any other head size
// zero-padded to one of these by the wrapper): the fused core of
// csrc/dircore.cu for the 128- and 256-channel EPN blocks of epn_layer_num 3
// and 4, wider last blocks, and head counts that leave wide heads.
//
// Replaces etch_tpu/nn/pallas_dircore.py:direction_core_pallas (_kernel) at
// those widths; it computes what dircore.cu computes, with the same rounding
// points (see there).  The last two steps, y = h2 Wm1 + bm1 and out = y wr,
// are folded into out = h2 u + bm1 wr with u = bf16(Wm1) wr (f32, formed by
// the wrapper): the same sums in another order, and no h2 to keep.
//
// Why a second kernel: the packed weights of two layers, 8 E^2 + 2 V^2 bf16
// values, take about 330 KB at E = 128, 1.1 MB at E = 256 and 4.7 MB at
// E = V = 512 (151,552 B at E = 64), so they cannot stay in shared memory.
// Design:
//   - Persistent blocks of G groups (G = 3 at E = 128, 2 at E = 256, 1 at
//     E = 512: what shared memory and the registers hold), 4 warps a group,
//     a warp owns 16 of a point's 64 padded token rows; a group walks over
//     points.
//   - The B fragments come from device memory, where the L2 holds them: the
//     wrapper packs each matrix in fragment order (nn/dircore.py:
//     pack_weights_wide), so a lane's two n8 tiles of a k16 step are one
//     16-byte load and a warp's loads are one contiguous 512-byte line.
//   - The token rows stay in registers as A fragments (x); q, the attention
//     output o (which overwrites q head by head, once the head's q is read)
//     and the hidden layer h1 pass through shared memory and come back as A
//     fragments by ldmatrix, which keeps the registers to x and one
//     accumulator pair at E = 256.  At E = 512, x alone is 128 registers a
//     thread and part of it spills to local memory (the L1 and L2): there
//     is no room left in shared memory, which k, v and q fill.  k and v are
//     shared by the group, as in dircore.cu; h1 takes their place once the
//     group's attention is done, which needs Vp <= max(Ep, 256): the
//     wrapper widens Ep to 512 for V above 256.
//   - q, k, v and o are in the head layout: Eh = H hp columns, head h at
//     columns h hp .. h hp + hp - 1 (the wrapper pads each head with zero
//     columns to hp, and Ep >= max(E, Eh)); columns from Eh on are zero.
//     The attention runs over every whole head of hp columns in Ep: a head
//     of zero columns gives o = 0, which meets zero rows of wc (exact).
//   - Instances by head size HS: 1, 2, 4, 8 (8-column tiles); 16 (powers of
//     two 16-128, up to 8 k16 steps); 256 (16 steps); 48, any other
//     multiple of 16 (16 steps where E >= 256), whose heads need not tile
//     Ep.  A power of two tiles Ep, so its head loop runs to the
//     compile-time Ep: the general bound costs the E = 128 instance 72
//     bytes more of spills and about 5% of its time on an H100.
//   - Attention: common.cuh's per-head attention, m16n8k8 tiles for head
//     sizes up to 8, k16 steps above (up to 16 of them: head size 256).
// Bound on the H100: the tensor cores and the L2.  At E = 256 a point's
// warps read its 1.3 MB of weights from the L2 each, which is what this
// kernel's time follows; it takes the repaired widths, not the main path.
#include "common.cuh"

namespace {

constexpr int kRows = 64;   // token rows, padded

struct WideDims {
  int M, A, Ep, Vp;
  int ldE;    // k, v row stride (bf16): Ep + 8
  int ldA;    // q / o row stride (bf16): Ep + 8
  int ldH;    // h1 row stride (bf16): Vp + 8
  float scale;
  int nk16;   // k16 steps a head (head sizes >= 16)
};

__host__ __device__ constexpr int wide_groups(int KE) { return KE > 16 ? 1 : KE > 8 ? 2 : 3; }

typedef uint32_t Frag[4];

// acc[j] = a (16 rows, nk <= NK k16 steps, as A fragments from `fa(kt,
// a)`) times W's columns 16 n16 + 8j .. + 7, W packed in fragment order with
// n16s 16-column tiles a k16 step.
template <int NK, typename FA>
__device__ __forceinline__ void mma_wide(float (&acc)[2][4], FA fa, int nk,
                                         const uint4* __restrict__ w, int n16s, int n16) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NK; ++kt) {
    if (kt < nk) {
      const uint4 b = __ldg(w + (kt * n16s + n16) * 32 + lane);
      uint32_t a[4];
      fa(kt, a);
      etch_mma_16816(acc[0], a, b.x, b.y);
      etch_mma_16816(acc[1], a, b.z, b.w);
    }
  }
}

// A fragment of rows r0 .. r0 + 15, columns 16 kt .. + 15 of a bf16 matrix
// in shared memory (row stride ld).
__device__ __forceinline__ void lds_a(uint32_t (&a)[4], const bf16* m, int ld, int r0, int kt) {
  const int lane = threadIdx.x & 31;
  etch_ldsm_x4(a, m + (r0 + (lane & 15)) * ld + 16 * kt + (lane >> 4) * 8);
}

// Store an accumulator pair (16 columns at c0) of rows r0 + g, r0 + g + 8 as
// bf16 pairs f(j, h, col) into a shared matrix.
template <typename Fn>
__device__ __forceinline__ void sts_pairs(bf16* m, int ld, int r0, int c0, Fn f) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(m + (r0 + g + 8 * h) * ld + c0 + 8 * j + t2) = f(j, h, 8 * j + t2);
}

// grid: persistent blocks; block 128 G.  tokens (M, A, Ep) bf16; w: the nine
// matrices wq0, wk0, wv0, wc0, wq1, wk1, wv1 (Ep x Ep), wc1 (Ep x Vp) and wm0
// (Vp x Vp) in fragment order; f: bc0 (Ep), bc1, bm0, u (Vp), bm1 . wr (4).
template <int KE, int HS>
__global__ void __launch_bounds__(128 * wide_groups(KE), 1)
dircore_wide_kernel(const bf16* __restrict__ tokens, const uint4* __restrict__ w,
                    const float* __restrict__ f, float* __restrict__ out, WideDims d) {
  constexpr int Ep = 16 * KE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nf = Ep + 3 * d.Vp + 4;
  float* fs = reinterpret_cast<float*>(smem_raw);
  const int group = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int G = blockDim.x >> 7;
  bf16* gbase = reinterpret_cast<bf16*>(fs + nf) + group * kRows * (2 * d.ldE + d.ldA);
  bf16* ks = gbase;
  bf16* vs = ks + kRows * d.ldE;
  bf16* act = vs + kRows * d.ldE;   // q, then o, of the warp's own rows
  bf16* hs1 = ks;                   // h1 (64 x ldH) in k and v's place
  const int r0 = 16 * warp, g = lane >> 2, t2 = 2 * (lane & 3);
  const int mat = Ep * Ep / 8;      // uint4 pieces of an Ep x Ep matrix
  const uint4* wc1 = w + 7 * mat;
  const uint4* wm0 = wc1 + Ep * d.Vp / 8;
  const float *bc0 = fs, *bc1 = fs + Ep, *bm0 = bc1 + d.Vp, *u = bm0 + d.Vp;

  for (int e = threadIdx.x; e < nf; e += blockDim.x) fs[e] = f[e];
  __syncthreads();

  for (int point = blockIdx.x * G + group; point < d.M; point += gridDim.x * G) {
    const bf16* tok = tokens + static_cast<size_t>(point) * d.A * Ep;
    Frag x[KE];
#pragma unroll
    for (int t = 0; t < KE; ++t)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + g + 8 * h;
          x[t][2 * s + h] =
              row < d.A ? __ldg(reinterpret_cast<const unsigned*>(tok + row * Ep + 16 * t + 8 * s + t2))
                        : 0u;
        }
    const auto xa = [&](int kt, uint32_t (&a)[4]) {   // kt is a constant once unrolled
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = x[kt][e];
    };
    const auto oa = [&](int kt, uint32_t (&a)[4]) { lds_a(a, act, d.ldA, r0, kt); };

    for (int l = 0; l < 2; ++l) {
      const uint4* wl = w + 4 * l * mat;
      float acc[2][4];
      // q = bf16(x Wq * scale) into the warp's rows of act
#pragma unroll 1
      for (int n = 0; n < KE; ++n) {
        mma_wide<KE>(acc, xa, KE, wl, KE, n);
        sts_pairs(act, d.ldA, r0, 16 * n, [&](int j, int h, int) {
          return etch_pack_bf16(acc[j][2 * h] * d.scale, acc[j][2 * h + 1] * d.scale);
        });
      }
      etch_group_sync(group);   // the group is done with the previous k, v (or h1)
#pragma unroll 1
      for (int m = 0; m < 2; ++m)
#pragma unroll 1
        for (int n = 0; n < KE; ++n) {
          mma_wide<KE>(acc, xa, KE, wl + (1 + m) * mat, KE, n);
          sts_pairs(m ? vs : ks, d.ldE, r0, 16 * n, [&](int j, int h, int) {
            return etch_pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
          });
        }
      etch_group_sync(group);   // k and v of all 64 rows are in place
      __syncwarp();             // and this warp's q rows

      // attention, head by head: o overwrites the head's q columns
      if constexpr (HS <= 8) {
#pragma unroll 1
        for (int nt = 0; nt < Ep / 8; ++nt) {
          float ot[4];
          etch_attention_tile8<HS>(
              [&](uint32_t& a0, uint32_t& a1) {
                a0 = *reinterpret_cast<const uint32_t*>(act + (r0 + g) * d.ldA + 8 * nt + t2);
                a1 = *reinterpret_cast<const uint32_t*>(act + (r0 + g + 8) * d.ldA + 8 * nt + t2);
              },
              ks + 8 * nt, vs + 8 * nt, d.ldE, d.A, ot);
          __syncwarp();
          *reinterpret_cast<uint32_t*>(act + (r0 + g) * d.ldA + 8 * nt + t2) =
              etch_pack_bf16(ot[0], ot[1]);
          *reinterpret_cast<uint32_t*>(act + (r0 + g + 8) * d.ldA + 8 * nt + t2) =
              etch_pack_bf16(ot[2], ot[3]);
        }
      } else {
        const int hsz = 16 * d.nk16;
#pragma unroll 1
        for (int hc = 0; (HS & (HS - 1)) ? hc + hsz <= Ep : hc < Ep; hc += hsz) {
          etch_attention_head16<HS == 256 || (HS == 48 && KE >= 16) ? 16 : 8>(
              [&](int kt, uint32_t (&a)[4]) { lds_a(a, act + hc, d.ldA, r0, kt); },
              ks + hc, vs + hc, d.ldE, d.A, d.nk16,
              [&](int j, const float (&o0)[4], const float (&o1)[4]) {
                __syncwarp();   // every lane has read the head's q
                sts_pairs(act, d.ldA, r0, hc + 16 * j, [&](int jj, int h, int) {
                  const float* o = jj ? o1 : o0;
                  return etch_pack_bf16(o[2 * h], o[2 * h + 1]);
                });
              });
        }
      }
      __syncwarp();   // o is in place

      if (l == 0) {   // x = bf16(x + (o Wc0 + bc0))
#pragma unroll
        for (int n = 0; n < KE; ++n) {
          mma_wide<KE>(acc, oa, KE, wl + 3 * mat, KE, n);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = 16 * n + 8 * j + t2;
              const float2 xv = etch_unpack_bf16(x[n][2 * j + h]);
              x[n][2 * j + h] = etch_pack_bf16(xv.x + (acc[j][2 * h] + bc0[col]),
                                               xv.y + (acc[j][2 * h + 1] + bc0[col + 1]));
            }
        }
      }
    }

    // h1 = bf16(o Wc1 + bc1) into k and v's place, once the group is done
    // with them
    etch_group_sync(group);
    float acc[2][4];
#pragma unroll 1
    for (int n = 0; n < d.Vp / 16; ++n) {
      mma_wide<KE>(acc, oa, KE, wc1, d.Vp / 16, n);
      sts_pairs(hs1, d.ldH, r0, 16 * n, [&](int j, int h, int col) {
        return etch_pack_bf16(acc[j][2 * h] + bc1[16 * n + col],
                              acc[j][2 * h + 1] + bc1[16 * n + col + 1]);
      });
    }
    __syncwarp();
    // out = bf16(relu(h1 Wm0 + bm0)) . u + bm1 . wr
    float part[2] = {0.f, 0.f};   // rows g, g + 8
    const auto ha = [&](int kt, uint32_t (&a)[4]) { lds_a(a, hs1, d.ldH, r0, kt); };
#pragma unroll 1
    for (int n = 0; n < d.Vp / 16; ++n) {
      mma_wide<(KE > 16 ? 32 : 16)>(acc, ha, d.Vp / 16, wm0, d.Vp / 16, n);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * n + 8 * j + t2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 hv = etch_unpack_bf16(etch_pack_bf16(fmaxf(acc[j][2 * h] + bm0[col], 0.f),
                                                            fmaxf(acc[j][2 * h + 1] + bm0[col + 1], 0.f)));
          part[h] = fmaf(hv.y, u[col + 1], fmaf(hv.x, u[col], part[h]));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      const int row = r0 + g + 8 * h;
      if ((lane & 3) == 0 && row < d.A) out[static_cast<size_t>(point) * d.A + row] = part[h] + u[d.Vp];
    }
  }
}

template <int KE, int HS>
int launch(const bf16* tokens, const uint4* w, const float* f, float* out, WideDims d,
           cudaStream_t stream) {
  const size_t fbytes = static_cast<size_t>(16 * KE + 3 * d.Vp + 4) * sizeof(float);
  const size_t gbytes = static_cast<size_t>(kRows) * (2 * d.ldE + d.ldA) * sizeof(bf16);
  // groups a block: what shared memory holds, at most the launch bound's
  const int most = wide_groups(KE);
  int G = static_cast<int>((232448 - fbytes) / gbytes);
  G = G > most ? most : G;
  const size_t smem = fbytes + G * gbytes;
  cudaError_t err = etch_allow_smem(dircore_wide_kernel<KE, HS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int need = (d.M + G - 1) / G, blocks = need < sms ? need : sms;
  if (blocks == 0) return 0;
  dircore_wide_kernel<KE, HS><<<blocks, 128 * G, smem, stream>>>(tokens, w, f, out, d);
  return static_cast<int>(cudaGetLastError());
}

template <int KE>
int launch_hs(const bf16* tokens, const uint4* w, const float* f, float* out, WideDims d, int hs,
              cudaStream_t stream) {
  switch (hs) {
    case 1: return launch<KE, 1>(tokens, w, f, out, d, stream);
    case 2: return launch<KE, 2>(tokens, w, f, out, d, stream);
    case 4: return launch<KE, 4>(tokens, w, f, out, d, stream);
    case 8: return launch<KE, 8>(tokens, w, f, out, d, stream);
    default:   // multiples of 16
      if (hs & (hs - 1)) return launch<KE, 48>(tokens, w, f, out, d, stream);
      if constexpr (KE >= 16)
        if (hs == 256) return launch<KE, 256>(tokens, w, f, out, d, stream);
      return launch<KE, 16>(tokens, w, f, out, d, stream);
  }
}

}  // namespace

// tokens (M, A, Ep) bf16, Ep = 128, 256 or 512; w: the packed fragments
// (nn/dircore.py:pack_weights_wide); f: bc0, bc1, bm0, u and bm1 . wr (f32,
// Ep + 3 Vp + 4 values), Vp = 128, 256 or 512 and at most max(Ep, 256);
// out (M, A) f32.  A <= 64; q, k, v in the head layout of H heads of hs
// columns (1, 2, 4, 8 or a multiple of 16 up to 256), H hs <= Ep.
ETCH_API int etch_dircore_wide(const void* tokens, const void* w, const float* f, float* out,
                               int M, int A, int Ep, int Vp, int H, int hs, float scale,
                               cudaStream_t stream) {
  const bool tile8 = hs == 1 || hs == 2 || hs == 4 || hs == 8;
  if (A < 1 || A > kRows || (Vp != 128 && Vp != 256 && Vp != 512) || Vp > (Ep > 256 ? Ep : 256) ||
      H < 1 || hs < 1 || hs > 256 || (!tile8 && hs % 16) || H * hs > Ep)
    return static_cast<int>(cudaErrorInvalidValue);
  WideDims d;
  d.M = M, d.A = A, d.Ep = Ep, d.Vp = Vp;
  d.ldE = d.ldA = Ep + 8;
  d.ldH = Vp + 8;
  d.scale = scale;
  d.nk16 = hs >= 16 ? hs / 16 : 1;
  const bf16* t = static_cast<const bf16*>(tokens);
  const uint4* wf = static_cast<const uint4*>(w);
  if (Ep == 128) return launch_hs<8>(t, wf, f, out, d, hs, stream);
  if (Ep == 256) return launch_hs<16>(t, wf, f, out, d, hs, stream);
  if (Ep == 512) return launch_hs<32>(t, wf, f, out, d, hs, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
