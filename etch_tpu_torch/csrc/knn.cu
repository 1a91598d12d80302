// Neighbour queries: k nearest neighbours and ball query.
//
// knn_kernel replaces etch_tpu/ops/pallas_knn.py:_knn_kernel (knn_pallas);
// ball_query_kernel replaces etch_tpu/ops/pallas_knn.py:_ball_kernel
// (ball_query_pallas).  Both return squared distances by direct difference
// (common.cuh:etch_sqdist), as the TPU kernels compute them.
//
// kNN.  Bound on the H100: FP32 issue.  Every query visits every support
// (M*N pairs: 25 M a cloud at 5000 x 5000), while the bytes are only the
// coordinates and the results.  A thread per query that scans all N supports
// in turn leaves the card idle at the U-Net's small shapes (1250 queries a
// cloud: 80 blocks of 128 for 132 SMs) and is latency-bound at the large ones;
// and a sorted top-k list in registers costs some 6 KMAX instructions an
// insertion, which a warp pays whenever any of its lanes inserts.  Design:
//   - A group of G lanes (G a power of two up to 32, aligned in the warp)
//     shares one query; lane l of the group scans supports l, l + G, ...
//     The launch picks the largest G whose grid still fits the card in one
//     wave of resident blocks, so B = 1 fills the card as B = 8 does.
//   - The support cloud passes through shared memory in tiles of float4
//     (x, y, z, w), w a lower bound of |s|^2 (below), each lane's share in a
//     row of its own (consecutive loads, immediate offsets), padded with
//     w = inf to a multiple of the unrolled step.
//   - Prefilter, 3 FFMA a pair: L = w - 2 q.s.  With q.q added, L bounds
//     the direct d2 from below up to a proven rounding margin, so a pair
//     whose L is not below the lane's adjusted threshold cannot enter the
//     result (bound_adjust proves it).  The scan has no branch: a step of
//     kUnroll pairs whose prefilter passes stores one entry (its first tile
//     position and a 16-bit mask) in the lane's queue in shared memory.
//     The warp empties the queues only when one is full or holds more than
//     kQueuePairs pairs, and at the end of each tile: the exact direct
//     difference of each queued pair then decides, and an insertion round
//     serves every lane of the warp at once.
//   - Each lane keeps a sorted top-KMAX list of its share (strict-less
//     insertion in scan order: among equal distances the smaller index stays
//     in front).  Its threshold is its own kk-th entry, and tighter: the
//     largest over the group of each lane's ceil(kk / G)-th entry, since the
//     group holds at least G ceil(kk / G) >= kk pairs at or below it (a pair
//     equal to it may still belong to the result, so the bound admits it).
//   - Merge: kk rounds of a group argmin over the lanes' heads, ordered by
//     (d2, index) with __shfl_xor_sync; the winning lane pops its head.
//     That is the stable sort's order, ties to the smaller index included.
//   - k above 32 runs in passes of up to 32: a pass takes the pairs strictly
//     after the last (d2, index) the previous pass selected, and only those.
//
// Ball query.  Replaces etch_tpu/ops/pallas_knn.py:ball_query_pallas: the
// first nsample supports in index order with d2 < r2 (strict, direct
// difference), repeat-filled cyclically; an empty ball gives index 0
// (etch_tpu/ops/ball_query.py:21-35).  Bound on the H100: FP32 issue over
// the pairs the index-order scan must visit (a query stops at its nsample-th
// hit; one whose ball holds fewer scans all N), some 10 instructions a pair
// (a 16-byte shared load, the three differences, squares and sums, the
// compare).  A thread a query in 128-thread blocks left B = 8 at 2500
// queries with 5 warps an SM, a dependent loop with a branch and a scattered
// store a hit.  Design:
//   - A group of G lanes (G a power of two up to 32, aligned in the warp)
//     owns one query; the launch picks the largest G whose grid still fits
//     the card in one wave of resident blocks (half a wave above G = 8), so
//     B = 1 fills the card as B = 8 does.
//   - The supports pass through shared memory in tiles of 1024 float4 (x,
//     y, z, 0), one LDS.128 a pair; the tile's tail is padded with points at
//     infinity (d2 = inf: never a hit), so the scan has no bound test.
//     Measured on the card and not kept: tiles of 512 (more blocks an SM,
//     more barriers) and two queries a group (one load for two pairs, more
//     registers) were both slower.
//   - A chunk is 32 steps of G consecutive supports, one a lane a step:
//     each lane runs its 32 tests without a branch into a 32-bit mask (a
//     16-byte shared load, 8 FP32 operations, a compare and a bit a pair;
//     the group size is a template argument, so the loads take immediate
//     offsets).  Then the group merges in index order only the steps that
//     hold a hit: for each, __ballot_sync gives the group's hit mask, a
//     hit's slot is cnt + popc(mask & lanes below), which keeps index order
//     exactly, and cnt += popc(mask).  At some 60 hits a query in 5000
//     supports that merge is a few per cent of the scan.  A group stops
//     after the chunk in which cnt reaches nsample (slots from nsample on
//     are dropped); the warp leaves the tile when all its groups have
//     stopped, the block stops loading tiles when all its queries have.
//   - The query's row is staged in shared memory, repeat-filled (or zeroed
//     for an empty ball) there, and leaves with the block's other rows as
//     one contiguous run of coalesced stores, 16 bytes where nsample % 4 ==
//     0.  Rows too long for shared memory (more than some 13,000 samples at
//     G = 32) are written in place in device memory instead.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- kNN

constexpr int kKnnThreads = 128;
constexpr int kKnnTile = 1024;   // supports a tile
constexpr int kUnroll = 16;      // pairs a lane a step: one queue entry, a 16-bit mask
constexpr int kQueue = 16;       // queue entries a lane
constexpr int kQueuePairs = 8;   // queued pairs a lane that empty the warp's queues
// the tile in shared memory: lane-major, padded to a multiple of G kUnroll,
// one float4 between lanes' rows
constexpr int kTileSlots = kKnnTile + 32 * kUnroll + 32;
constexpr int kNoIndex = 0x7fffffff;
constexpr float kW = 1.f - 1.f / 524288.f;        // 1 - 2^-19
constexpr float kThrUp = 1.f + 1.f / 1048576.f;   // 1 + 2^-20
constexpr float kQqDown = 1.f - 1.f / 1048576.f;  // 1 - 2^-20
constexpr float kFltMin = 1.17549435e-38f;         // FLT_MIN

// The prefilter's threshold for exact threshold thr and the query's
// qq = fl(|q|^2) (fmaf chain).  Claim: for any support s, fl(d2(q, s)) < thr
// implies L(s) < bound_adjust(thr, qq), with L = fma(-2qx, sx, fma(-2qy,
// sy, fma(-2qz, sz, w))) and w = RD(fl(|s|^2) (1 - 2^-19)).  Proof (u =
// 2^-24, D = |q - s|^2 exact, coordinates finite and no overflow):
//   - fl(d2) >= D (1 - 5u): five roundings of nonnegative terms; so
//     fl(d2) < thr gives D < thr (1 + 5.1u).
//   - fl(|s|^2) <= |s|^2 (1 + 3.1u), so w <= |s|^2 (1 - 28u).
//   - The fma chain errs by at most 3.01u (|w| + 2 |q||s|)
//     <= 3.01u (2 |s|^2 + |q|^2), so L <= w - 2 q.s + that
//     <= D - |q|^2 (1 - 3.01u).
//   - qq (1 - 2^-20) <= |q|^2 (1 + 3.1u)(1 - 16u) <= |q|^2 (1 - 12u), and
//     the rounding directions below make the result at least
//     thr (1 + 16u) - |q|^2 (1 - 12u) + FLT_MIN > L.
// FLT_MIN covers what gradual underflow can take from the relative bounds
// (a few units of 2^-149).  The margin is about 2^-20 (thr + |q|^2), far
// below any spacing of neighbours, so it passes few pairs in vain.
__device__ __forceinline__ float bound_adjust(float thr, float qq) {
  if (thr == INFINITY) return INFINITY;
  return __fadd_ru(__fsub_ru(__fmul_ru(thr, kThrUp), __fmul_rd(qq, kQqDown)), kFltMin);
}

// Strict-less insertion of (d, j) into the sorted list (d, i): the entry
// goes in front of the first strictly larger one, shifting the rest down.
template <int KMAX>
__device__ __forceinline__ void knn_insert(float (&bd)[KMAX], int (&bi)[KMAX], float d, int j) {
  bool moved = false;
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    const bool take = moved || d < bd[r];
    if (take) {
      const float tv = bd[r];
      const int ti = bi[r];
      bd[r] = d;
      bi[r] = j;
      d = tv;
      j = ti;
    }
    moved = take;
  }
}

// 16-byte shared load from a shared-window address.  The scan keeps its
// row's address in a register: through C++ pointers the compiler
// recomputed the shared window's base (an S2R) at every step.
__device__ __forceinline__ float4 lds128(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Entry r (r < KMAX, a runtime value) of a register list.
template <int KMAX>
__device__ __forceinline__ float knn_entry(const float (&bd)[KMAX], int r) {
  float v = bd[0];
#pragma unroll
  for (int e = 1; e < KMAX; ++e)
    if (e == r) v = bd[e];
  return v;
}

// grid (ceil(m G / kKnnThreads), b); block kKnnThreads; G = 1 << lg.
// Lanes of a group: threads g G .. g G + G - 1 of the block (aligned in the
// warp); the group's query is (blockIdx.x kKnnThreads + threadIdx.x) >> lg.
// The scan is branch-free: a pair costs one LDS.128, 3 FFMA, a compare and a
// bit of the step's hit mask; a step of kUnroll pairs with hits stores one
// queue entry (its first tile position and the mask).  The queue holds tile
// positions, so it is emptied before the tile is replaced; emptying it takes
// the exact direct difference of each queued pair, one pair a lane a round.
template <int KMAX>
__global__ void __launch_bounds__(kKnnThreads)
knn_kernel(const float* __restrict__ q, const float* __restrict__ s, int32_t* __restrict__ out_idx,
           float* __restrict__ out_d2, int m, int n, int k, int lg) {
  __shared__ float4 tile[kTileSlots];
  __shared__ int qe[kQueue][kKnnThreads];   // (first position << 16) | hit mask
  const int G = 1 << lg, b = blockIdx.y, tid = threadIdx.x;
  const int lane_g = tid & (G - 1);
  const int qn = (blockIdx.x * kKnnThreads + tid) >> lg;
  const bool active = qn < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + (static_cast<size_t>(b) * m + qn) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float mx = -2.f * qx, my = -2.f * qy, mz = -2.f * qz;
  const float qq = fmaf(qx, qx, fmaf(qy, qy, qz * qz));
  const float* sp = s + static_cast<size_t>(b) * n * 3;
  const size_t obase = (static_cast<size_t>(b) * m + (active ? qn : 0)) * k;

  float dl = -1.f;   // the previous pass's last (d2, index): this pass takes what follows
  int il = -1;
  for (int done = 0; done < k; done += KMAX) {
    const int kk = min(KMAX, k - done);
    const int mg = (kk + G - 1) >> lg;   // the group bound's entry, 1-based
    float bd[KMAX];
    int bi[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) {
      bd[r] = INFINITY;
      bi[r] = kNoIndex;
    }
    int cnt = 0, pairs = 0;   // queue entries, and the pairs they hold
    float thr = INFINITY, thr_adj = INFINITY;

    for (int t0 = 0; t0 < n; t0 += kKnnTile) {
      const int tcnt = min(kKnnTile, n - t0);
      const int S = ((tcnt + G * kUnroll - 1) >> lg) / kUnroll * kUnroll;   // pairs a lane
      unsigned row = static_cast<unsigned>(__cvta_generic_to_shared(tile + lane_g * (S + 1)));
      asm volatile("" : "+r"(row));   // opaque: stays in a register
      __syncthreads();   // the previous tile is spent
      for (int jl = tid; jl < S << lg; jl += kKnnThreads) {
        float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);   // padding: L = inf, never queued
        if (jl < tcnt) {
          const float x = sp[3 * (t0 + jl)], y = sp[3 * (t0 + jl) + 1], z = sp[3 * (t0 + jl) + 2];
          v = make_float4(x, y, z, __fmul_rd(fmaf(x, x, fmaf(y, y, z * z)), kW));
        }
        tile[(jl & (G - 1)) * (S + 1) + (jl >> lg)] = v;
      }
      __syncthreads();

      // empty the queue into the list, one pair a lane a round, then tighten
      // the thresholds (warp-uniform)
      const auto flush = [&]() {
        int t = 0;
        unsigned e = cnt > 0 ? static_cast<unsigned>(qe[0][tid]) : 0u;
        while (__any_sync(0xffffffffu, t < cnt)) {
          if (t < cnt) {
            const int i = (e >> 16) + __ffs(e & 0xffffu) - 1;
            e &= e - 1;   // the lowest hit is taken
            if ((e & 0xffffu) == 0 && ++t < cnt) e = static_cast<unsigned>(qe[t][tid]);
            const float4 p = lds128(row + 16u * i);
            const float d = etch_sqdist(qx - p.x, qy - p.y, qz - p.z);
            const int j = t0 + (i << lg) + lane_g;
            if (d < thr && (d > dl || (d == dl && j > il))) knn_insert<KMAX>(bd, bi, d, j);
          }
        }
        cnt = pairs = 0;
        float tg = knn_entry<KMAX>(bd, mg - 1);
        for (int off = 1; off < G; off <<= 1)
          tg = fmaxf(tg, __shfl_xor_sync(0xffffffffu, tg, off));
        // the next float above tg: pairs equal to the bound stay admissible
        const float tg_up = tg == INFINITY ? INFINITY : __uint_as_float(__float_as_uint(tg) + 1u);
        thr = fminf(knn_entry<KMAX>(bd, kk - 1), tg_up);
        thr_adj = bound_adjust(thr, qq);
      };

      for (int i0 = 0; i0 < S; i0 += kUnroll) {
        unsigned mask = 0u;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 p = lds128(row + 16u * (i0 + u));
          const float L = fmaf(mx, p.x, fmaf(my, p.y, fmaf(mz, p.z, p.w)));
          mask |= static_cast<unsigned>(L < thr_adj) << u;
        }
        if (mask) {
          qe[cnt][tid] = (i0 << 16) | static_cast<int>(mask);
          ++cnt;
          pairs += __popc(mask);
        }
        // a full queue, or enough pairs queued somewhere in the warp
        if (__any_sync(0xffffffffu, cnt == kQueue || pairs > kQueuePairs)) flush();
      }
      flush();   // the queue holds this tile's positions
    }

    // merge: kk rounds of the group's lexicographic argmin over its heads
    for (int r = 0; r < kk; ++r) {
      float md = bd[0];
      int mi = bi[0];
      for (int off = 1; off < G; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, md, off);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
        if (od < md || (od == md && oi < mi)) {
          md = od;
          mi = oi;
        }
      }
      if (bi[0] == mi) {   // indices are unique across the group: the winner pops
#pragma unroll
        for (int e = 0; e + 1 < KMAX; ++e) {
          bd[e] = bd[e + 1];
          bi[e] = bi[e + 1];
        }
        bd[KMAX - 1] = INFINITY;
        bi[KMAX - 1] = kNoIndex;
      }
      if (active && lane_g == (r & (G - 1))) {
        out_idx[obase + done + r] = mi;
        out_d2[obase + done + r] = md;
      }
      dl = md;
      il = mi;
    }
  }
}

template <int KMAX>
int launch_knn(const float* q, const float* s, int32_t* idx, float* d2, int b, int m, int n,
               int k, cudaStream_t stream) {
  // the largest group whose grid fits one wave of resident blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, knn_kernel<KMAX>,
                                                           kKnnThreads, 0)) != cudaSuccess)
    return static_cast<int>(err);
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) * kKnnThreads;
  int lg = 5;
  while (lg > 0 && static_cast<long long>(b) * m << lg > resident) --lg;
  const dim3 grid(static_cast<unsigned>(((static_cast<long long>(m) << lg) + kKnnThreads - 1) /
                                        kKnnThreads),
                  b);
  knn_kernel<KMAX><<<grid, kKnnThreads, 0, stream>>>(q, s, idx, d2, m, n, k, lg);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- ball query

constexpr int kBqThreads = 128;
constexpr int kBqTile = 1024;    // supports a tile: a whole number of chunks at any G
constexpr size_t kBqRowBytes = 200 * 1024;     // staged rows' shared memory at most

// grid (ceil(m G / kBqThreads), b); block kBqThreads; G = 1 << LG.  The
// group's query is (blockIdx.x kBqThreads + threadIdx.x) >> LG.  staged:
// rows in shared memory (else in place in out).
template <int LG>
__global__ void __launch_bounds__(kBqThreads)
ball_query_kernel(const float* __restrict__ q, const float* __restrict__ s,
                  int32_t* __restrict__ out, int m, int n, float r2, int nsample, int staged) {
  constexpr int G = 1 << LG, kSteps = 32, kSpan = G * kSteps;   // supports a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* tile = reinterpret_cast<float4*>(smem_raw);   // kBqTile
  int* rows = reinterpret_cast<int*>(tile + kBqTile);   // (kBqThreads >> LG, nsample)
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int lane_g = tid & (G - 1), ql = tid >> LG;
  const int q0 = blockIdx.x * (kBqThreads >> LG);       // the block's first query
  const int qn = q0 + ql;
  const bool active = qn < m;
  // the group's bits of a warp ballot, and this lane's lower ones
  const unsigned gmask = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << (lane & ~(G - 1));
  const unsigned below = (1u << lane) - 1u;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + (static_cast<size_t>(b) * m + qn) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  int* row = staged ? rows + static_cast<size_t>(ql) * nsample
                    : out + (static_cast<size_t>(b) * m + (active ? qn : 0)) * nsample;
  const float* sp = s + static_cast<size_t>(b) * n * 3;
  int cnt = 0;
  bool done = !active;
  for (int t0 = 0; t0 < n; t0 += kBqTile) {
    // block-uniform exit once every query of the block is full; also the
    // barrier that protects the previous tile before it is overwritten
    if (__syncthreads_and(done)) break;
    const int tcnt = min(kBqTile, n - t0);
    const int span = (tcnt + kSpan - 1) / kSpan * kSpan;   // whole chunks, <= kBqTile
    for (int j = tid; j < span; j += kBqThreads) {
      float4 v = make_float4(INFINITY, INFINITY, INFINITY, 0.f);   // never a hit
      if (j < tcnt) v = make_float4(sp[3 * (t0 + j)], sp[3 * (t0 + j) + 1], sp[3 * (t0 + j) + 2], 0.f);
      tile[j] = v;
    }
    __syncthreads();
    for (int c0 = 0; c0 < span; c0 += kSpan) {
      if (__all_sync(0xffffffffu, done)) break;   // every group of the warp
      const float4* tp = tile + c0 + lane_g;
      unsigned mask = 0u;   // bit u: support c0 + u G + lane_g is a hit
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const float4 p = tp[u * G];
        if (etch_sqdist(qx - p.x, qy - p.y, qz - p.z) < r2) mask |= 1u << u;
      }
      if (done) mask = 0u;
      unsigned any = mask;   // the steps with a hit in the group
#pragma unroll
      for (int off = 1; off < G; off <<= 1) any |= __shfl_xor_sync(0xffffffffu, any, off);
      while (__any_sync(0xffffffffu, any != 0u)) {
        const int u = __ffs(any) - 1;
        const bool hit = any != 0u && ((mask >> u) & 1u);
        const unsigned hits = __ballot_sync(0xffffffffu, hit) & gmask;
        if (hit) {
          const int slot = cnt + __popc(hits & below);
          if (slot < nsample) row[slot] = t0 + c0 + u * G + lane_g;
        }
        cnt += __popc(hits);
        any &= any - 1u;
      }
      done = done || cnt >= nsample;
    }
  }
  // repeat-fill the group's row from its cnt hits (slots below cnt are final
  // once the group's lanes have synchronised), or zero an empty ball
  cnt = min(cnt, nsample);
  __syncwarp();
  if (active)
    for (int j = cnt + lane_g; j < nsample; j += G) row[j] = cnt == 0 ? 0 : row[j % cnt];
  if (!staged) return;
  __syncthreads();
  // the block's rows are one contiguous run of out
  const int nq = min(kBqThreads >> LG, m - q0);
  const size_t len = static_cast<size_t>(nq) * nsample;
  int32_t* ob = out + (static_cast<size_t>(b) * m + q0) * nsample;
  if (nsample % 4 == 0) {
    for (size_t e = tid; e < len / 4; e += kBqThreads)
      reinterpret_cast<int4*>(ob)[e] = reinterpret_cast<const int4*>(rows)[e];
  } else {
    for (size_t e = tid; e < len; e += kBqThreads) ob[e] = rows[e];
  }
}

// The largest group (lg) whose grid fits one wave of resident blocks; the
// instance, its shared memory and whether the rows are staged.  0 on success.
template <int LG>
int launch_ball_query(const float* q, const float* s, int32_t* out, int b, int m, int n,
                      float r2, int nsample, int sms, bool force, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(kBqThreads >> LG) * nsample * sizeof(int);
  const bool staged = rows <= kBqRowBytes;
  const size_t bytes = kBqTile * sizeof(float4) + (staged ? rows : 0);
  cudaError_t err;
  if ((err = etch_allow_smem(ball_query_kernel<LG>, bytes)) != cudaSuccess)
    return static_cast<int>(err);
  if (!force) {
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ball_query_kernel<LG>,
                                                             kBqThreads, bytes)) != cudaSuccess)
      return static_cast<int>(err);
    const long long resident =
        static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) * kBqThreads;
    // groups above 8 lanes only where the grid fills at most half a wave:
    // at B = 8 a group of 16 idles more lanes once its ball is full than it
    // gains (1250 x 1250 at G = 16 0.0234 ms, at G = 8 0.0200, on the card)
    if ((static_cast<long long>(b) * m << LG) > (LG > 3 ? resident / 2 : resident))
      return -1;   // too wide: the next group size
  }
  const int per_block = kBqThreads >> LG;
  const dim3 grid(static_cast<unsigned>((m + per_block - 1) / per_block), b);
  ball_query_kernel<LG><<<grid, kBqThreads, bytes, stream>>>(q, s, out, m, n, r2, nsample,
                                                             staged ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, m, 3), s (b, n, 3) f32 -> idx (b, m, k) i32, d2 (b, m, k) f32,
// ascending by (d2, index).  Requires 1 <= k <= n.
ETCH_API int etch_knn(const float* q, const float* s, int32_t* idx, float* d2, int b, int m,
                      int n, int k, cudaStream_t stream) {
  if (k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return 0;
  if (k <= 4) return launch_knn<4>(q, s, idx, d2, b, m, n, k, stream);
  if (k <= 8) return launch_knn<8>(q, s, idx, d2, b, m, n, k, stream);
  if (k <= 16) return launch_knn<16>(q, s, idx, d2, b, m, n, k, stream);
  return launch_knn<32>(q, s, idx, d2, b, m, n, k, stream);   // passes of 32 above
}

// q (b, m, 3), s (b, n, 3) f32 -> out (b, m, nsample) i32.  Requires
// nsample >= 1.
ETCH_API int etch_ball_query(const float* q, const float* s, int32_t* out, int b, int m,
                             int n, float r2, int nsample, cudaStream_t stream) {
  if (nsample < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return 0;
  // the largest group whose grid fits one wave of resident blocks (half a
  // wave above 8 lanes); rows that do not fit kBqRowBytes of shared memory at
  // that group stay in place
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  int e;
  if ((e = launch_ball_query<5>(q, s, out, b, m, n, r2, nsample, sms, false, stream)) >= 0) return e;
  if ((e = launch_ball_query<4>(q, s, out, b, m, n, r2, nsample, sms, false, stream)) >= 0) return e;
  if ((e = launch_ball_query<3>(q, s, out, b, m, n, r2, nsample, sms, false, stream)) >= 0) return e;
  if ((e = launch_ball_query<2>(q, s, out, b, m, n, r2, nsample, sms, false, stream)) >= 0) return e;
  if ((e = launch_ball_query<1>(q, s, out, b, m, n, r2, nsample, sms, false, stream)) >= 0) return e;
  return launch_ball_query<0>(q, s, out, b, m, n, r2, nsample, sms, true, stream);
}
