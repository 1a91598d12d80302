// Neighbour queries: k nearest neighbours and ball query.
//
// knn_kernel replaces etch_tpu/ops/pallas_knn.py:_knn_kernel (knn_pallas);
// ball_query_kernel replaces etch_tpu/ops/pallas_knn.py:_ball_kernel
// (ball_query_pallas).  Both compute squared distances by direct difference
// (common.cuh:etch_sqdist), as the TPU kernels do.
//
// Bound on the H100: FP32 issue rate.  Every query visits every support point
// (M*N distance evaluations: 25 M per cloud at 5000 x 5000), while the bytes
// moved are only the coordinates and the results.  Design: one thread per
// query; the block stages 1024-point tiles of the support cloud in shared
// memory, which every thread then reads as a broadcast.
//
// kNN keeps a sorted top-KMAX list in registers (KMAX a compile-time bucket
// >= k, so the list is fully unrolled and never spills); a candidate enters
// only if strictly closer than the current worst, and the insertion shifts
// every later entry down by one, so among equal distances the smaller index,
// seen first, stays in front: ties go to the smaller index.  The first k
// entries of a top-KMAX list are the top-k list.
//
// Ball query scans supports in index order, keeps the first nsample hits with
// d2 < r2 (strict), stops the block once every query in it is full, and does
// the reference's repeat-fill in place: cycle the cnt hits into the remaining
// slots; an empty ball gives index 0 (etch_tpu/ops/ball_query.py:21-35).
#include "common.cuh"

namespace {

constexpr int kTile = 1024;

__device__ __forceinline__ void load_tile(const float* __restrict__ s, int t0, int cnt,
                                          float* tx, float* ty, float* tz) {
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    tx[j] = s[3 * (t0 + j)];
    ty[j] = s[3 * (t0 + j) + 1];
    tz[j] = s[3 * (t0 + j) + 2];
  }
}

template <int KMAX>
__global__ void knn_kernel(const float* __restrict__ q, const float* __restrict__ s,
                           int32_t* __restrict__ out_idx, float* __restrict__ out_d2,
                           int m, int n, int k) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + (static_cast<size_t>(b) * m + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float best_d[KMAX];
  int best_i[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    best_d[r] = INFINITY;
    best_i[r] = 0;
  }
  const float* sp = s + static_cast<size_t>(b) * n * 3;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    __syncthreads();
    load_tile(sp, t0, cnt, tx, ty, tz);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const float d = etch_sqdist(qx - tx[j], qy - ty[j], qz - tz[j]);
      if (d < best_d[KMAX - 1]) {
        float cd = d;
        int ci = t0 + j;
        bool moved = false;
#pragma unroll
        for (int r = 0; r < KMAX; ++r) {
          const bool take = moved || cd < best_d[r];
          if (take) {
            const float tv = best_d[r];
            const int ti = best_i[r];
            best_d[r] = cd;
            best_i[r] = ci;
            cd = tv;
            ci = ti;
          }
          moved = take;
        }
      }
    }
  }
  if (!active) return;
  int32_t* oi = out_idx + (static_cast<size_t>(b) * m + qi) * k;
  float* od = out_d2 + (static_cast<size_t>(b) * m + qi) * k;
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    if (r < k) {
      oi[r] = best_i[r];
      od[r] = best_d[r];
    }
  }
}

__global__ void ball_query_kernel(const float* __restrict__ q, const float* __restrict__ s,
                                  int32_t* __restrict__ out, int m, int n, float r2,
                                  int nsample) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  int32_t* o = out + (static_cast<size_t>(b) * m + (active ? qi : 0)) * nsample;
  if (active) {
    const float* qp = q + (static_cast<size_t>(b) * m + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float* sp = s + static_cast<size_t>(b) * n * 3;
  int cnt = 0;
  bool done = !active;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    // block-uniform exit once every query of the block is full; also the
    // barrier that protects the previous tile before it is overwritten
    if (__syncthreads_and(done)) break;
    const int tcnt = min(kTile, n - t0);
    load_tile(sp, t0, tcnt, tx, ty, tz);
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < tcnt; ++j) {
      if (etch_sqdist(qx - tx[j], qy - ty[j], qz - tz[j]) < r2) {
        o[cnt++] = t0 + j;
        if (cnt == nsample) {
          done = true;
          break;
        }
      }
    }
  }
  if (!active) return;
  if (cnt == 0) {
    for (int j = 0; j < nsample; ++j) o[j] = 0;
  } else {
    for (int j = cnt; j < nsample; ++j) o[j] = o[j % cnt];
  }
}

template <int KMAX>
cudaError_t launch_knn(const float* q, const float* s, int32_t* idx, float* d2, int b,
                       int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((m + 127) / 128, b);
  knn_kernel<KMAX><<<grid, 128, 0, stream>>>(q, s, idx, d2, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// q (b, m, 3), s (b, n, 3) f32 -> idx (b, m, k) i32, d2 (b, m, k) f32,
// ascending.  Requires 1 <= k <= min(n, 32).
ETCH_API int etch_knn(const float* q, const float* s, int32_t* idx, float* d2, int b, int m,
                      int n, int k, cudaStream_t stream) {
  if (k <= 4) return static_cast<int>(launch_knn<4>(q, s, idx, d2, b, m, n, k, stream));
  if (k <= 8) return static_cast<int>(launch_knn<8>(q, s, idx, d2, b, m, n, k, stream));
  if (k <= 16) return static_cast<int>(launch_knn<16>(q, s, idx, d2, b, m, n, k, stream));
  if (k <= 32) return static_cast<int>(launch_knn<32>(q, s, idx, d2, b, m, n, k, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (b, m, 3), s (b, n, 3) f32 -> out (b, m, nsample) i32.
ETCH_API int etch_ball_query(const float* q, const float* s, int32_t* out, int b, int m,
                             int n, float r2, int nsample, cudaStream_t stream) {
  const dim3 grid((m + 127) / 128, b);
  ball_query_kernel<<<grid, 128, 0, stream>>>(q, s, out, m, n, r2, nsample);
  return static_cast<int>(cudaGetLastError());
}
