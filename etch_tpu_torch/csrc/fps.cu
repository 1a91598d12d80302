// Farthest point sampling, one thread block per cloud.
//
// Replaces etch_tpu/ops/pallas_fps.py:_fps_kernel (fps_pallas).  Semantics of
// etch_tpu/ops/fps.py:_fps_xla: start at point 0; each of the m-1 sequential
// steps lowers the running min squared distance to the last pick and picks
// its argmax, the smaller index winning ties.
//
// Bound on the H100: latency, not bandwidth or FLOPs.  The m steps are
// sequential and each ends in a block-wide argmax, so a step costs two
// barriers plus N/blockDim distance updates; only B blocks exist (one per
// cloud), so most SMs idle.  Design: the cloud and its running min distance
// live in shared memory for the whole run (4 floats a point: 80 KB at
// N=5000), so no step touches device memory except to write its pick; the
// argmax is a warp-shuffle reduction followed by one 32-entry pass.
#include "common.cuh"

namespace {

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out,
                           int n, int m) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* mind = sz + n;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_pick;

  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
    mind[j] = INFINITY;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int last = 0;
  for (int i = 1; i < m; ++i) {
    const float cx = sx[last], cy = sy[last], cz = sz[last];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float md = fminf(mind[j], etch_sqdist(sx[j] - cx, sy[j] - cy, sz[j] - cz));
      mind[j] = md;
      argmax_merge(bv, bi, md, j);
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_pick = bi;
        o[i] = bi;
      }
    }
    __syncthreads();
    last = s_pick;
  }
}

}  // namespace

// xyz (b, n, 3) f32 contiguous -> out (b, m) i32.  Returns cudaGetLastError().
ETCH_API int etch_fps(const float* xyz, int32_t* out, int b, int n, int m,
                      cudaStream_t stream) {
  int threads = ((n + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  const size_t smem = static_cast<size_t>(4) * n * sizeof(float);
  cudaError_t err = etch_allow_smem(fps_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, threads, smem, stream>>>(xyz, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
