// Farthest point sampling, one thread block per cloud.
//
// Replaces etch_tpu/ops/pallas_fps.py:_fps_kernel (fps_pallas).  Semantics of
// etch_tpu/ops/fps.py:_fps_xla: start at point 0; each of the m-1 sequential
// steps lowers the running min squared distance to the last pick and picks
// its argmax, the smaller index winning ties.
//
// Bound on the H100: the chain of m - 1 dependent steps, not bytes or
// FLOPs (5000 -> 2500 at B = 8 is 0.2 GFLOP and 0.5 MB).  A step's latency is
// what counts: its distance updates, the argmax across the block and the
// broadcast of the pick.  Design (fps_reg_kernel, N up to kRegPoints):
//   - A block has at most kThreads = 512 threads (16 warps; 256 and 1024
//     threads were no faster on the H100).
//   - Each thread keeps its PPT points (j = tid + threads * i) and their
//     running minimum in registers for the whole run; the cloud also sits in
//     shared memory (12 B a point), read only to fetch the pick's
//     coordinates.  Points past N get a running minimum of 0 and an index
//     past N, so they lose every comparison with a real point.
//   - The argmax keys are the running minima's bits: non-negative f32 values
//     order as their uint32 bits.  A warp takes __reduce_max_sync of the
//     bits, then __reduce_min_sync of the index over the lanes that hold the
//     maximum, so the smaller index wins ties, as _fps_xla requires.
//   - One barrier a step: each warp writes its (key, index) to the step's
//     parity slot; after the barrier every warp reduces the (at most 32)
//     slots itself, so there is no second barrier and no broadcast slot.  A
//     slot is rewritten two steps later, after the next barrier, which every
//     warp passes only once it has read it.
//   - The distance is (dx dx + dy dy) + dz dz with one rounding an op
//     (etch_sqdist), as fps_torch computes it, so the indices are equal.
// Above the register capacity (fps_mem_kernel, any N) the cloud and the
// running minimum live in a float4 scratch in device memory (16 B a point,
// held by the L2) and stream through every step; the argmax is the same.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;      // the most threads a block
constexpr int kRegPoints = 8192;   // the register instance's most points: 16 a thread
constexpr int kNoIndex = 0x7fffffff;

// Block-wide argmax of (key, index): the warp's reduction, one barrier, then
// every warp reduces the slots of step `step` itself.
__device__ __forceinline__ int block_argmax(uint32_t key, int idx, uint32_t (*skey)[32],
                                            int (*sidx)[32], int step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const uint32_t wmax = __reduce_max_sync(0xffffffffu, key);
  const int widx = __reduce_min_sync(0xffffffffu, key == wmax ? idx : kNoIndex);
  const int par = step & 1;
  if (lane == 0) {
    skey[par][warp] = wmax;
    sidx[par][warp] = widx;
  }
  __syncthreads();
  const uint32_t k2 = lane < nw ? skey[par][lane] : 0u;
  const int i2 = lane < nw ? sidx[par][lane] : kNoIndex;
  const uint32_t bmax = __reduce_max_sync(0xffffffffu, k2);
  return __reduce_min_sync(0xffffffffu, k2 == bmax ? i2 : kNoIndex);
}

// grid (b); block `threads` <= kThreads, a multiple of 32, with PPT *
// threads >= n.  512 threads leave 128 registers a thread, room for 16 points.
template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_reg_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n, int m) {
  extern __shared__ float cloud[];   // 3 n
  __shared__ uint32_t skey[2][32];
  __shared__ int sidx[2][32];
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  const int T = blockDim.x, tid = threadIdx.x;
  for (int e = tid; e < 3 * n; e += T) cloud[e] = p[e];
  float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + T * i;
    const bool in = j < n;
    x[i] = in ? p[3 * j] : 0.f;
    y[i] = in ? p[3 * j + 1] : 0.f;
    z[i] = in ? p[3 * j + 2] : 0.f;
    md[i] = in ? INFINITY : 0.f;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float cx = cloud[3 * last], cy = cloud[3 * last + 1], cz = cloud[3 * last + 2];
    uint32_t bk = 0;
    int bj = tid;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      md[i] = fminf(md[i], etch_sqdist(x[i] - cx, y[i] - cy, z[i] - cz));
      const uint32_t key = __float_as_uint(md[i]);
      if (i == 0 || key > bk) {   // strict: the smaller index keeps a tie
        bk = key;
        bj = tid + T * i;
      }
    }
    last = block_argmax(bk, bj, skey, sidx, s);
    if (tid == 0) o[s] = last;
  }
}

// grid (b); block kThreads.  scratch (b, n) float4: x, y, z, running min.
__global__ void __launch_bounds__(kThreads)
fps_mem_kernel(const float* __restrict__ xyz, float4* __restrict__ scratch,
               int32_t* __restrict__ out, int n, int m) {
  __shared__ uint32_t skey[2][32];
  __shared__ int sidx[2][32];
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float4* sc = scratch + static_cast<size_t>(blockIdx.x) * n;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * m;
  const int T = blockDim.x, tid = threadIdx.x;
  for (int j = tid; j < n; j += T) sc[j] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], INFINITY);
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < m; ++s) {
    const float cx = __ldg(p + 3 * last), cy = __ldg(p + 3 * last + 1), cz = __ldg(p + 3 * last + 2);
    uint32_t bk = 0;
    int bj = kNoIndex;
    for (int j = tid; j < n; j += T) {
      const float4 q = sc[j];
      const float d = fminf(q.w, etch_sqdist(q.x - cx, q.y - cy, q.z - cz));
      if (d < q.w) sc[j].w = d;
      const uint32_t key = __float_as_uint(d);
      if (bj == kNoIndex || key > bk) {
        bk = key;
        bj = j;
      }
    }
    last = block_argmax(bk, bj, skey, sidx, s);
    if (tid == 0) o[s] = last;
  }
}

// Points a thread of the register instance for n points; 0 above
// kRegPoints, the device-memory instance's.
int points_per_thread(int n) {
  static const int kPpt[] = {1, 2, 4, 6, 8, 10, 12, 16};
  for (int ppt : kPpt)
    if (ppt * kThreads >= n) return ppt;
  return 0;
}

template <int PPT>
int launch_reg(const float* xyz, int32_t* out, int b, int n, int m, int threads,
               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3) * n * sizeof(float);
  cudaError_t err = etch_allow_smem(fps_reg_kernel<PPT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_reg_kernel<PPT><<<b, threads, smem, stream>>>(xyz, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (b, n, 3) f32 contiguous -> out (b, m) i32.  scratch (b, n) float4 is
// used, and must be given, only for n > 8192 points.  Returns
// cudaGetLastError().
ETCH_API int etch_fps(const float* xyz, int32_t* out, void* scratch, int b, int n, int m,
                      cudaStream_t stream) {
  const int ppt = points_per_thread(n);
  if (ppt == 0) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_mem_kernel<<<b, kThreads, 0, stream>>>(xyz, static_cast<float4*>(scratch), out, n, m);
    return static_cast<int>(cudaGetLastError());
  }
  // the fewest whole warps that hold n points at ppt a thread
  const int threads = ((n + ppt - 1) / ppt + 31) / 32 * 32;
  switch (ppt) {
#define ETCH_CASE(k) \
  case k: return launch_reg<k>(xyz, out, b, n, m, threads, stream);
    ETCH_CASE(1) ETCH_CASE(2) ETCH_CASE(4) ETCH_CASE(6) ETCH_CASE(8) ETCH_CASE(10) ETCH_CASE(12)
    ETCH_CASE(16)
#undef ETCH_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
