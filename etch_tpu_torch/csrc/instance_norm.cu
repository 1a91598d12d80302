// One EPN conv block's epilogue: instance norm over the (point, anchor) rows,
// leaky ReLU and, where given, the skip sum,
//
//   out = leaky_relu((x - mean) * rsqrt(var + eps), slope) [+ residual],
//
// with the statistics of each (batch element, channel) in float64.
//
// Replaces no Pallas kernel: the JAX package leaves its norm, with f32
// statistics, to XLA (etch_tpu/nn/epn.py:94-100).  The port keeps float64
// statistics (nn/epn.py::instance_norm_pa, this kernel's plain twin): a
// per-channel constant, the first block's skip branch, then normalises to
// exactly 0.  PyTorch runs that twin as a widening copy, two float64
// reductions over the non-innermost axes of a channels-last tensor,
// broadcasting float64 arithmetic, a narrowing copy, the activation and the
// sum: about 80 bytes of device traffic an element, 92 with the sum.
//
// Bound on the H100: bytes.  About one operation a byte, far below the
// card's ~295 (bf16) or ~20 (FP32) a byte.  Each input read once and the
// output written once is 8 bytes an element, 12 with the residual.  This
// design reads x twice, once for the statistics and once to normalise it:
// 12 bytes an element (16 with the residual).  Design:
//   - x is (B, R, C) f32, channels innermost, R = P * A rows a batch
//     element.  A block of kThreads threads serves `tile` groups of V
//     channels (V = 4, 16-byte loads, where C % 4 == 0 and the pointers are
//     16-byte aligned; V = 1 otherwise) on kThreads / tile row lanes, so
//     neighbouring threads read neighbouring addresses.  Above kThreads
//     groups a row, grid.z walks the channel tiles.
//   - Pass 1 (norm_stats_kernel), grid (splits, batch elements, channel
//     tiles): each thread sums d = x - k and d * d in float64 over its rows,
//     k its first value (a constant channel gives d = 0 exactly), turns the
//     sums into (count, mean, M2), and the block merges its row lanes by
//     Chan's formula in a fixed tree.  One (count, mean, M2) a split and
//     channel goes to a float64 scratch.  No atomics: two runs give the same
//     bits.
//   - Pass 2 (norm_merge_kernel): 8 threads a (batch element, channel)
//     merge the splits, each a strided subset in index order, then in a
//     fixed tree, and write mean and 1 / sqrt(M2 / count + eps), both
//     float64.
//   - Pass 3 (norm_apply_kernel): (x - mean) * rstd in float64, rounded once
//     to f32; the leaky ReLU in f32 as torch computes it (y > 0 ? y :
//     y * slope); the residual added in f32.  Each step rounds on its own
//     (no FMA contraction), so the output is the twin's wherever the
//     statistics round alike.
//   - One launch of each pass serves the whole batch.  Walking it a few
//     elements at a time, so that pass 3 would find x in the L2 where pass
//     1 left it, measured slower on the H100 at every serving shape (B=32:
//     0.76-1.33 ms a call in groups of 8 to 1 against 0.65 in one): each
//     group pays its own launches, merge and tails.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// (n, mean, m2) += (nb, meanb, m2b), Chan's parallel formula.
__device__ __forceinline__ void chan_merge(double& n, double& mean, double& m2, double nb,
                                           double meanb, double m2b) {
  if (nb == 0.0) return;
  if (n == 0.0) {
    n = nb, mean = meanb, m2 = m2b;
    return;
  }
  const double tot = n + nb, inv = 1.0 / tot, delta = meanb - mean;
  mean += delta * nb * inv;
  m2 += m2b + delta * delta * n * nb * inv;
  n = tot;
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Where a thread works: its channel group g (of V channels) and row lane.
struct Place {
  int g, lane, lanes, tile;
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(int c) {
  const int groups = c / V;
  Place p;
  p.tile = min(groups, kThreads);
  p.lanes = kThreads / p.tile;
  p.lane = threadIdx.x / p.tile;
  p.g = blockIdx.z * p.tile + threadIdx.x % p.tile;
  p.active = p.lane < p.lanes && p.g < groups;
  return p;
}

// grid (splits, batch elements, channel tiles), kThreads threads.  part:
// (batch element, split, {count, mean, m2}, channel) float64.
template <int V>
__global__ void __launch_bounds__(kThreads) norm_stats_kernel(const float* __restrict__ x,
                                                              double* __restrict__ part, int rows,
                                                              int c, int chunk) {
  __shared__ double s_n[kThreads];
  __shared__ double s_mean[kThreads][V];
  __shared__ double s_m2[kThreads][V];
  const Place p = place<V>(c);
  const int splits = gridDim.x, s = blockIdx.x, b = blockIdx.y;
  const int r0 = s * chunk, r1 = min(rows, r0 + chunk);
  const float* xb = x + static_cast<size_t>(b) * rows * c + p.g * V;

  double n = 0.0, mean[V], m2[V];
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.0;
  int r = r0 + p.lane;
  if (p.active && r < r1) {
    float v[V];
    double k[V], sum[V], sq[V];
    load<V>(xb + static_cast<size_t>(r) * c, v);
    for (int j = 0; j < V; ++j) k[j] = v[j], sum[j] = sq[j] = 0.0;
    int cnt = 0;
    const int step = p.lanes;
    // four rows in flight, then the rest one at a time
    for (; r + 3 * step < r1; r += 4 * step) {
      float w[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load<V>(xb + static_cast<size_t>(r + u * step) * c, w[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const double d = static_cast<double>(w[u][j]) - k[j];
          sum[j] += d;
          sq[j] = fma(d, d, sq[j]);
        }
      cnt += 4;
    }
    for (; r < r1; r += step) {
      load<V>(xb + static_cast<size_t>(r) * c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double d = static_cast<double>(v[j]) - k[j];
        sum[j] += d;
        sq[j] = fma(d, d, sq[j]);
      }
      ++cnt;
    }
    n = cnt;
    for (int j = 0; j < V; ++j) {
      mean[j] = k[j] + sum[j] / n;
      m2[j] = sq[j] - sum[j] * sum[j] / n;
    }
  }

  // merge the row lanes: lane l takes lane l + stride, in a fixed tree
  const int t = threadIdx.x;
  s_n[t] = n;
  for (int j = 0; j < V; ++j) s_mean[t][j] = mean[j], s_m2[t][j] = m2[j];
  for (int stride = 1; stride < p.lanes; stride <<= 1) {
    __syncthreads();
    if (p.active && p.lane % (2 * stride) == 0 && p.lane + stride < p.lanes) {
      const int o = t + stride * p.tile;
      const double nb = s_n[o];
      for (int j = 0; j < V; ++j) {
        double nj = n;
        chan_merge(nj, mean[j], m2[j], nb, s_mean[o][j], s_m2[o][j]);
        s_mean[t][j] = mean[j], s_m2[t][j] = m2[j];
      }
      n += nb;
      s_n[t] = n;
    }
  }
  if (p.active && p.lane == 0) {
    double* out = part + (static_cast<size_t>(b) * splits + s) * 3 * c + p.g * V;
    for (int j = 0; j < V; ++j) {
      out[j] = n;
      out[c + j] = mean[j];
      out[2 * c + j] = m2[j];
    }
  }
}

// grid (ceil(c / 32), batch elements), kThreads threads: 32 channels on
// kThreads / 32 split lanes.  Lane l merges splits l, l + lanes, ... in
// order, then the lanes merge in a fixed tree.  stat: (batch element,
// {mean, rstd}, channel) float64.
__global__ void __launch_bounds__(kThreads) norm_merge_kernel(const double* __restrict__ part,
                                                              double* __restrict__ stat, int c,
                                                              int splits, double eps) {
  constexpr int kLanes = kThreads / 32;
  __shared__ double s_n[kLanes][32], s_mean[kLanes][32], s_m2[kLanes][32];
  const int col = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + col, b = blockIdx.y;
  const bool active = ch < c;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  if (active) {
    const double* pb = part + static_cast<size_t>(b) * splits * 3 * c + ch;
#pragma unroll 4
    for (int s = lane; s < splits; s += kLanes)
      chan_merge(n, mean, m2, pb[(3 * s) * c], pb[(3 * s + 1) * c], pb[(3 * s + 2) * c]);
  }
  s_n[lane][col] = n, s_mean[lane][col] = mean, s_m2[lane][col] = m2;
  for (int stride = 1; stride < kLanes; stride <<= 1) {
    __syncthreads();
    if (lane % (2 * stride) == 0) {
      chan_merge(n, mean, m2, s_n[lane + stride][col], s_mean[lane + stride][col],
                 s_m2[lane + stride][col]);
      s_n[lane][col] = n, s_mean[lane][col] = mean, s_m2[lane][col] = m2;
    }
  }
  if (active && lane == 0) {
    stat[static_cast<size_t>(b) * 2 * c + ch] = mean;
    stat[static_cast<size_t>(b) * 2 * c + c + ch] = 1.0 / sqrt(m2 / n + eps);
  }
}

template <int V, bool kResidual>
__device__ __forceinline__ void apply_row(float* __restrict__ orow, const float (&v)[V],
                                          const float (&res)[V], const double (&mean)[V],
                                          const double (&rstd)[V], float slope) {
  float y[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float h = __double2float_rn(__dmul_rn(__dsub_rn(static_cast<double>(v[j]), mean[j]),
                                                rstd[j]));
    y[j] = h > 0.f ? h : __fmul_rn(h, slope);
    if constexpr (kResidual) y[j] = __fadd_rn(y[j], res[j]);
  }
  store<V>(orow, y);
}

// grid (splits, batch elements, channel tiles), kThreads threads.
template <int V, bool kResidual>
__global__ void __launch_bounds__(kThreads) norm_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ residual,
    const double* __restrict__ stat, float* __restrict__ out, int rows, int c, int chunk,
    float slope) {
  const Place p = place<V>(c);
  if (!p.active) return;
  const int b = blockIdx.y, r0 = blockIdx.x * chunk, r1 = min(rows, r0 + chunk);
  const size_t base = static_cast<size_t>(b) * rows * c + p.g * V;
  double mean[V], rstd[V];
  for (int j = 0; j < V; ++j) {
    mean[j] = stat[static_cast<size_t>(b) * 2 * c + p.g * V + j];
    rstd[j] = stat[static_cast<size_t>(b) * 2 * c + c + p.g * V + j];
  }
  const int step = p.lanes;
  int r = r0 + p.lane;
  // four rows in flight, then the rest one at a time
  for (; r + 3 * step < r1; r += 4 * step) {
    float w[4][V], res[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t o = base + static_cast<size_t>(r + u * step) * c;
      load<V>(x + o, w[u]);
      if constexpr (kResidual) load<V>(residual + o, res[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      apply_row<V, kResidual>(out + base + static_cast<size_t>(r + u * step) * c, w[u], res[u],
                              mean, rstd, slope);
  }
  for (; r < r1; r += step) {
    const size_t o = base + static_cast<size_t>(r) * c;
    float v[V], res[V];
    load<V>(x + o, v);
    if constexpr (kResidual) load<V>(residual + o, res);
    apply_row<V, kResidual>(out + o, v, res, mean, rstd, slope);
  }
}

template <int V>
int run(const float* x, const float* residual, float* out, double* scratch, int b, int rows,
        int c, int splits, float slope, double eps, cudaStream_t stream) {
  const int groups = c / V, tile = min(groups, kThreads);
  const int tiles = (groups + tile - 1) / tile;
  const int chunk = (rows + splits - 1) / splits;
  double* part = scratch;
  double* stat = scratch + static_cast<size_t>(b) * splits * 3 * c;
  const dim3 grid(splits, b, tiles);
  norm_stats_kernel<V><<<grid, kThreads, 0, stream>>>(x, part, rows, c, chunk);
  norm_merge_kernel<<<dim3((c + 31) / 32, b), kThreads, 0, stream>>>(part, stat, c, splits, eps);
  if (residual != nullptr)
    norm_apply_kernel<V, true><<<grid, kThreads, 0, stream>>>(x, residual, stat, out, rows, c,
                                                              chunk, slope);
  else
    norm_apply_kernel<V, false><<<grid, kThreads, 0, stream>>>(x, nullptr, stat, out, rows, c,
                                                               chunk, slope);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* x, const float* residual, float* out, double* scratch, int b,
             int rows, int c, int vec, int splits, float slope, double eps,
             cudaStream_t stream) {
  if (b < 1 || b > 65535 || rows < 1 || c < 1 || splits < 1 || splits > rows ||
      !(vec == 1 || (vec == 4 && c % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  return vec == 4 ? run<4>(x, residual, out, scratch, b, rows, c, splits, slope, eps, stream)
                  : run<1>(x, residual, out, scratch, b, rows, c, splits, slope, eps, stream);
}

}  // namespace

// x (b, rows, c) f32 -> out (b, rows, c) f32; scratch: b * (3 * splits + 2)
// * c float64.  vec 4 needs c % 4 == 0 and 16-byte aligned x and out.
ETCH_API int etch_instance_norm(const float* x, float* out, double* scratch, int b, int rows,
                                int c, int vec, int splits, float slope, double eps,
                                cudaStream_t stream) {
  return dispatch(x, nullptr, out, scratch, b, rows, c, vec, splits, slope, eps, stream);
}

// The same, plus residual (b, rows, c) f32 (16-byte aligned for vec 4).
ETCH_API int etch_instance_norm_residual(const float* x, const float* residual, float* out,
                                         double* scratch, int b, int rows, int c, int vec,
                                         int splits, float slope, double eps,
                                         cudaStream_t stream) {
  if (residual == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, residual, out, scratch, b, rows, c, vec, splits, slope, eps, stream);
}
