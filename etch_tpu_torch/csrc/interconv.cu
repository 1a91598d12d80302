// Inter-SO(3)-conv contraction, with both neighbour gathers fused in.
//
// Replaces etch_tpu/nn/pallas_interconv.py:interconv_t_pallas, body _kernel
// (C >= 32 feature contraction) and body _kernel_ones (all-ones occupancy
// input).  For a center p with neighbours n = nbr[p, 0..nn):
//
//   x_pn       = xyz[nbr[p, n]] - center[p]
//   w[n, a, k] = relu(1 - |x_pn - R_a kappa_k|^2 / sigma)     (A*K = 1440)
//   t[p,a,k,c] = sum_n w[n, a, k] * feats[nbr[p, n], a*C + c]  (contraction)
//   t[p,a,k]   = sum_n w[n, a, k]                             (occupancy)
//
// The JAX package gathers the neighbour coordinates and the (c, nn, A*C)
// feature block into device memory first (etch_tpu/nn/epn.py:223,239) and
// needs an f32 HIGHEST matmul on the TPU to form w.  Here one block owns one
// center: it gathers its neighbours' coordinates and feature rows straight
// from the contiguous (B, P, A*C) tensor, forms w with FP32 arithmetic, and
// neither w nor the gathered block ever exists in device memory.  Reading
// rows of the contiguous feature tensor is the layout contract that
// etch_tpu/ops/grouping.py:materialize_rows pins on the TPU.
//
// Bound on the H100: FP32 FMA issue and shared-memory bandwidth (no tensor
// cores: the f32 path keeps full precision).  Per center the contraction is
// nn*A*K*C FMAs (2.9 M at nn=64, C=32) against nn*A*C*4 bytes of gathered
// features, about 12 FMAs a byte.  Design: anchors are processed in groups
// of G, sized so the w tile (nn x G*K) and the feature tile (nn x G*C) fit in
// shared memory (a whole (64, 1440) f32 w block is 368 KB and does not); each
// thread accumulates a TK x TC = 3 x 4 register micro-tile of (k, c) outputs,
// so seven shared-memory reads feed twelve FMAs.  Tensor-core (wgmma) and TMA
// staging are left for later work.
#include "common.cuh"

namespace {

constexpr int kTK = 3;  // kernel points per thread micro-tile
constexpr int kTC = 4;  // channels per thread micro-tile

__device__ __forceinline__ void load_offsets(const float* __restrict__ xyz,
                                             const float* __restrict__ ctr,
                                             const int32_t* __restrict__ nbr, int nn,
                                             float* gx, int* sidx) {
  for (int n = threadIdx.x; n < nn; n += blockDim.x) {
    const int j = nbr[n];
    if (sidx != nullptr) sidx[n] = j;
    gx[3 * n] = xyz[3 * j] - ctr[0];
    gx[3 * n + 1] = xyz[3 * j + 1] - ctr[1];
    gx[3 * n + 2] = xyz[3 * j + 2] - ctr[2];
  }
}

__device__ __forceinline__ float kernel_weight(const float* g, const float* r, float sigma) {
  const float dx = g[0] - r[0], dy = g[1] - r[1], dz = g[2] - r[2];
  return fmaxf(1.f - (dx * dx + dy * dy + dz * dz) / sigma, 0.f);
}

// grid (c, B); block G * (K / kTK) * (C / kTC) threads.
__global__ void interconv_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                 const float* __restrict__ centers,  // (B, c, 3)
                                 const int32_t* __restrict__ nbr,    // (B, c, nn)
                                 const float* __restrict__ feats,    // (B, P, A*C)
                                 const float* __restrict__ rk,       // (A*K, 3)
                                 float* __restrict__ out,            // (B, c, A, K, C)
                                 int P, int c, int nn, int A, int K, int C, int G,
                                 float sigma) {
  extern __shared__ float smem[];
  float* gx = smem;                       // nn * 3
  float* ws = gx + nn * 3;                // nn * G*K
  float* fs = ws + nn * G * K;            // nn * G*C
  int* sidx = reinterpret_cast<int*>(fs + nn * G * C);  // nn

  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, sidx);

  const int ct_n = C / kTC;
  const int per_anchor = (K / kTK) * ct_n;
  const int g = threadIdx.x / per_anchor;
  const int r = threadIdx.x % per_anchor;
  const int k0 = (r / ct_n) * kTK;
  const int c0 = (r % ct_n) * kTC;
  const int GK = G * K, GC = G * C;
  const size_t AC = static_cast<size_t>(A) * C;
  const float* fb = feats + static_cast<size_t>(b) * P * AC;
  float* ob = out + bp * static_cast<size_t>(A) * K * C;

  for (int a0 = 0; a0 < A; a0 += G) {
    __syncthreads();  // offsets ready / previous group's tiles consumed
    for (int e = threadIdx.x; e < nn * GK; e += blockDim.x) {
      const int n = e / GK, gk = e % GK;
      ws[e] = kernel_weight(gx + 3 * n, rk + 3 * (static_cast<size_t>(a0) * K + gk), sigma);
    }
    for (int e = threadIdx.x; e < nn * GC; e += blockDim.x) {
      const int n = e / GC, col = e % GC;
      fs[e] = fb[static_cast<size_t>(sidx[n]) * AC + static_cast<size_t>(a0) * C + col];
    }
    __syncthreads();

    float acc[kTK][kTC];
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
    const float* wr = ws + g * K + k0;
    const float* fr = fs + g * C + c0;
    for (int n = 0; n < nn; ++n) {
      float wv[kTK], fv[kTC];
#pragma unroll
      for (int i = 0; i < kTK; ++i) wv[i] = wr[n * GK + i];
#pragma unroll
      for (int j = 0; j < kTC; ++j) fv[j] = fr[n * GC + j];
#pragma unroll
      for (int i = 0; i < kTK; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(wv[i], fv[j], acc[i][j]);
    }
    float* op = ob + (static_cast<size_t>(a0 + g) * K + k0) * C + c0;
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) op[i * C + j] = acc[i][j];
  }
}

// grid (c, B); one thread per (a, k) output column, looping over neighbours.
__global__ void interconv_ones_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                      const float* __restrict__ centers,  // (B, c, 3)
                                      const int32_t* __restrict__ nbr,    // (B, c, nn)
                                      const float* __restrict__ rk,       // (A*K, 3)
                                      float* __restrict__ out,            // (B, c, A*K)
                                      int P, int c, int nn, int AK, float sigma) {
  extern __shared__ float gx[];  // nn * 3
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, nullptr);
  __syncthreads();
  float* ob = out + bp * AK;
  for (int e = threadIdx.x; e < AK; e += blockDim.x) {
    const float rv[3] = {rk[3 * e], rk[3 * e + 1], rk[3 * e + 2]};
    float acc = 0.f;
    for (int n = 0; n < nn; ++n) acc += kernel_weight(gx + 3 * n, rv, sigma);
    ob[e] = acc;
  }
}

}  // namespace

// Contraction.  Requires K % 3 == 0, C % 4 == 0, A % G == 0; the caller picks
// G and passes the block's thread count G * (K/3) * (C/4).
ETCH_API int etch_interconv_t(const float* xyz, const float* centers, const int32_t* nbr,
                              const float* feats, const float* rk, float* out, int b, int P,
                              int c, int nn, int A, int K, int C, int G, float sigma,
                              cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(nn) * (3 + G * K + G * C) + nn) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = G * (K / kTK) * (C / kTC);
  interconv_kernel<<<dim3(c, b), threads, smem, stream>>>(xyz, centers, nbr, feats, rk, out,
                                                          P, c, nn, A, K, C, G, sigma);
  return static_cast<int>(cudaGetLastError());
}

// Occupancy (all-ones features): out (b, c, A*K).
ETCH_API int etch_interconv_ones(const float* xyz, const float* centers, const int32_t* nbr,
                                 const float* rk, float* out, int b, int P, int c, int nn,
                                 int AK, float sigma, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nn) * 3 * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_ones_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_ones_kernel<<<dim3(c, b), 256, smem, stream>>>(xyz, centers, nbr, rk, out, P, c,
                                                           nn, AK, sigma);
  return static_cast<int>(cudaGetLastError());
}
