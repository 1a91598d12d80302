// Inter-SO(3)-conv contraction, with both neighbour gathers fused in.
//
// Replaces etch_tpu/nn/pallas_interconv.py:interconv_t_pallas, bodies _kernel
// (C >= 32 feature contraction, f32 or bf16 features), _kernel_ones (all-ones
// occupancy input), _kernel_ones_proj (occupancy input with the (K -> Co)
// projection fused in, bf16 serving path) and _kernel_c1 (1-channel feature
// rows that are not the occupancy input).  For a center p with neighbours
// n = nbr[p, 0..nn):
//
//   x_pn       = xyz[nbr[p, n]] - center[p]
//   w[n, a, k] = relu(1 - |x_pn - R_a kappa_k|^2 / sigma)     (A*K = 1440)
//   t[p,a,k,c] = sum_n w[n, a, k] * feats[nbr[p, n], a*C + c]  (contraction)
//   t[p,a,k]   = sum_n w[n, a, k]                             (occupancy)
//   o[p,a,o]   = sum_k bf16(t[p,a,k]) * bf16(W[k, o])          (ones_proj)
//   t[p,a,k]   = sum_n w[n, a, k] * feats[nbr[p, n], a]        (C == 1)
//
// bf16 features (the serving path's streaming type): w is rounded to bf16
// before the multiply, as _kernel does before its bf16 MXU dot, the sums stay
// f32 and t is written as bf16 (the TPU kernel's bf16 output).  The
// occupancy projection rounds the f32 neighbour sums and W to bf16 and sums
// the K products per anchor in f32; the TPU's block-diagonal (A*K, A*Co)
// weight is a matrix-unit trick and is not built here.  The weights are the
// exact f32 ones (the TPU's approximate fast_w variant is not ported).
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
// so seven shared-memory reads feed twelve FMAs.  The bf16 variant is the
// same kernel reading half the feature bytes; its products of two bf16 values
// are exact in f32, so FP32 FMAs reproduce a bf16 MMA with f32 accumulation.
// Tensor-core (wgmma) and TMA staging are left for later work.
//
// The fused occupancy projection is bound by the weight evaluation, as the
// plain occupancy kernel is (nn*A*K = 92 K weights per center); its
// projection adds A*K*Co = 46 K FMAs per center out of shared memory and
// removes the (B, c, A, K) f32 intermediate and the separate projection.
//
// The C == 1 body keeps _kernel_c1's rounding: w is the exact f32 weight
// (not rounded to bf16, unlike the C >= 32 body), the products and sums are
// f32, and t is rounded to bf16 only on bf16 rows.  The TPU kernel expands
// the (nn, A) rows to (nn, A*K) lanes with a one-hot matmul; here one thread
// owns an (a, k) column and reads its anchor's feature from the block's
// gathered (nn, A) rows in shared memory.  Bound as the occupancy kernel:
// nn*A*K = 92 K weights per center, one shared-memory read each more.
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

// grid (c, B); block G * (K / kTK) * (C / kTC) threads.  T: feature and
// output type (float, or bf16 with w rounded to bf16 before the multiply).
template <typename T>
__global__ void interconv_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                 const float* __restrict__ centers,  // (B, c, 3)
                                 const int32_t* __restrict__ nbr,    // (B, c, nn)
                                 const T* __restrict__ feats,        // (B, P, A*C)
                                 const float* __restrict__ rk,       // (A*K, 3)
                                 T* __restrict__ out,                // (B, c, A, K, C)
                                 int P, int c, int nn, int A, int K, int C, int G,
                                 float sigma) {
  constexpr bool kBf16 = sizeof(T) == 2;
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
  const T* fb = feats + static_cast<size_t>(b) * P * AC;
  T* ob = out + bp * static_cast<size_t>(A) * K * C;

  for (int a0 = 0; a0 < A; a0 += G) {
    __syncthreads();  // offsets ready / previous group's tiles consumed
    for (int e = threadIdx.x; e < nn * GK; e += blockDim.x) {
      const int n = e / GK, gk = e % GK;
      const float w = kernel_weight(gx + 3 * n, rk + 3 * (static_cast<size_t>(a0) * K + gk), sigma);
      ws[e] = kBf16 ? etch_round_bf16(w) : w;
    }
    for (int e = threadIdx.x; e < nn * GC; e += blockDim.x) {
      const int n = e / GC, col = e % GC;
      fs[e] = etch_f32(fb[static_cast<size_t>(sidx[n]) * AC + static_cast<size_t>(a0) * C + col]);
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
    T* op = ob + (static_cast<size_t>(a0 + g) * K + k0) * C + c0;
#pragma unroll
    for (int i = 0; i < kTK; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) etch_store(op + i * C + j, acc[i][j]);
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

// grid (c, B); block 256.  The neighbour sums of interconv_ones_kernel (same
// f32 summation order), rounded to bf16 in shared memory, then a per-anchor
// (A, K) x (K, Co) product with f32 accumulators, written as bf16.
__global__ void interconv_ones_proj_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                           const float* __restrict__ centers,  // (B, c, 3)
                                           const int32_t* __restrict__ nbr,    // (B, c, nn)
                                           const float* __restrict__ rk,       // (A*K, 3)
                                           const bf16* __restrict__ w,         // (K, Co)
                                           bf16* __restrict__ out,             // (B, c, A*Co)
                                           int P, int c, int nn, int A, int K, int Co,
                                           float sigma) {
  extern __shared__ float smem[];
  float* gx = smem;             // nn * 3
  float* ws = gx + nn * 3;      // A * K, bf16-rounded neighbour sums
  float* wp = ws + A * K;       // K * Co, W as float
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, nullptr);
  for (int e = threadIdx.x; e < K * Co; e += blockDim.x) wp[e] = etch_f32(w[e]);
  __syncthreads();
  for (int e = threadIdx.x; e < A * K; e += blockDim.x) {
    const float rv[3] = {rk[3 * e], rk[3 * e + 1], rk[3 * e + 2]};
    float acc = 0.f;
    for (int n = 0; n < nn; ++n) acc += kernel_weight(gx + 3 * n, rv, sigma);
    ws[e] = etch_round_bf16(acc);
  }
  __syncthreads();
  bf16* ob = out + bp * static_cast<size_t>(A) * Co;
  for (int e = threadIdx.x; e < A * Co; e += blockDim.x) {
    const int a = e / Co, o = e % Co;
    const float* wr = ws + a * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(wr[k], wp[k * Co + o], acc);
    ob[e] = __float2bfloat16(acc);
  }
}

// grid (c, B); one thread per (a, k) output column.  T: feature and output
// type (float, or bf16 rows with f32 sums and a bf16 t).
template <typename T>
__global__ void interconv_c1_kernel(const float* __restrict__ xyz,      // (B, P, 3)
                                    const float* __restrict__ centers,  // (B, c, 3)
                                    const int32_t* __restrict__ nbr,    // (B, c, nn)
                                    const T* __restrict__ feats,        // (B, P, A)
                                    const float* __restrict__ rk,       // (A*K, 3)
                                    T* __restrict__ out,                // (B, c, A*K)
                                    int P, int c, int nn, int A, int K, float sigma) {
  extern __shared__ float smem[];
  float* gx = smem;                                    // nn * 3
  float* fs = gx + nn * 3;                             // nn * A
  int* sidx = reinterpret_cast<int*>(fs + nn * A);     // nn
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t bp = static_cast<size_t>(b) * c + p;
  load_offsets(xyz + static_cast<size_t>(b) * P * 3, centers + bp * 3, nbr + bp * nn, nn,
               gx, sidx);
  __syncthreads();
  const T* fb = feats + static_cast<size_t>(b) * P * A;
  for (int e = threadIdx.x; e < nn * A; e += blockDim.x) {
    const int n = e / A, a = e % A;
    fs[e] = etch_f32(fb[static_cast<size_t>(sidx[n]) * A + a]);
  }
  __syncthreads();
  T* ob = out + bp * static_cast<size_t>(A) * K;
  for (int e = threadIdx.x; e < A * K; e += blockDim.x) {
    const float rv[3] = {rk[3 * e], rk[3 * e + 1], rk[3 * e + 2]};
    const float* fa = fs + e / K;
    float acc = 0.f;
    for (int n = 0; n < nn; ++n) acc = fmaf(kernel_weight(gx + 3 * n, rv, sigma), fa[n * A], acc);
    etch_store(ob + e, acc);
  }
}

template <typename T>
int launch_interconv_c1(const float* xyz, const float* centers, const int32_t* nbr,
                        const void* feats, const float* rk, void* out, int b, int P, int c,
                        int nn, int A, int K, float sigma, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nn) * (3 + A + 1) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_c1_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_c1_kernel<T><<<dim3(c, b), 256, smem, stream>>>(
      xyz, centers, nbr, static_cast<const T*>(feats), rk, static_cast<T*>(out), P, c, nn, A,
      K, sigma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interconv_t(const float* xyz, const float* centers, const int32_t* nbr,
                       const void* feats, const float* rk, void* out, int b, int P, int c,
                       int nn, int A, int K, int C, int G, float sigma, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(nn) * (3 + G * K + G * C) + nn) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = G * (K / kTK) * (C / kTC);
  interconv_kernel<T><<<dim3(c, b), threads, smem, stream>>>(
      xyz, centers, nbr, static_cast<const T*>(feats), rk, static_cast<T*>(out), P, c, nn, A,
      K, C, G, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Contraction.  Requires K % 3 == 0, C % 4 == 0, A % G == 0; the caller picks
// G and passes the block's thread count G * (K/3) * (C/4).
ETCH_API int etch_interconv_t(const float* xyz, const float* centers, const int32_t* nbr,
                              const float* feats, const float* rk, float* out, int b, int P,
                              int c, int nn, int A, int K, int C, int G, float sigma,
                              cudaStream_t stream) {
  return launch_interconv_t<float>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K, C, G,
                                   sigma, stream);
}

// The same contraction on bf16 feature rows: bf16 w times bf16 features,
// f32 sums, bf16 t.
ETCH_API int etch_interconv_t_bf16(const float* xyz, const float* centers,
                                   const int32_t* nbr, const void* feats, const float* rk,
                                   void* out, int b, int P, int c, int nn, int A, int K, int C,
                                   int G, float sigma, cudaStream_t stream) {
  return launch_interconv_t<bf16>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K, C, G,
                                  sigma, stream);
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

// Occupancy conv with the fused (K -> Co) projection: w (K, Co) bf16,
// out (b, c, A*Co) bf16.
ETCH_API int etch_interconv_ones_proj(const float* xyz, const float* centers,
                                      const int32_t* nbr, const float* rk, const void* w,
                                      void* out, int b, int P, int c, int nn, int A, int K,
                                      int Co, float sigma, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(nn) * 3 + A * K + K * Co) * sizeof(float);
  cudaError_t err = etch_allow_smem(interconv_ones_proj_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interconv_ones_proj_kernel<<<dim3(c, b), 256, smem, stream>>>(
      xyz, centers, nbr, rk, static_cast<const bf16*>(w), static_cast<bf16*>(out), P, c, nn, A,
      K, Co, sigma);
  return static_cast<int>(cudaGetLastError());
}

// Contraction on 1-channel rows: feats (b, P, A) f32, out (b, c, A*K) f32.
ETCH_API int etch_interconv_t_c1(const float* xyz, const float* centers, const int32_t* nbr,
                                 const float* feats, const float* rk, float* out, int b, int P,
                                 int c, int nn, int A, int K, float sigma,
                                 cudaStream_t stream) {
  return launch_interconv_c1<float>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K,
                                    sigma, stream);
}

// The same on bf16 rows: exact f32 weights and sums, bf16 t.
ETCH_API int etch_interconv_t_c1_bf16(const float* xyz, const float* centers,
                                      const int32_t* nbr, const void* feats, const float* rk,
                                      void* out, int b, int P, int c, int nn, int A, int K,
                                      float sigma, cudaStream_t stream) {
  return launch_interconv_c1<bf16>(xyz, centers, nbr, feats, rk, out, b, P, c, nn, A, K,
                                   sigma, stream);
}
