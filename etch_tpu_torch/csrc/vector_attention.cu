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
// the TPU kernel drops it, which gives the same softmax.
//
// The TPU kernel takes neighbour-major operands gathered beforehand
// (ns, R, c) for each of k, v and pe.  Here a block gathers its rows of k and
// v itself from the (B, N, c) projections by index, so neither gathered
// tensor exists in device memory.
//
// Bound on the H100: memory.  Per row it reads 2*ns gathered rows and ns pe
// rows of c bf16 values (3.1 KB at ns=8, c=64) for about ns*c*(cs + 4)
// FLOPs, a few FLOPs a byte, far below the card's ridge.  Design: T rows per
// block (T*ns*c ~ 4096), a thread per channel on coalesced rows; the w rows
// and logits stay in shared memory between the phases; the two small
// products (c -> cs, cs -> cs) run as FP32 FMAs out of shared memory (exact
// products of bf16 values), since they are a few percent of the bytes' time.
#include "common.cuh"

namespace {

// grid (ceil(R / T)); block 256.
__global__ void vector_attention_kernel(
    const bf16* __restrict__ xq, const bf16* __restrict__ xk, const bf16* __restrict__ xv,
    const int32_t* __restrict__ idx, const bf16* __restrict__ pe,
    const float* __restrict__ a0, const bf16* __restrict__ w0,
    const float* __restrict__ a1, const bf16* __restrict__ w1,
    const float* __restrict__ b1, float* __restrict__ out, int R, int N, int ns, int c,
    int cs, int T) {
  extern __shared__ float smem[];
  const int ldw = c + 1;                       // odd stride: rows fall on other banks
  float* ws = smem;                            // T*ns x ldw, bf16-rounded w rows
  float* zs = ws + T * ns * ldw;               // T*ns x cs, bf16-rounded z
  float* ls = zs + T * ns * cs;                // T*ns x cs, logits, then weights
  int* src = reinterpret_cast<int*>(ls + T * ns * cs);  // T*ns neighbour rows
  const int r0 = blockIdx.x * T;

  for (int e = threadIdx.x; e < T * ns; e += blockDim.x) {
    const int r = r0 + e / ns;
    src[e] = r < R ? (r / N) * N + idx[static_cast<size_t>(r) * ns + e % ns] : 0;
  }
  __syncthreads();

  // phase 1: w rows
  for (int e = threadIdx.x; e < T * ns * c; e += blockDim.x) {
    const int tj = e / c, ch = e % c, r = r0 + tj / ns;
    float w = 0.f;
    if (r < R) {
      const float d = etch_f32(xk[static_cast<size_t>(src[tj]) * c + ch]) -
                      etch_f32(xq[static_cast<size_t>(r) * c + ch]);
      const float v = d + etch_f32(pe[(static_cast<size_t>(r0) * ns + tj) * c + ch]);
      w = etch_round_bf16(fmaxf(v * a0[ch] + a0[c + ch], 0.f));
    }
    ws[tj * ldw + ch] = w;
  }
  __syncthreads();

  // phase 2: z = bf16(relu(w W0 * a1[0] + a1[1]))
  for (int e = threadIdx.x; e < T * ns * cs; e += blockDim.x) {
    const int tj = e / cs, l = e % cs;
    const float* wr = ws + tj * ldw;
    float z = 0.f;
    for (int ch = 0; ch < c; ++ch) z = fmaf(wr[ch], etch_f32(w0[ch * cs + l]), z);
    zs[e] = etch_round_bf16(fmaxf(z * a1[l] + a1[cs + l], 0.f));
  }
  __syncthreads();

  // phase 3: logits = z W1 + b1
  for (int e = threadIdx.x; e < T * ns * cs; e += blockDim.x) {
    const int tj = e / cs, l = e % cs;
    const float* zr = zs + tj * cs;
    float z = 0.f;
    for (int m = 0; m < cs; ++m) z = fmaf(zr[m], etch_f32(w1[m * cs + l]), z);
    ls[e] = z + b1[l];
  }
  __syncthreads();

  // phase 4: softmax over the ns neighbours, per (row, lane)
  for (int e = threadIdx.x; e < T * cs; e += blockDim.x) {
    const int t = e / cs, l = e % cs;
    float* lt = ls + t * ns * cs + l;
    float m = -INFINITY;
    for (int j = 0; j < ns; ++j) m = fmaxf(m, lt[j * cs]);
    float den = 0.f;
    for (int j = 0; j < ns; ++j) den += expf(lt[j * cs] - m);
    const float inv = 1.f / den;
    for (int j = 0; j < ns; ++j) lt[j * cs] = expf(lt[j * cs] - m) * inv;
  }
  __syncthreads();

  // phase 5: out = sum_j (v_j + pe_j) * s_j, lane ch % cs
  for (int e = threadIdx.x; e < T * c; e += blockDim.x) {
    const int t = e / c, ch = e % c, r = r0 + t;
    if (r >= R) continue;
    const float* st = ls + t * ns * cs + ch % cs;
    const bf16* per = pe + static_cast<size_t>(r) * ns * c + ch;
    float acc = 0.f;
    for (int j = 0; j < ns; ++j) {
      const float v = etch_f32(xv[static_cast<size_t>(src[t * ns + j]) * c + ch]) +
                      etch_f32(per[j * c]);
      acc = fmaf(v, st[j * cs], acc);
    }
    out[static_cast<size_t>(r) * c + ch] = acc;
  }
}

}  // namespace

// xq (R, c), xk / xv (B, N, c), pe (R, ns, c), w0 (c, cs), w1 (cs, cs): bf16;
// idx (R, ns) int32 within each cloud; a0 (2, c), a1 (2, cs), b1 (cs), out
// (R, c): f32.  R = B * N; T rows per block.
ETCH_API int etch_vector_attention(const void* xq, const void* xk, const void* xv,
                                   const int32_t* idx, const void* pe, const float* a0,
                                   const void* w0, const float* a1, const void* w1,
                                   const float* b1, float* out, int R, int N, int ns, int c,
                                   int cs, int T, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(T) * ns * (c + 1 + 2 * cs) + static_cast<size_t>(T) * ns) *
      sizeof(float);
  cudaError_t err = etch_allow_smem(vector_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (R + T - 1) / T;
  vector_attention_kernel<<<blocks, 256, smem, stream>>>(
      static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
      idx, static_cast<const bf16*>(pe), a0, static_cast<const bf16*>(w0), a1,
      static_cast<const bf16*>(w1), b1, out, R, N, ns, c, cs, T);
  return static_cast<int>(cudaGetLastError());
}
