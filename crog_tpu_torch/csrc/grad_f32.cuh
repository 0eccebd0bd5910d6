// The fp32 backward kernels' sums: a fixed-order sum of partials (the
// chunk partials of a product split over K, and column partials); fixed-
// order column sums over rows; and the LayerNorm backward of a row block.
// K2b-f32 and K3b-f32 (decoder_blocks_bwd_f32.cu) and K4b-f32
// (ffn_bwd_f32.cu) take all three, K6b-f32 (s2dconv_f32.cu) reduce_parts;
// their products run on gemm_wgmma_f32.cuh.
//
// A partial is summed in partial order by `reduce_parts_kernel`, and a
// column sum adds its rows in order within fixed row blocks, then the
// blocks in order: no atomics, two calls give the same bits.
#pragma once

#include "common.cuh"

namespace crog {

// Fixed-order sum of `parts` partials of `n` floats, `stride` apart:
// out[i] = ((part[0][i] + part[1][i]) + ...) in partial order.
__global__ void __launch_bounds__(256) reduce_parts_kernel(const float* __restrict__ part,
                                                           int parts, long long stride,
                                                           long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += part[p * stride + i];
  out[i] = s;
}

static cudaError_t reduce_parts(const float* part, int parts, long long stride, long long n,
                                float* out, cudaStream_t stream) {
  reduce_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, parts, stride, n,
                                                                      out);
  return cudaGetLastError();
}

// Partial column sums of a [rows, n] matrix (row stride lda) over blocks
// of kColRows rows, each block's rows in order: part [blocks, n].
constexpr int kColRows = 256;

__global__ void __launch_bounds__(256) colsum_part_kernel(const float* __restrict__ a,
                                                          long long lda, int rows, int n,
                                                          float* __restrict__ part) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= n) return;
  const int r0 = blockIdx.y * kColRows, r1 = min(rows, r0 + kColRows);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += a[(long long)r * lda + c];
  part[(long long)blockIdx.y * n + c] = s;
}

inline int colsum_blocks(int rows) { return (rows + kColRows - 1) / kColRows; }

// out[c] = sum over the rows of a[:, c], in a fixed order; part holds
// colsum_blocks(rows) x n floats
static cudaError_t colsum_f32(const float* a, long long lda, int rows, int n, float* part,
                              float* out, cudaStream_t stream) {
  const dim3 grid((n + 255) / 256, colsum_blocks(rows));
  colsum_part_kernel<<<grid, 256, 0, stream>>>(a, lda, rows, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(part, colsum_blocks(rows), n, n, out, stream);
}

// ------------------------------------------------ LayerNorm row blocks
// A CTA of NT = N / 8 threads takes a row at a time; thread i holds the
// float4 column groups i and NT + i of the row (8 columns), and keeps the
// column partials of its 8 columns over the CTA's rows in registers, so no
// shared-memory column reduction is needed.  A row's sums go through a
// warp reduction and then the warps' totals in warp order.
template <int N>
struct RowBlock {
  static constexpr int kThreads = N / 8;
  static constexpr int kWarps = kThreads / 32;
};

template <int N>
__device__ __forceinline__ void rb_load(const float* row, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(row)[threadIdx.x];
  const float4 b = reinterpret_cast<const float4*>(row)[RowBlock<N>::kThreads + threadIdx.x];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int N>
__device__ __forceinline__ void rb_store(float* row, const float (&v)[8]) {
  reinterpret_cast<float4*>(row)[threadIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(row)[RowBlock<N>::kThreads + threadIdx.x] =
      make_float4(v[4], v[5], v[6], v[7]);
}

// column of element e of this thread's 8
template <int N>
__device__ __forceinline__ int rb_col(int e) {
  return 4 * (threadIdx.x + (e >> 2) * RowBlock<N>::kThreads) + (e & 3);
}

// (sum a, sum b) over the CTA's threads; `red` holds 2 kWarps floats, and
// the call begins and ends with a barrier, so it can be called in a loop
template <int N>
__device__ __forceinline__ float2 rb_sum2(float a, float b, float* red) {
  constexpr int W = RowBlock<N>::kWarps;
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[W + warp] = b;
  }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sa += red[w];
    sb += red[W + w];
  }
  return make_float2(sa, sb);
}

// x-hat of the row in v (in place) and its rstd: f32 statistics with flax's
// fast variance E[x^2] - E[x]^2, as ln_f32.cuh and ops/decoder_blocks.py's
// ln_stats
template <int N>
__device__ __forceinline__ float rb_xhat(float (&v)[8], float* red) {
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s += v[e];
    s2 += v[e] * v[e];
  }
  const float2 t = rb_sum2<N>(s, s2, red);
  const float mu = t.x / N;
  const float rstd = rsqrtf(fmaxf(t.y / N - mu * mu, 0.0f) + 1e-5f);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rstd;
  return rstd;
}

// LayerNorm backward of a row (``ln_bwd``): dx = rstd (dy g - mean(dy g) -
// xhat mean(dy g xhat)), into dx
template <int N>
__device__ __forceinline__ void rb_ln_dx(float (&dx)[8], const float (&dy)[8],
                                         const float (&xhat)[8], const float* g, float rstd,
                                         float* red) {
  float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dx[e] = dy[e] * g[rb_col<N>(e)];
    m1 += dx[e];
    m2 += dx[e] * xhat[e];
  }
  const float2 t = rb_sum2<N>(m1, m2, red);
  const float a = t.x / N, b = t.y / N;
#pragma unroll
  for (int e = 0; e < 8; ++e) dx[e] = rstd * (dx[e] - a - xhat[e] * b);
}

// this thread's 8 column partials of Q sums into part[blockIdx.x][q][N]
template <int N, int Q>
__device__ __forceinline__ void rb_store_parts(const float (&acc)[Q][8], float* part) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
    rb_store<N>(part + ((long long)blockIdx.x * Q + q) * N, acc[q]);
}

}  // namespace crog
