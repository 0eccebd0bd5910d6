// Row kernels of the fp32 forward kernels: LayerNorm with f32 statistics
// and flax's fast variance E[x^2] - E[x]^2 (clamped at 0), as
// ops/decoder_blocks.py:ln_stats computes it, one warp per row of N
// floats held in registers.  Shared by K2-f32 / K3-f32 (N = D, 256 to 1024:
// LN_pre with the positional add, LN_post with dropout and the residual) and
// K4-f32 (N = 2048: the hidden's LayerNorm, in place).  Bytes bound them:
// each reads its rows once and writes them once.
#pragma once

#include "common.cuh"

namespace crog {

constexpr int kLnF32Warps = 8;  // rows per CTA
constexpr float kLnEps = 1e-5f;

// lane holds columns 4 * (lane + 32 i) .. + 3 of the row, i < N / 128
template <int N>
__device__ __forceinline__ void ln_load(const float* row, float4 (&v)[N / 128], int lane) {
#pragma unroll
  for (int i = 0; i < N / 128; ++i) v[i] = reinterpret_cast<const float4*>(row)[lane + 32 * i];
}

template <int N>
__device__ __forceinline__ void ln_stats(const float4 (&v)[N / 128], float& mu, float& rstd) {
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 128; ++i) {
    s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    s2 += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / N;
  rstd = rsqrtf(fmaxf(s2 / N - mu * mu, 0.0f) + kLnEps);
}

// (x - mu) * rstd * gamma + beta, in the twin's order
template <int N>
__device__ __forceinline__ void ln_apply(float4 (&v)[N / 128], float mu, float rstd,
                                         const float* gamma, const float* beta, int lane) {
#pragma unroll
  for (int i = 0; i < N / 128; ++i) {
    const float4 gm = reinterpret_cast<const float4*>(gamma)[lane + 32 * i];
    const float4 bt = reinterpret_cast<const float4*>(beta)[lane + 32 * i];
    v[i].x = (v[i].x - mu) * rstd * gm.x + bt.x;
    v[i].y = (v[i].y - mu) * rstd * gm.y + bt.y;
    v[i].z = (v[i].z - mu) * rstd * gm.z + bt.z;
    v[i].w = (v[i].w - mu) * rstd * gm.w + bt.w;
  }
}

template <int N>
__device__ __forceinline__ void ln_store(float* row, const float4 (&v)[N / 128], int lane) {
#pragma unroll
  for (int i = 0; i < N / 128; ++i) reinterpret_cast<float4*>(row)[lane + 32 * i] = v[i];
}

// In place: h[r] = LN(h[r]) * gamma + beta
template <int N>
__global__ void __launch_bounds__(kLnF32Warps * 32)
    ln_rows_f32_kernel(float* h, const float* gamma, const float* beta, int rows) {
  const int r = blockIdx.x * kLnF32Warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float* row = h + (long long)r * N;
  float4 v[N / 128];
  ln_load<N>(row, v, lane);
  float mu, rstd;
  ln_stats<N>(v, mu, rstd);
  ln_apply<N>(v, mu, rstd, gamma, beta, lane);
  ln_store<N>(row, v, lane);
}

template <int N>
static cudaError_t launch_ln_rows_f32(float* h, const float* gamma, const float* beta, int rows,
                                      cudaStream_t stream) {
  const int blocks = (rows + kLnF32Warps - 1) / kLnF32Warps;
  ln_rows_f32_kernel<N><<<blocks, kLnF32Warps * 32, 0, stream>>>(h, gamma, beta, rows);
  return cudaGetLastError();
}

}  // namespace crog
