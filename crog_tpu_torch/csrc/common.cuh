// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here multiplies bf16 tiles on the tensor cores through the
// WMMA API (mma.sync, 16x16x16 bf16 -> f32) out of shared memory.  That is
// the simple first design: right before fast.  A wgmma/TMA pipeline is
// later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace crog {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

// round to nearest even, the rounding of jnp.astype(bfloat16)
__device__ __forceinline__ bf16 f2bf(float x) { return __float2bfloat16_rn(x); }

// 16-byte copy of 8 bf16 values; both addresses must be 16-byte aligned
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero8(bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Masked-out keys take this score, as in the TPU kernels: finite, so a row
// whose keys are all masked stays finite.
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

}  // namespace crog

// Each kernel library is one translation unit, so each carries its own copy.
extern "C" const char* crog_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
