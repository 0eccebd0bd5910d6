// Shared helpers for the port's hand-written Hopper kernels.
//
// The first design of each kernel multiplies bf16 tiles on the tensor cores
// through the WMMA API (mma.sync, 16x16x16 bf16 -> f32) out of shared
// memory: right before fast.  The redesigned ones (the attention forward,
// K1b's one-CTA-per-head kernel, the two-kernel attention backward, K4,
// K4b, the decoder blocks' backward GEMMs, K6, K6b) build on sm90.cuh's
// register-level mma.sync, cp.async, TMA and wgmma instead.
#pragma once

#include <cmath>
#include <type_traits>

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

// The decoder's model widths the block kernels (K2-K3b) and the FFN kernels
// (K4, K4b) take, bf16 and fp32: D = 256, 512, 768 or 1024, whole 256-column
// GEMM tiles, at most four (ops/decoder_blocks.py KERNEL_D)
constexpr int kDecoderDMax = 1024;
__host__ __device__ constexpr bool decoder_width_ok(int d) {
  return d >= 256 && d <= kDecoderDMax && d % 256 == 0;
}

// fn(std::integral_constant<int, d>()) for a width d that decoder_width_ok
// takes, then the launch error: the row kernels whose lanes hold a whole
// D-wide row are built once per width; else cudaErrorInvalidValue
template <typename Fn>
inline cudaError_t with_decoder_width(int d, const Fn& fn) {
  switch (d) {
    case 256: fn(std::integral_constant<int, 256>()); break;
    case 512: fn(std::integral_constant<int, 512>()); break;
    case 768: fn(std::integral_constant<int, 768>()); break;
    case 1024: fn(std::integral_constant<int, 1024>()); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The attention kernels (bf16 and fp32) are templates on a head tile: the
// one that takes a head of dh columns is 32 for dh 8, 16 and 32, else dh
// (64, 128, 256 or 512); 0 for a width no kernel takes.  Tiles 256 and 512
// are the wide builds (num_head 2 and 1 at d_model 512): their CTAs split
// the head's output columns over grid z and stream the head in 64-column
// chunks.  ops/attention.py:head_tile mirrors it.
__host__ __device__ constexpr int attn_head_tile(int dh) {
  return (dh == 8 || dh == 16 || dh == 32) ? 32
         : (dh == 64 || dh == 128 || dh == 256 || dh == 512) ? dh
                                                              : 0;
}

// the head dim of a D-wide projection over `heads` heads that the kernels
// take (8, 16, 32, 64, 128, 256 or 512), or 0
__host__ __device__ constexpr int attn_head_dim(int d, int heads) {
  return heads > 0 && d % heads == 0 && attn_head_tile(d / heads) ? d / heads : 0;
}

// the head dim a kernel of head tile DH runs: DH itself in the 64-wide build
// (the only dh attn_head_tile gives it), so that the configs' build folds
// every column check away; the argument otherwise (8, 16 or 32 in the
// 32-wide build, 128 in the 128-wide one, whose registers ptxas allots
// without a spill that way)
template <int DH>
__device__ __forceinline__ int attn_run_dh(int dh) {
  return DH == 64 ? DH : dh;
}

// the softmax scale dh^-0.5, the value ops/attention.py passes as a float
inline float attn_scale(int dh) { return (float)(1.0 / std::sqrt((double)dh)); }

// Counter-based dropout, the device side of crog_tpu_torch/ops/dropout.py:
// bits(seed, row, col) = mix(mix(mix(seed) ^ row) ^ col), kept where
// bits >= thresh.  row and col are the element's global indices, so the
// mask does not depend on a kernel's tiling and a backward kernel
// regenerates the forward's mask.  thresh 0 switches dropout off.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float scale;  // 1 / (1 - rate)
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45D9F3Bu;
  x = ((x >> 16) ^ x) * 0x45D9F3Bu;
  return (x >> 16) ^ x;
}

__device__ __forceinline__ bool dropout_keep(const Dropout& d, uint32_t row,
                                             uint32_t col) {
  return d.thresh == 0u || mix32(mix32(mix32(d.seed) ^ row) ^ col) >= d.thresh;
}

// x * keep * scale in f32, rounded to bf16 and back (the twins' rounding)
__device__ __forceinline__ float dropout_apply(const Dropout& d, uint32_t row,
                                               uint32_t col, float x) {
  if (d.thresh == 0u) return x;
  return dropout_keep(d, row, col) ? bf2f(f2bf(x * d.scale)) : 0.0f;
}

}  // namespace crog

// Each kernel library is one translation unit, so each carries its own copy.
extern "C" const char* crog_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
