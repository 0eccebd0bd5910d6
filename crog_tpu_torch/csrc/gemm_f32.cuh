// The fp32 decoder blocks' products: C[M, N] = A[M, K] B[N, K]^T + bias[N]
// with f32 accuracy, B as torch stores a Linear weight ([out, in], so the
// in/out projection weights are read as they are, never transposed), and
// an epilogue that adds the bias in f32.  K2-f32 / K3-f32
// (decoder_blocks_f32.cu: the q/k/v projections and the out-projection).
// The fp32 FFN runs on gemm_wgmma_f32.cuh.
//
// Bound on an H100: operations, at 3xTF32's third of TF32's 495 TFLOP/s.
//
// Design: right and simple first.  wgmma takes TF32 only K-major, which
// both operands are here (rows of A and of the torch-layout B), but the
// 3xTF32 split needs a hi and a lo copy of each operand, staged twice in
// shared memory (gemm_wgmma_f32.cuh does that for the FFN).  So
// each CTA (8 warps) computes a 128 x 128 tile with mma.sync m16n8k8 TF32,
// three products per step (tf32.cuh), over 32-deep K slices that a
// two-stage cp.async ring brings into shared memory (rows padded to 36
// floats: the fragment loads are free of bank conflicts).  Each warp owns
// a 64 x 32 block of the tile; each fragment is split once per K step and
// reused across the warp's block.  The tensor cores add into their f32
// accumulators with truncation, a bias that grows with the number of
// additions: with one accumulator over K = 2048 (768 additions) K4-f32
// read 1.45e-5 relative L2 against its twin on an H100, 1.0e-6 once each
// 32-deep slice accumulates into fresh registers (12 additions) that an
// IEEE f32 add joins to the running sum.  Rows past M load zeros and are
// not stored.
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kGF32M = 128, kGF32N = 128, kGF32K = 32;
constexpr int kGF32Ld = kGF32K + 4;
constexpr int kGF32Threads = 256;
constexpr int kGF32Stage = 2 * kGF32M * kGF32Ld;  // floats of one stage (A and B tiles)

struct GemmF32 {
  const float* a;  // [M, K], row stride lda
  const float* b;  // [N, K], row stride ldb
  const float* bias;  // [N]
  float* c;  // [M, N], row stride ldc
  long long lda, ldb, ldc;
  int m, n, k;
};

inline size_t gemm_f32_smem_bytes() { return 2u * kGF32Stage * sizeof(float); }

template <int P>
__global__ void __launch_bounds__(kGF32Threads) gemm_f32_kernel(const GemmF32 p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kGF32M, n0 = blockIdx.x * kGF32N;

  auto load = [&](int k0, int stage) {
    float* as = smem + stage * kGF32Stage;
    float* bs = as + kGF32M * kGF32Ld;
    for (int i = threadIdx.x; i < kGF32M * kGF32K / 4; i += kGF32Threads) {
      const int r = i >> 3, c = (i & 7) * 4;
      const bool ina = m0 + r < p.m, inb = n0 + r < p.n;
      cp_async16(smem_u32(as + r * kGF32Ld + c),
                 p.a + (long long)(ina ? m0 + r : 0) * p.lda + k0 + c, ina ? 16 : 0);
      cp_async16(smem_u32(bs + r * kGF32Ld + c),
                 p.b + (long long)(inb ? n0 + r : 0) * p.ldb + k0 + c, inb ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = p.k / kGF32K;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) * kGF32K, (kt + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* as = smem + (kt & 1) * kGF32Stage + wm * kGF32Ld;
    const float* bs = smem + (kt & 1) * kGF32Stage + kGF32M * kGF32Ld + wn * kGF32Ld;
    float part[4][4][4];  // this K slice's products
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kGF32K; kk += 8) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ar = as + (16 * i + g) * kGF32Ld + kk + t;
        split_p<P>(ar[0], ah[i][0], al[i][0]);                    // (g, t)
        split_p<P>(ar[8 * kGF32Ld], ah[i][1], al[i][1]);          // (g + 8, t)
        split_p<P>(ar[4], ah[i][2], al[i][2]);                    // (g, t + 4)
        split_p<P>(ar[8 * kGF32Ld + 4], ah[i][3], al[i][3]);      // (g + 8, t + 4)
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = bs + (8 * j + g) * kGF32Ld + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_p<P>(br[0], bh0, bl0);  // (k t, n g)
        split_p<P>(br[4], bh1, bl1);  // (k t + 4, n g)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_p<P>(part[i][j], ah[i], al[i], bh0, bl0, bh1, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    if (col >= p.n) continue;
    const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm + 16 * i + g + 8 * hr;
        if (row >= p.m) continue;
        const float x0 = acc[i][j][2 * hr] + b0, x1 = acc[i][j][2 * hr + 1] + b1;
        *reinterpret_cast<float2*>(p.c + (long long)row * p.ldc + col) = make_float2(x0, x1);
      }
  }
}

template <int P>
static cudaError_t launch_gemm_f32_p(const GemmF32& p, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_f32_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)gemm_f32_smem_bytes());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.n + kGF32N - 1) / kGF32N, (p.m + kGF32M - 1) / kGF32M);
  gemm_f32_kernel<P><<<grid, kGF32Threads, gemm_f32_smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}

// PRODUCT: which F32Product this is (tf32.cuh products_of)
template <int PRODUCT>
static cudaError_t launch_gemm_f32(const GemmF32& p, cudaStream_t stream) {
  if (p.m < 1 || p.n < 2 || p.n % 2 || p.k < kGF32K || p.k % kGF32K || (p.lda | p.ldb) & 3 ||
      p.ldc & 1)
    return cudaErrorInvalidValue;
  return launch_gemm_f32_p<products_of(PRODUCT)>(p, stream);
}

}  // namespace crog
