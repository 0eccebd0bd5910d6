// K4: the CROG decoder FFN, forward, one kernel.
//
// Replaces crog_tpu/ops/pallas_ffn.py:190 `_fused_ffn_fwd` (pallas_call at
// :197, under `fused_ffn` :176):
//
//   h  = bf16(x W1^T + b1);  h = drop(relu(h))   (counter-based mask, common.cuh)
//   hn = bf16(LN(h))         f32 statistics, flax fast variance
//   y  = bf16(hn W2^T + b2)
//
// for x [M, 512] bf16, W1 [2048, 512], W2 [512, 2048] (torch Linear layout).
//
// Bound on an H100 at B=24 (M = 24*676 = 16224): 68.0 GFLOP over 37 MB,
// about 69 us, limited by the tensor cores.
//
// Design: one block of 8 warps takes a tile of 32 token rows and keeps its
// whole [32, 2048] hidden in shared memory (128 KB, dynamic-smem opt-in), so
// the hidden never reaches device memory, as in the TPU kernel that kept it
// in VMEM.  Phase 1 builds the hidden 256 columns at a time from W1 tiles
// streamed through shared memory; the LayerNorm then runs in place, one warp
// per row; phase 2 streams W2 tiles against the resident hidden.  Products
// are bf16 WMMA with f32 accumulation.  Both weights are re-read from L2 by
// every block; a persistent, pipelined design is later work.
#include "common.cuh"

namespace crog {

constexpr int kFD = 512;    // model width
constexpr int kFF = 2048;   // hidden width
constexpr int kFM = 32;     // rows per block
constexpr int kFK = 32;     // K step
constexpr int kFN1 = 256;   // phase-1 column chunk
constexpr int kXLd = kFD + 8;
constexpr int kHLd = kFF + 8;
constexpr int kWLd = kFK + 8;
constexpr int kSLd1 = kFN1 + 4;  // phase-1 f32 staging stride
constexpr int kSLd2 = kFD + 4;   // phase-2 f32 staging stride
constexpr float kFfnEps = 1e-5f;

constexpr size_t kXBytes = (size_t)kFM * kXLd * sizeof(bf16);
constexpr size_t kHBytes = (size_t)kFM * kHLd * sizeof(bf16);
constexpr size_t kRBytes = (size_t)kFD * kWLd * sizeof(bf16);  // largest use
constexpr size_t kFfnSmem = kXBytes + kHBytes + kRBytes;

static_assert((size_t)kFN1 * kWLd * sizeof(bf16) <= kRBytes, "w1 tile");
static_assert((size_t)kFM * kSLd1 * sizeof(float) <= kRBytes, "phase-1 staging");
static_assert((size_t)kFM * kSLd2 * sizeof(float) <= kHBytes, "phase-2 staging");
static_assert(kXBytes % 128 == 0 && kHBytes % 128 == 0, "region alignment");

// DROP is a compile-time switch, so eval runs a phase 1 without the mask.
template <bool DROP>
__global__ void __launch_bounds__(256) ffn_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ g,
    const float* __restrict__ be, const bf16* __restrict__ w2,
    const float* __restrict__ b2, bf16* __restrict__ y, int M, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + kXBytes);
  unsigned char* region = smem_raw + kXBytes + kHBytes;
  bf16* wt = reinterpret_cast<bf16*>(region);
  float* st1 = reinterpret_cast<float*>(region);
  float* st2 = reinterpret_cast<float*>(hs);
  const int m0 = blockIdx.x * kFM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // ---- x tile, zero rows past M
  for (int v = threadIdx.x; v < kFM * (kFD / 8); v += 256) {
    const int r = v / (kFD / 8);
    const int c = (v % (kFD / 8)) * 8;
    if (m0 + r < M) {
      copy8(xs + r * kXLd + c, x + (long long)(m0 + r) * kFD + c);
    } else {
      zero8(xs + r * kXLd + c);
    }
  }

  // ---- phase 1: h = relu(bf16(x W1^T + b1)), 256 columns at a time
  for (int n0 = 0; n0 < kFF; n0 += kFN1) {
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < kFD; k0 += kFK) {
      for (int v = threadIdx.x; v < kFN1 * (kFK / 8); v += 256) {
        const int r = v / (kFK / 8);
        const int c = (v % (kFK / 8)) * 8;
        copy8(wt + r * kWLd + c, w1 + (long long)(n0 + r) * kFD + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; kk += 16) {
        FragA fa[2];
        FragBCol fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], xs + (i * 16) * kXLd + k0 + kk, kXLd);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], wt + (warp * 32 + j * 16) * kWLd + kk, kWLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(st1 + (i * 16) * kSLd1 + warp * 32 + j * 16,
                                acc[i][j], kSLd1, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < kFM * kFN1; e += 256) {
      const int r = e / kFN1;
      const int c = e % kFN1;
      float h = fmaxf(bf2f(f2bf(st1[r * kSLd1 + c] + b1[n0 + c])), 0.0f);
      if (DROP) h = dropout_apply(drop, m0 + r, n0 + c, h);
      hs[r * kHLd + n0 + c] = f2bf(h);
    }
    __syncthreads();
  }

  // ---- LayerNorm over each row's 2048 hidden values, in place
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    bf16* hr = hs + r * kHLd;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < kFF; c += 32) {
      const float h = bf2f(hr[c]);
      s += h;
      ss += h * h;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / kFF;
    const float var = fmaxf(0.f, ss / kFF - mu * mu);
    const float rstd = rsqrtf(var + kFfnEps);
    for (int c = lane; c < kFF; c += 32)
      hr[c] = f2bf((bf2f(hr[c]) - mu) * rstd * g[c] + be[c]);
  }
  __syncthreads();

  // ---- phase 2: y = bf16(hn W2^T + b2); warp w owns columns [64w, 64w+64)
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < kFF; k0 += kFK) {
    for (int v = threadIdx.x; v < kFD * (kFK / 8); v += 256) {
      const int r = v / (kFK / 8);
      const int c = (v % (kFK / 8)) * 8;
      copy8(wt + r * kWLd + c, w2 + (long long)r * kFF + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], hs + (i * 16) * kHLd + k0 + kk, kHLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBCol fb;
        wmma::load_matrix_sync(fb, wt + (warp * 64 + j * 16) * kWLd + kk, kWLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
  // the hidden is consumed: stage the f32 result over it
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(st2 + (i * 16) * kSLd2 + warp * 64 + j * 16,
                              acc[i][j], kSLd2, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kFM * kFD; e += 256) {
    const int r = e / kFD;
    const int c = e % kFD;
    if (m0 + r < M)
      y[(long long)(m0 + r) * kFD + c] = f2bf(st2[r * kSLd2 + c] + b2[c]);
  }
}

}  // namespace crog

// x [M, 512], w1 [2048, 512], w2 [512, 2048] bf16; b1, g, be [2048] and
// b2 [512] f32; y [M, 512].  Dropout on the hidden with (seed, thresh,
// scale); thresh 0 is eval.
extern "C" int crog_ffn_fwd(const void* x, const void* w1, const float* b1,
                            const float* g, const float* be, const void* w2,
                            const float* b2, void* y, int M, int D, int F,
                            unsigned seed, unsigned thresh, float scale,
                            void* stream) {
  using crog::bf16;
  if (D != crog::kFD || F != crog::kFF || M < 1) return (int)cudaErrorInvalidValue;
  auto kernel = thresh ? crog::ffn_fwd_kernel<true> : crog::ffn_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)crog::kFfnSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + crog::kFM - 1) / crog::kFM;
  kernel<<<blocks, 256, crog::kFfnSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1, g, be,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(y), M,
      crog::Dropout{seed, thresh, scale});
  return (int)cudaGetLastError();
}
