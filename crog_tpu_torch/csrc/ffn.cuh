// The CROG decoder FFN's device code shared by K4 (ffn.cu, the forward) and
// K4b (ffn_bwd.cu, the backward): the 8-CTA cluster layout of a 128-row
// tile's hidden, the hidden's computation h = drop(relu(bf16(x W1^T + b1)))
// with the LN statistics of its whole rows exchanged across the cluster,
// hn = bf16(LN(h)) out, and the [128, 256]-tile GEMM behind K4's y and
// K4b's dx.  K4 computes the hidden and K4b recomputes it with the same
// code, so both hold it identically by construction.
//
// Cast points (crog_tpu/ops/pallas_ffn.py:_fwd_kernel :78): h rounded to
// bf16 after the bias, before ReLU and dropout, and again after the dropout
// scale; the LN statistics in f32 over the bf16 hidden with the fast
// variance E[h^2] - E[h]^2; hn rounded once.
//
// The model width D is a run-time value (decoder_width_ok's 256, 512, 768
// or 1024): the hidden product's K, and the y / dx GEMM's D / 256 column
// tiles.  The hidden width F is kBF.
#pragma once

#include "gemm.cuh"
#include "sm90.cuh"

namespace crog {

constexpr int kBF = 2048;            // hidden width
constexpr int kBM = kGM;             // rows per cluster tile (ops/ffn.py BWD_ROWS)
constexpr int kBCl = 8;              // CTAs per cluster
constexpr int kBN = kBF / kBCl;      // hidden columns per CTA
constexpr int kBNT = 16;             // 8-column C fragments per warp (one wgmma N = 128)
constexpr int kBHLd = kBN + 8;       // h / dh slice [128][264]
constexpr float kBEps = 1e-5f;
using FfnRing = GemmRing<128, false, kGK>;  // [128, 256] tiles beside the hidden
using FfnOutRing = GemmRing<128, false, kGKDeep>;  // the y / dx GEMM's
constexpr size_t kBRingBytes = FfnRing::kBytes;
constexpr size_t kHHBytes = (size_t)kBM * kBHLd * sizeof(bf16);
constexpr int kHRedF = 2 * kBM * 2;  // [column warpgroup][row][2] row partials
constexpr int kHXchF = 4 * kBM;      // [exchange][2][row], read by the cluster
constexpr int kHRowF = 4 * kBM;      // mu, rstd (and K4b's m1, m2) per row

// this thread's rows (16 rw + g8 + 8 hf) and columns (128 (wg % 2) + 8 nt +
// 2 qd, + 1) of a CTA's [128, 256] slice, as the mainloop's C fragments
__device__ __forceinline__ int ffn_row(int hf) { return frag_row() + 8 * hf; }

__device__ __forceinline__ int ffn_col(int nt) {
  return ((threadIdx.x >> 7) & 1) * 128 + nt * 8 + frag_col();
}

// The hidden of rows m0 .. m0 + 127, columns n0 .. n0 + 255 (CTA `rank` of
// the tile's cluster): [128 x 256 x D] on the mainloop, then on the
// accumulators the bias, bf16, ReLU and dropout (DROP: the mask bits of
// element (ffn_row(hf), ffn_col(nt) + e) into bit 2 nt + e of keep[hf], for
// K4b's backward), h into hs; the row partials of sum(h), sum(h^2) cross the
// cluster and rowst[0..127] / rowst[128..255] get each row's mean and rstd.
// w1t is W1 transposed, [D, 2048] row-major.  Leaves acc free.
template <bool DROP>
__device__ __forceinline__ void ffn_hidden(float (&acc)[kBNT][4], uint32_t (&keep)[2],
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w1t,
                                           const float* __restrict__ b1, int m0, int M, int D,
                                           int n0, const Dropout& drop, unsigned char* ring,
                                           bf16* hs, float* red, float* xch, float* rowst) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int qd = tid & 3;
  gemm_zero(acc);
  gemm_mainloop<128, false, kGK>(acc, x, D, m0, M, w1t, kBF, n0, 0, D, ring, NoChunkHook());
  const bool on = DROP && drop.thresh != 0u;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ffn_row(hf);
    // the row's part of the counter hash, mix(mix(seed) ^ row), once
    const uint32_t rowbits = mix32(mix32(drop.seed) ^ (uint32_t)(m0 + r));
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kBNT; ++nt) {
      const int c = ffn_col(nt);
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        h[e] = fmaxf(bf2f(f2bf(acc[nt][2 * hf + e] + b1[n0 + c + e])), 0.0f);
        if (on) {
          const bool k = mix32(rowbits ^ (uint32_t)(n0 + c + e)) >= drop.thresh;
          keep[hf] |= (uint32_t)k << (2 * nt + e);
          h[e] = k ? bf2f(f2bf(h[e] * drop.scale)) : 0.0f;
        }
        s += h[e];
        ss += h[e] * h[e];
      }
      *reinterpret_cast<uint32_t*>(hs + r * kBHLd + c) = pack_bf16(h[0], h[1]);
    }
    s = quad_sum(s);
    ss = quad_sum(ss);
    if (qd == 0) {
      red[((wg & 1) * kBM + r) * 2] = s;
      red[((wg & 1) * kBM + r) * 2 + 1] = ss;
    }
  }
  __syncthreads();
  {  // LN statistics of the whole rows, from the 8 CTAs' partials
    const float2 tot = cluster_row_sums(red, xch, kBCl);
    if (tid < kBM) {
      const float mu = tot.x / kBF;
      rowst[tid] = mu;
      rowst[kBM + tid] = rsqrtf(fmaxf(0.0f, tot.y / kBF - mu * mu) + kBEps);
    }
  }
  __syncthreads();
}

// hn = bf16(LN(h)) of the CTA's slice out to hn_out [M, 2048], 16-byte row
// segments
__device__ __forceinline__ void ffn_write_hn(const bf16* hs, const float* rowst,
                                             const float* __restrict__ g,
                                             const float* __restrict__ be,
                                             bf16* __restrict__ hn_out, int m0, int M, int n0) {
  const int tid = threadIdx.x;
  const int c = (tid & 31) * 8;  // the same 8 columns in every step
  float gv[8], bv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    gv[e] = g[n0 + c + e];
    bv[e] = be[n0 + c + e];
  }
  for (int r = tid >> 5; r < kBM; r += kGThreads / 32) {
    if (m0 + r >= M) break;
    alignas(16) bf16 hv[8], out[8];
    copy8(hv, hs + r * kBHLd + c);
    const float mu = rowst[r], rstd = rowst[kBM + r];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = f2bf((bf2f(hv[e]) - mu) * rstd * gv[e] + bv[e]);
    copy8(hn_out + (long long)(m0 + r) * kBF + n0 + c, out);
  }
}

// K4's y = bf16(hn W2^T + b2) (B = W2^T [2048, D], bias b2) and K4b's dx =
// bf16(dh W1) (B = W1 [2048, D], no bias): a [128, 256] tile per CTA, K =
// 2048, blockIdx.x the column tile (D / 256 of them), blockIdx.y the row
// tile
__global__ void __launch_bounds__(kGThreads, 1) ffn_out_kernel(GemmArgs g) {
  gemm_tile<128, 1, false>(g);
}

static cudaError_t ffn_out_smem_once() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ffn_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FfnOutRing::kSmem);
  return attr;
}

// [M, D] = bf16(A [M, 2048] B [2048, D] (+ bias)) over `tiles` row tiles
static cudaError_t launch_ffn_out(const bf16* a, const bf16* b, const float* bias, bf16* out,
                                  int M, int D, int tiles, cudaStream_t st) {
  const cudaError_t err = ffn_out_smem_once();
  if (err != cudaSuccess) return err;
  GemmArgs g = {};
  g.a[0] = a;
  g.b[0] = b;
  g.bias = bias;
  g.cb = out;
  g.lda = kBF;
  g.ldb = g.ldc = D;
  g.M = M;
  g.K = kBF;
  ffn_out_kernel<<<dim3(D / FfnOutRing::kN, tiles), kGThreads, FfnOutRing::kSmem, st>>>(g);
  return cudaGetLastError();
}

// a launch of `tiles` clusters of kBCl CTAs of kGThreads threads
static cudaLaunchConfig_t ffn_cluster_config(int tiles, size_t smem, cudaLaunchAttribute* attr,
                                             cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kBCl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBCl * tiles);
  cfg.blockDim = dim3(kGThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// out[4]: a cluster kernel's registers per thread, shared memory per CTA
// (static + dynamic), spill bytes per thread and clusters resident at once
template <typename Kernel>
static cudaError_t ffn_cluster_attrs(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + smem);
  out[2] = (int)fa.localSizeBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ffn_cluster_config(1, smem, &attr, nullptr);
  return cudaOccupancyMaxActiveClusters(&out[3], kernel, &cfg);
}

// out[4]: ffn_out_kernel's registers, shared memory, spills and CTAs per SM
static cudaError_t ffn_out_attrs(int* out) {
  cudaError_t err = ffn_out_smem_once();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ffn_out_kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + FfnOutRing::kSmem);
  out[2] = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], ffn_out_kernel, kGThreads,
                                                       FfnOutRing::kSmem);
}

}  // namespace crog
