// Building blocks of the backward kernels: a GEMM for input gradients, a
// weight-gradient (A^T B) row reduction in two deterministic passes, and
// the fixed-order sum of per-block partial rows.
//
// The TPU kernels accumulate dW and the bias / LayerNorm column sums across
// their sequential grid in VMEM.  Hopper blocks run in parallel and in no
// order, so every sum over rows here is a first pass that writes one
// partial row (or [N, K] tile) per row chunk, and a second pass that adds
// the partials in index order: the same gradient in every run, no atomics.
#pragma once

#include "common.cuh"

namespace crog {

using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

// ------------------------------------------------------------- gemm_nn
// C[m, n] = sum_k A[m, k] B[k, n]: A [M, K] (lda), B [K, N] row-major (ldb),
// e.g. dX = dY W for a torch-layout weight W [out, in].  N % 64 == 0,
// K % 32 == 0, lda/ldb/ldc % 8 == 0.  Epilogue by `mode`:
enum GemmOut {
  kOutBf16 = 0,     // Cb = bf16(acc)
  kOutF32 = 1,      // Cf = f32(bf16(acc))
  kOutAddF32 = 2,   // Cf += f32(bf16(acc))
  kOutAddBf16 = 3,  // Cb = bf16(Cf + f32(bf16(acc)))
};
constexpr int kNM = 64, kNN = 64, kNK = 32, kNALd = kNK + 8, kNBLd = kNN + 8, kNCs = 36;

__global__ void __launch_bounds__(128) gemm_nn_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    bf16* Cb, float* Cf, int ldc, int M, int N, int K, int mode) {
  __shared__ __align__(128) bf16 as[kNM * kNALd];
  __shared__ __align__(128) bf16 bs[kNK * kNBLd];
  __shared__ __align__(128) float cs[4][32 * kNCs];
  const int m0 = blockIdx.y * kNM;
  const int n0 = blockIdx.x * kNN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kNK) {
    for (int v = threadIdx.x; v < kNM * (kNK / 8); v += 128) {
      const int r = v / (kNK / 8);
      const int c = (v % (kNK / 8)) * 8;
      if (m0 + r < M) {
        copy8(as + r * kNALd + c, A + (long long)(m0 + r) * lda + k0 + c);
      } else {
        zero8(as + r * kNALd + c);
      }
    }
    for (int v = threadIdx.x; v < kNK * (kNN / 8); v += 128) {
      const int r = v / (kNN / 8);
      const int c = (v % (kNN / 8)) * 8;
      copy8(bs + r * kNBLd + c, B + (long long)(k0 + r) * ldb + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kNK; kk += 16) {
      FragA fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * kNALd + kk, kNALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kNBLd + wn + j * 16, kNBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* c = cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c + i * 16 * kNCs + j * 16, acc[i][j], kNCs,
                              wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 32 * 32; e += 32) {
    const int r = e / 32;
    const int cc = e % 32;
    const int gm = m0 + wm + r;
    if (gm >= M) continue;
    const long long off = (long long)gm * ldc + n0 + wn + cc;
    const float v = bf2f(f2bf(c[r * kNCs + cc]));
    switch (mode) {
      case kOutBf16: Cb[off] = f2bf(v); break;
      case kOutF32: Cf[off] = v; break;
      case kOutAddF32: Cf[off] += v; break;
      default: Cb[off] = f2bf(Cf[off] + v); break;
    }
  }
}

inline cudaError_t launch_gemm_nn(const bf16* A, int lda, const bf16* B, int ldb,
                                  bf16* Cb, float* Cf, int ldc, int M, int N, int K,
                                  int mode, cudaStream_t st) {
  if (N % kNN || K % kNK || lda % 8 || ldb % 8 || ldc % 8 || M < 1)
    return cudaErrorInvalidValue;
  dim3 grid(N / kNN, (M + kNM - 1) / kNM);
  gemm_nn_kernel<<<grid, 128, 0, st>>>(A, lda, B, ldb, Cb, Cf, ldc, M, N, K, mode);
  return cudaGetLastError();
}

// -------------------------------------------------------------- wgrad
// First pass of dW = A^T B over M rows: part[s, n, k] = sum over row chunk s
// of A[m, n] B[m, k], for A [M, N] (lda), B [M, K] (ldb), N, K % 64 == 0.
// With `cpart` set, the blocks of the first k tile also write the chunk's
// column sums of A, cpart[s, n] (a bias gradient, sum_m dY[m, n]).
constexpr int kWT = 64, kWM = 32, kWLd = kWT + 8, kWCs = 36;

__global__ void __launch_bounds__(128) wgrad_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    float* __restrict__ part, float* __restrict__ cpart, int M, int N, int K,
    int chunk) {
  __shared__ __align__(128) bf16 as[kWM * kWLd];
  __shared__ __align__(128) bf16 bs[kWM * kWLd];
  __shared__ __align__(128) float cs[4][32 * kWCs];
  const int k0 = blockIdx.x * kWT;
  const int n0 = blockIdx.y * kWT;
  const int s = blockIdx.z;
  const int mb = s * chunk;
  const int me = min(M, mb + chunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wn = (warp / 2) * 32;
  const int wk = (warp % 2) * 32;
  const bool colsum = cpart != nullptr && blockIdx.x == 0;
  float csum = 0.0f;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int m0 = mb; m0 < me; m0 += kWM) {
    for (int v = threadIdx.x; v < kWM * (kWT / 8); v += 128) {
      const int r = v / (kWT / 8);
      const int c = (v % (kWT / 8)) * 8;
      if (m0 + r < me) {
        copy8(as + r * kWLd + c, A + (long long)(m0 + r) * lda + n0 + c);
        copy8(bs + r * kWLd + c, B + (long long)(m0 + r) * ldb + k0 + c);
      } else {
        zero8(as + r * kWLd + c);
        zero8(bs + r * kWLd + c);
      }
    }
    __syncthreads();
    if (colsum && threadIdx.x < kWT) {
      for (int r = 0; r < kWM; ++r) csum += bf2f(as[r * kWLd + threadIdx.x]);
    }
#pragma unroll
    for (int kk = 0; kk < kWM; kk += 16) {
      FragACol fa[2];  // element (n, m) at as[m * ld + n]
      FragBRow fb[2];  // element (m, k) at bs[m * ld + k]
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + kk * kWLd + wn + i * 16, kWLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kWLd + wk + j * 16, kWLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* c = cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c + i * 16 * kWCs + j * 16, acc[i][j], kWCs,
                              wmma::mem_row_major);
  __syncwarp();
  float* out = part + (long long)s * N * K;
  for (int e = lane; e < 32 * 32; e += 32) {
    const int r = e / 32;
    const int cc = e % 32;
    out[(long long)(n0 + wn + r) * K + k0 + wk + cc] = c[r * kWCs + cc];
  }
  if (colsum && threadIdx.x < kWT) cpart[(long long)s * N + n0 + threadIdx.x] = csum;
}

// Second pass: out[i] = sum_{p < P} part[p * stride + i] for i < n, in p
// order, to f32 (outf) or bf16 (outb).
__global__ void __launch_bounds__(256) reduce_rows_kernel(
    const float* __restrict__ part, int P, long long stride, long long n,
    float* outf, bf16* outb) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += part[p * stride + i];
  if (outf) outf[i] = s;
  if (outb) outb[i] = f2bf(s);
}

inline cudaError_t launch_reduce(const float* part, int P, long long stride, long long n,
                                 float* outf, bf16* outb, cudaStream_t st) {
  reduce_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, P, stride, n,
                                                                  outf, outb);
  return cudaGetLastError();
}

// dW [N, K] bf16 (and optionally the column sums of A, f32 [N]) over M rows
// in `splits` chunks; part [splits, N, K] and cpart [splits, N] f32 scratch.
inline cudaError_t launch_wgrad(const bf16* A, int lda, const bf16* B, int ldb,
                                bf16* dw, float* dcol, float* part, float* cpart,
                                int M, int N, int K, int splits, cudaStream_t st) {
  if (N % kWT || K % kWT || lda % 8 || ldb % 8 || splits < 1) return cudaErrorInvalidValue;
  const int chunk = round_up((M + splits - 1) / splits, kWM);
  dim3 grid(K / kWT, N / kWT, splits);
  wgrad_kernel<<<grid, 128, 0, st>>>(A, lda, B, ldb, part, dcol ? cpart : nullptr, M, N,
                                     K, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce(part, splits, (long long)N * K, (long long)N * K, nullptr, dw, st);
  if (err != cudaSuccess || !dcol) return err;
  return launch_reduce(cpart, splits, N, N, dcol, nullptr, st);
}

}  // namespace crog
