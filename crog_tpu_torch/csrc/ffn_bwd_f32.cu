// K4b-f32: the decoder FFN's backward on fp32 operands, C interface for
// ctypes.
//
// Replaces crog_tpu/ops/pallas_ffn.py:226 `_fused_ffn_bwd_vjp` (pallas_call
// at :234, kernel `_bwd_kernel` :97) where the model computes in fp32: the
// Pallas kernel casts to x's dtype, which is then f32, so nothing is
// rounded.  Per row it recomputes the hidden (pallas_ffn.py:104-108) and
//   h   = drop(relu(x W1^T + b1))                 the forward's mask
//   hn  = LN(h) gamma + beta                       f32 statistics
//   dhn = dy W2
//   dh  = LN backward of dhn; dh = drop(dh); dh = dh * (h > 0)
//   dx  = dh W1
// with the column sums db1 = sum(dh), dgamma = sum(dhn hhat), dbeta =
// sum(dhn), db2 = sum(dy), all in f32.  dW1 = dh^T x and dW2 = dy^T hn
// stay outside, as the JAX package computes them outside the Pallas kernel
// (pallas_ffn.py:271-277): ops/ffn.py forms them with fp32 torch.mm, TF32
// off.  The twin is ops/ffn.py:ffn_bwd_plain.
//
// Bound on an H100 at the main path's M = 16224 rows (B=24, 676 tokens),
// D 512, F 2048 (ops/work.py, 3xTF32 at a third of TF32's 495 TFLOP/s):
// the recompute, dhn and dx are 102 GFLOP in the kernels, about 0.62 ms,
// bound by the products.
//
// Design: right and simple first, the hidden [M, F] through device memory
// (133 MB a buffer):
//   1. h = drop(relu(x W1^T + b1)) into hn    gemm_f32.cuh, the forward's
//                                              epilogue, so K4-f32's bits
//   2. dhn = dy W2 into dh                     grad_f32.cuh gemm_nn
//   3. ffn_ln_bwd: a row at a time, 256 threads of 8 columns (grad_f32.cuh
//      RowBlock), 64 rows per CTA: hn over h and dh over dhn in place, the
//      column partials of db1, dgamma, dbeta in registers; summed in order
//   4. dx = dh W1                              grad_f32.cuh gemm_nn
//   5. db2: fixed-order column sums of dy
#include "gemm_f32.cuh"
#include "grad_f32.cuh"

namespace crog {

constexpr int kFfnF = 2048;
constexpr int kFfnBwdRows = 64;  // rows per CTA of ffn_ln_bwd
using FfnRows = RowBlock<kFfnF>;

inline int ffn_ln_blocks(int rows) { return (rows + kFfnBwdRows - 1) / kFfnBwdRows; }

// h (in: the recomputed post-dropout hidden; out: hn) and d (in: dhn; out:
// dh) [rows, F]; part [blocks][3][F] of (db1, dgamma, dbeta)
__global__ void __launch_bounds__(FfnRows::kThreads) ffn_ln_bwd_f32_kernel(
    float* __restrict__ h, float* __restrict__ d, const float* __restrict__ gamma,
    const float* __restrict__ beta, Dropout drop, float* __restrict__ part, int rows) {
  __shared__ float red[2 * FfnRows::kWarps];
  float acc[3][8];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.0f;
  const int r0 = blockIdx.x * kFfnBwdRows, r1 = min(rows, r0 + kFfnBwdRows);
  for (int r = r0; r < r1; ++r) {
    float hv[8], hh[8], dn[8], dh[8];
    float* hrow = h + (long long)r * kFfnF;
    float* drow = d + (long long)r * kFfnF;
    rb_load<kFfnF>(hrow, hv);
#pragma unroll
    for (int e = 0; e < 8; ++e) hh[e] = hv[e];
    const float rstd = rb_xhat<kFfnF>(hh, red);
    rb_load<kFfnF>(drow, dn);
    rb_ln_dx<kFfnF>(dh, dn, hh, gamma, rstd, red);
    float hn[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = rb_col<kFfnF>(e);
      hn[e] = hh[e] * gamma[c] + beta[c];
      if (drop.thresh != 0u) dh[e] = dropout_keep(drop, r, c) ? dh[e] * drop.scale : 0.0f;
      dh[e] = hv[e] > 0.0f ? dh[e] : 0.0f;
      acc[0][e] += dh[e];
      acc[1][e] += dn[e] * hh[e];
      acc[2][e] += dn[e];
    }
    rb_store<kFfnF>(hrow, hn);
    rb_store<kFfnF>(drow, dh);
  }
  rb_store_parts<kFfnF, 3>(acc, part);
}

}  // namespace crog

// table: x [M, D], w1 [F, D], b1 [F], gamma [F], beta [F], w2 [D, F],
// dy [M, D]; outputs dx [M, D], dh [M, F], hn [M, F], rows [3, F] (db1,
// dgamma, dbeta), db2 [D]; work: part [max(ceil(M/64) 3F, ceil(M/256) D)].
extern "C" int crog_ffn_f32_bwd(const void* const* table, int m, int d, int f, unsigned seed,
                                unsigned thresh, float scale, void* stream) {
  using namespace crog;
  if (f != kFfnF || d < kGF32K || d % kGF32K || m < 1) return (int)cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(table[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(table[i])); };
  const float *x = in(0), *w1 = in(1), *b1 = in(2), *gamma = in(3), *beta = in(4), *w2 = in(5),
              *dy = in(6);
  float *dx = out(7), *dh = out(8), *hn = out(9), *rows = out(10), *db2 = out(11),
        *part = out(12);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmF32 g1{x, w1, b1, hn, d, d, f, m, f, d, Dropout{seed, thresh, scale}};
  cudaError_t err = launch_gemm_f32<kEpiReluDropout, kProdRecompute>(g1, s);
  if (err == cudaSuccess) err = gemm_nn_f32<kProdDHn>(dy, d, w2, f, dh, f, m, f, d, s);
  if (err != cudaSuccess) return (int)err;
  const int nb = ffn_ln_blocks(m);
  ffn_ln_bwd_f32_kernel<<<nb, FfnRows::kThreads, 0, s>>>(hn, dh, gamma, beta,
                                                         Dropout{seed, thresh, scale}, part, m);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = reduce_parts(part, nb, 3 * f, 3 * f, rows, s);
  if (err == cudaSuccess) err = gemm_nn_f32<kProdDx>(dh, f, w1, d, dx, d, m, d, f, s);
  if (err == cudaSuccess) err = colsum_f32(dy, d, m, d, part, db2, s);
  return (int)err;
}
