// K4b-f32: the decoder FFN's backward on fp32 operands, C interface for
// ctypes.
//
// Replaces crog_tpu/ops/pallas_ffn.py:226 `_fused_ffn_bwd_vjp` (pallas_call
// at :234, kernel `_bwd_kernel` :97, and the dW einsums :271-277) where the
// model computes in fp32: the Pallas kernel casts to x's dtype, which is
// then f32, so nothing is rounded.  Per row it recomputes the hidden
// (pallas_ffn.py:104-108) and
//   h   = drop(relu(x W1^T + b1))                 the forward's mask
//   hn  = LN(h) gamma + beta                       f32 statistics
//   dhn = dy W2
//   dh  = LN backward of dhn; dh = drop(dh); dh = dh * (h > 0)
//   dx  = dh W1
//   dW1 = dh^T x,  dW2 = dy^T hn
// with the column sums db1 = sum(dh), dgamma = sum(dhn hhat), dbeta =
// sum(dhn), db2 = sum(dy), all in f32.  The JAX package forms dW1 and dW2
// outside its Pallas kernel; here they are kernel products too.  The twin
// is ops/ffn.py:ffn_bwd_plain.
//
// Bound on an H100 at the main path's M = 16224 rows (B=24, 676 tokens),
// D 512, F 2048 (ops/work.py, 3xTF32 at a third of TF32's 495 TFLOP/s):
// the recompute, dhn, dx, dW1 and dW2 are 170 GFLOP, about 1.03 ms, bound
// by the products.  D is any of decoder_width_ok's 256, 512, 768 or 1024;
// only F is fixed (the LayerNorm rows below are 2048 wide).
//
// Design: every product on gemm_wgmma_f32.cuh (wgmma .tf32, A split in
// registers; a weight split once per call into TF32 hi and lo planes that
// TMA brings into shared memory, dW's B, the batch, split once per tile in
// shared memory), the hidden [M, F] through device memory (133 MB a
// buffer):
//   1. h = drop(relu(x W1^T + b1)) into hn    ffn_hidden_f32: K4-f32's own
//                                              kernels, so its bits
//   2. dhn = dy W2 into dh                     W2's planes transposed
//   3. ffn_ln_bwd: a row at a time, 256 threads of 8 columns (grad_f32.cuh
//      RowBlock), 64 rows per CTA: hn over h and dh over dhn in place, the
//      row statistics summed in K4-f32's order (so hn is K4-f32's, bit for
//      bit), the column partials of db1, dgamma, dbeta in registers; summed
//      in order
//   4. dx = dh W1                              W1's planes transposed
//   5. db2: fixed-order column sums of dy
//   6. dW1 = dh^T x, dW2^T = hn^T dy           A read transposed, B (x, dy:
//      D wide) split once into planes; over row chunks of at most
//      kGwChunkRows, the chunks' partials summed in order (dW2's into its
//      transpose)
#include "gemm_wgmma_f32.cuh"
#include "grad_f32.cuh"
#include "ln_f32.cuh"

namespace crog {

constexpr int kFfnF = 2048;
constexpr int kFfnBwdRows = 64;  // rows per CTA of ffn_ln_bwd
using FfnRows = RowBlock<kFfnF>;

inline int ffn_ln_blocks(int rows) { return (rows + kFfnBwdRows - 1) / kFfnBwdRows; }

// x-hat of the row in v (in place) and its rstd, with the statistics of
// ln_f32.cuh's ln_stats: there lane l of a warp adds its float4 groups l +
// 32 i, i = 0..15, each as (x + y) + (z + w), then the lanes' sums meet in
// a butterfly.  Here thread i holds groups i and 256 + i (rb_load), so
// lane l's groups are the first groups of threads l, l + 32, ..., then
// their second groups, exchanged through `stat` [4][256].
__device__ __forceinline__ float ffn_row_xhat(float (&v)[8], float* stat) {
  const int tid = threadIdx.x, lane = tid & 31;
  stat[tid] = (v[0] + v[1]) + (v[2] + v[3]);
  stat[256 + tid] = (v[4] + v[5]) + (v[6] + v[7]);
  stat[512 + tid] = (v[0] * v[0] + v[1] * v[1]) + (v[2] * v[2] + v[3] * v[3]);
  stat[768 + tid] = (v[4] * v[4] + v[5] * v[5]) + (v[6] * v[6] + v[7] * v[7]);
  __syncthreads();
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += stat[256 * h + lane + 32 * i];
      s2 += stat[512 + 256 * h + lane + 32 * i];
    }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / kFfnF;
  const float rstd = rsqrtf(fmaxf(s2 / kFfnF - mu * mu, 0.0f) + kLnEps);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rstd;
  return rstd;
}

// h (in: the recomputed post-dropout hidden; out: hn) and d (in: dhn; out:
// dh) [rows, F]; part [blocks][3][F] of (db1, dgamma, dbeta)
__global__ void __launch_bounds__(FfnRows::kThreads) ffn_ln_bwd_f32_kernel(
    float* __restrict__ h, float* __restrict__ d, const float* __restrict__ gamma,
    const float* __restrict__ beta, Dropout drop, float* __restrict__ part, int rows) {
  __shared__ float red[2 * FfnRows::kWarps];
  __shared__ float stat[4 * FfnRows::kThreads];
  float acc[3][8];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.0f;
  const int r0 = blockIdx.x * kFfnBwdRows, r1 = min(rows, r0 + kFfnBwdRows);
  // row r's h and dhn, loaded while row r - 1's sums run
  float hv[8], dn[8];
  if (r0 < r1) {
    rb_load<kFfnF>(h + (long long)r0 * kFfnF, hv);
    rb_load<kFfnF>(d + (long long)r0 * kFfnF, dn);
  }
  for (int r = r0; r < r1; ++r) {
    float hh[8], dh[8], hv1[8], dn1[8];
    float* hrow = h + (long long)r * kFfnF;
    float* drow = d + (long long)r * kFfnF;
    if (r + 1 < r1) {
      rb_load<kFfnF>(hrow + kFfnF, hv1);
      rb_load<kFfnF>(drow + kFfnF, dn1);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) hh[e] = hv[e];
    const float rstd = ffn_row_xhat(hh, stat);
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
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      hv[e] = hv1[e];
      dn[e] = dn1[e];
    }
  }
  rb_store_parts<kFfnF, 3>(acc, part);
}

// The partials of C [m, n] = A^T B over the k batch rows, A [k, m] (row
// stride lda) and B [k, n] (row stride n) row-major: B split once into its
// planes (`planes`, 2 n gw_planes_ld(k) floats), then one partial per row
// chunk of gw_dw_chunk(k) into part [chunks, m, n]
template <int PRODUCT>
static cudaError_t ffn_dw_parts(const float* a, long long lda, const float* b, float* planes,
                                float* part, int m, int n, int k, cudaStream_t s) {
  cudaError_t err = gw_split_b_planes<true, PRODUCT>(b, planes, n, k, s);
  if (err != cudaSuccess) return err;
  const GemmWgF32 p{a, planes, part, nullptr, lda, gw_planes_ld(k), n, (long long)m * n, m, n, k,
                    gw_dw_chunk(k), Dropout{0u, 0u, 1.0f}};
  return gemm_wgmma_f32<true, kGwStore, PRODUCT>(p, s);
}

// out [cols, rows] = the transpose of the sum of `parts` partials [rows,
// cols] (rows, cols multiples of 32), added in partial order as
// reduce_parts adds them, through a 32 x 32 tile in shared memory
__global__ void __launch_bounds__(256) reduce_parts_t_kernel(const float* __restrict__ part,
                                                             int parts, int rows, int cols,
                                                             float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const long long stride = (long long)rows * cols;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = ty + 8 * j;
    const float* src = part + (long long)(r0 + r) * cols + c0 + tx;
    float s = 0.0f;
    for (int q = 0; q < parts; ++q) s += src[q * stride];
    tile[r][tx] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = ty + 8 * j;
    out[(long long)(c0 + c) * rows + r0 + tx] = tile[tx][c];
  }
}

}  // namespace crog

// table: x [M, D], w1 [F, D], b1 [F], gamma [F], beta [F], w2 [D, F],
// dy [M, D]; outputs dx [M, D], dh [M, F], hn [M, F], rows [3, F] (db1,
// dgamma, dbeta), db2 [D], dw1 [F, D], dw2 [D, F]; work (ops/ffn.py
// f32_bwd_work): part (the LN and db2 column partials, dW's chunk
// partials) and planes (the TF32 hi and lo planes of W1, W2^T and W1^T,
// then of x and dy).
extern "C" int crog_ffn_f32_bwd(const void* const* table, int m, int d, int f, unsigned seed,
                                unsigned thresh, float scale, void* stream) {
  using namespace crog;
  if (f != kFfnF || !decoder_width_ok(d) || m < 1) return (int)cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(table[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(table[i])); };
  const float *x = in(0), *w1 = in(1), *b1 = in(2), *gamma = in(3), *beta = in(4), *w2 = in(5),
              *dy = in(6);
  float *dx = out(7), *dh = out(8), *hn = out(9), *rows = out(10), *db2 = out(11),
        *dw1 = out(12), *dw2 = out(13), *part = out(14), *planes = out(15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, thresh, scale}, none{0u, 0u, 1.0f};
  const long long fd = (long long)f * d;

  cudaError_t err = ffn_hidden_f32<kProdRecompute>(x, w1, b1, hn, planes, m, d, f, drop, s);
  if (err == cudaSuccess)
    err = gw_weight_gemm<true, kGwStore, kProdDHn>(dy, d, w2, planes + 2 * fd, dh, f, nullptr, m,
                                                   f, d, none, s);
  if (err != cudaSuccess) return (int)err;
  const int nb = ffn_ln_blocks(m);
  ffn_ln_bwd_f32_kernel<<<nb, FfnRows::kThreads, 0, s>>>(hn, dh, gamma, beta, drop, part, m);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = reduce_parts(part, nb, 3 * f, 3 * f, rows, s);
  if (err == cudaSuccess)
    err = gw_weight_gemm<true, kGwStore, kProdDx>(dh, f, w1, planes + 4 * fd, dx, d, nullptr, m,
                                                  d, f, none, s);
  if (err == cudaSuccess) err = colsum_f32(dy, d, m, d, part, db2, s);
  // dW1 = dh^T x, and dW2 = (hn^T dy)^T: both take their B, x and dy,
  // [M, D] as the split planes
  const int chunks = (m + gw_dw_chunk(m) - 1) / gw_dw_chunk(m);
  if (err == cudaSuccess) err = ffn_dw_parts<kProdDW1>(dh, f, x, planes, part, f, d, m, s);
  if (err == cudaSuccess) err = reduce_parts(part, chunks, fd, fd, dw1, s);
  if (err == cudaSuccess) err = ffn_dw_parts<kProdDW2>(hn, f, dy, planes, part, f, d, m, s);
  if (err == cudaSuccess) {
    reduce_parts_t_kernel<<<dim3(d / 32, f / 32), 256, 0, s>>>(part, chunks, f, d, dw2);
    err = cudaGetLastError();
  }
  return (int)err;
}
