// K4-f32: the decoder FFN's forward on fp32 operands,
//   y = LN(drop(relu(x W1^T + b1))) W2^T + b2,
// all in f32 (3xTF32 products), C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_ffn.py:176 `fused_ffn`'s forward
// `_fused_ffn_fwd` (pallas_call at :197) where the model computes in fp32:
// the Pallas kernel casts its hidden to x's dtype, which is then f32, so
// nothing is rounded to bf16.  The twin is ops/ffn.py:ffn_plain.
//
// Bound on an H100: at the main path's M = 16224 rows (B=24, 676 tokens),
// D 512, F 2048: 68 GFLOP, about 0.41 ms at 3xTF32's third of TF32's 495
// TFLOP/s; x and y are 66 MB (20 us), so operations bound it.  D is any of
// decoder_width_ok's 256, 512, 768 or 1024 (136 GFLOP at 1024).
//
// Design: both products on gemm_wgmma_f32.cuh (wgmma .tf32, A split in
// registers, W1 and W2 split once per call into TF32 hi and lo planes that
// TMA brings into shared memory).  The bf16 kernel keeps a 128 x 2048 row
// block of the hidden in the shared memory of an 8-CTA cluster; in f32
// that block is twice the size, so here the hidden h [M, F] goes through
// device memory (133 MB at the main path: about 80 us of traffic each way):
//   1. h = drop(relu(x W1^T + b1))   ffn_hidden_f32: ReLU and dropout in
//                                   the epilogue (dropout over (row, hidden
//                                   column), ops/dropout.py's mask); K4b-f32
//                                   recomputes h with the same kernels
//   2. h = LN(h) * gamma + beta      ln_f32.cuh, in place, one warp a row
//   3. y = h W2^T + b2               gw_weight_gemm, bias in the epilogue
// W1 [F, D] and W2 [D, F] are read as torch stores them (K-major B).
#include "gemm_wgmma_f32.cuh"
#include "ln_f32.cuh"

// table: x [M, D], w1 [F, D], b1 [F], gamma [F], beta [F], w2 [D, F],
// b2 [D], y [M, D], h [M, F] (work; hn when the call returns), planes [4 F
// D] (work: W1's and W2's TF32 hi and lo planes).
extern "C" int crog_ffn_f32_fwd(const void* const* table, int m, int d, int f,
                                unsigned seed, unsigned thresh, float scale, void* stream) {
  using namespace crog;
  if (f != 2048 || !decoder_width_ok(d) || m < 1) return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(table[0]);
  const float* w1 = static_cast<const float*>(table[1]);
  const float* b1 = static_cast<const float*>(table[2]);
  const float* gamma = static_cast<const float*>(table[3]);
  const float* beta = static_cast<const float*>(table[4]);
  const float* w2 = static_cast<const float*>(table[5]);
  const float* b2 = static_cast<const float*>(table[6]);
  float* y = static_cast<float*>(const_cast<void*>(table[7]));
  float* h = static_cast<float*>(const_cast<void*>(table[8]));
  float* planes = static_cast<float*>(const_cast<void*>(table[9]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long fd = (long long)f * d;

  cudaError_t err = ffn_hidden_f32<kProdHidden>(x, w1, b1, h, planes, m, d, f,
                                                Dropout{seed, thresh, scale}, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_ln_rows_f32<2048>(h, gamma, beta, m, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gw_weight_gemm<false, kGwBias, kProdY>(h, f, w2, planes + 2 * fd, y, d, b2, m, d,
                                                     f, Dropout{0u, 0u, 1.0f}, s);
}
