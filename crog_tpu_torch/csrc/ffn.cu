// K4: the CROG decoder FFN, forward: a cluster kernel for the hidden and a
// GEMM kernel for the output.
//
// Replaces crog_tpu/ops/pallas_ffn.py:190 `_fused_ffn_fwd` (pallas_call at
// :197, kernel `_fwd_kernel` :78, under `fused_ffn` :176):
//
//   h  = bf16(x W1^T + b1);  h = drop(relu(h))   (counter-based mask, common.cuh)
//   hn = bf16(LN(h))         f32 statistics, flax fast variance
//   y  = bf16(hn W2^T + b2)
//
// for x [M, D] bf16, W1 [2048, D], W2 [D, 2048] (torch Linear layout), D any
// of decoder_width_ok's 256, 512, 768 or 1024.
//
// Bound on an H100 at B=24 (M = 24*676 = 16224): 68.0 GFLOP over 37 MB,
// about 69 us, limited by the tensor cores; with hn written and read back
// (2 x 66 MB) about 0.11 ms.  At D 1024: 136.1 GFLOP, 0.138 ms.
//
// Design.  The LayerNorm needs each row's statistics over all 2048 hidden
// columns before any hn, and a [128, 2048] bf16 hidden does not fit one SM,
// so the hidden is K4b's (ffn.cuh, the code K4b's recompute runs):
//   ffn_fwd_hidden_kernel: a thread-block cluster of 8 CTAs takes 128 rows,
//     CTA r hidden columns [256 r, 256 r + 256): the [128 x 256 x D]
//     product on wgmma m64n128k16 fed by gemm.cuh's 4-stage cp.async ring
//     (W1 passed transposed, so B is row-major along the hidden), bias,
//     bf16, ReLU and dropout on the accumulators, h in shared memory, the LN
//     row partials across the cluster through distributed shared memory
//     (added in rank order), hn = bf16(LN(h)) out as 16-byte rows.  Every
//     128 rows stream W1 once per cluster.  DROP is a compile-time switch,
//     so eval runs no mask code.
//   ffn_out_kernel (ffn.cuh, also K4b's dx): y = bf16(hn W2^T + b2), a
//     [128 x 256] tile per CTA over the hn the first kernel wrote (K =
//     2048), W2 passed transposed, the bias added on the accumulators before
//     the one rounding.
// hn makes one round trip through device memory (66 MB each way), the price
// of the split: a tile's y needs all 2048 columns of its hn, which lie on 8
// SMs.
#include "ffn.cuh"

namespace crog {

constexpr size_t kFfnFwdSmem =
    1024 + kBRingBytes + kHHBytes + (size_t)(kHRedF + kHXchF + kHRowF) * sizeof(float);

template <bool DROP>
__global__ void __launch_bounds__(kGThreads, 1) ffn_fwd_hidden_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ be, bf16* __restrict__ hn_out, int M,
    int D, Dropout drop) {
  unsigned char* ring = gemm_smem_base();
  bf16* hs = reinterpret_cast<bf16*>(ring + kBRingBytes);  // h: [128][kBHLd]
  float* red = reinterpret_cast<float*>(ring + kBRingBytes + kHHBytes);
  float* xch = red + kHRedF;
  float* rowst = xch + kHXchF;
  const int m0 = (blockIdx.x / kBCl) * kBM;
  const int n0 = (int)cluster_rank() * kBN;
  float acc[kBNT][4];
  uint32_t keep[2] = {0u, 0u};
  ffn_hidden<DROP>(acc, keep, x, w1t, b1, m0, M, D, n0, drop, ring, hs, red, xch, rowst);
  cluster_arrive();  // this CTA is done reading its peers' shared memory
  ffn_write_hn(hs, rowst, g, be, hn_out, m0, M, n0);
  cluster_wait();  // no CTA leaves while a peer may still read its exchange
}

// the cluster kernels' dynamic shared memory limits, set once per library
// and card
static cudaError_t ffn_fwd_set_smem_once() {
  static const cudaError_t attr = [] {
    const cudaError_t e =
        cudaFuncSetAttribute(ffn_fwd_hidden_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFfnFwdSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ffn_fwd_hidden_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFfnFwdSmem);
  }();
  return attr;
}

}  // namespace crog

// t: table of device pointers, in order
//   0 x [M, D] bf16, 1 w1t [D, 2048] bf16 (W1 transposed), 2 b1,
//   3 gamma, 4 beta [2048] f32, 5 w2t [2048, D] bf16 (W2 transposed),
//   6 b2 [D] f32; output 7 y [M, D] bf16; workspace 8 hn [M, 2048] bf16.
// `tiles` row tiles of 128 (ops/ffn.py:fwd_schedule), one cluster each, and
// the y GEMM over the same tiles.  Dropout on the hidden with (seed,
// thresh, scale); thresh 0 is eval.
extern "C" int crog_ffn_fwd(void* const* t, int M, int D, int F, int tiles, unsigned seed,
                            unsigned thresh, float scale, void* stream) {
  using crog::bf16;
  if (!crog::decoder_width_ok(D) || F != crog::kBF || M < 1 ||
      tiles != (M + crog::kBM - 1) / crog::kBM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = crog::ffn_fwd_set_smem_once();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = crog::ffn_cluster_config(tiles, crog::kFfnFwdSmem, &attr, st);
  auto kernel = thresh ? crog::ffn_fwd_hidden_kernel<true> : crog::ffn_fwd_hidden_kernel<false>;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(t[0]),
                           static_cast<const bf16*>(t[1]), static_cast<const float*>(t[2]),
                           static_cast<const float*>(t[3]), static_cast<const float*>(t[4]),
                           static_cast<bf16*>(t[8]), M, D, crog::Dropout{seed, thresh, scale});
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)crog::launch_ffn_out(static_cast<const bf16*>(t[8]),
                                   static_cast<const bf16*>(t[5]),
                                   static_cast<const float*>(t[6]), static_cast<bf16*>(t[7]),
                                   M, D, tiles, st);
}

// out[8]: the cluster kernel's (train variant) registers per thread, shared
// memory per CTA (static + dynamic), spill bytes per thread and clusters
// resident at once; then the y GEMM's registers, shared memory, spills and
// CTAs per SM
extern "C" int crog_ffn_fwd_attrs(void* out_) {
  int* out = static_cast<int*>(out_);
  cudaError_t err = crog::ffn_fwd_set_smem_once();
  if (err != cudaSuccess) return (int)err;
  err = crog::ffn_cluster_attrs(crog::ffn_fwd_hidden_kernel<true>, crog::kFfnFwdSmem, out);
  if (err != cudaSuccess) return (int)err;
  return (int)crog::ffn_out_attrs(out + 4);
}
