// f32 products on the tensor cores: TF32 with the 3xTF32 split, on
// mma.sync m16n8k8 in K5/K5b (lincomb.cu), and on wgmma in the fp32
// attention forward and backward (attention_f32.cuh,
// attention_bwd_f32.cuh) and gemm_wgmma_f32.cuh (the products of K2-f32,
// K3-f32, K4-f32, K6-f32 and of their backward kernels).
//
// A TF32 value keeps 10 explicit mantissa bits.  x = hi + lo with hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) keeps about 21 of f32's 23;
// a b ~ hi*hi + hi*lo + lo*hi (the dropped lo*lo is below 2^-21 of the
// product), each product exact in the f32 accumulator, so a sum of such
// products is as accurate as an f32 FMA loop.  One TF32 pass alone rounds
// every operand to 2^-11 relative: a different result from the fp32 the
// JAX package computes.
//
// Fragment layouts of mma.m16n8k8.row.col .tf32 (g = lane / 4, t = lane % 4):
//   A 16x8: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8:  b0 (k t, n g), b1 (k t+4, n g)
//   C 16x8: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace crog {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32, lo the rounding error of hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in f32 accuracy: the small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// How an fp32 kernel forms a product.  k3xTF32 is the kernels' arithmetic.
// The other two exist only in a fault-check build, which shows that a
// tolerance sees a kernel that lost f32 accuracy: one TF32 pass, or both
// operands rounded to bf16 first (bf16 staging; a bf16 value is a TF32
// value, and a product of two is exact in f32).
enum Products : int { k3xTF32 = 0, k1xTF32 = 1, kBf16Staged = 2 };

// The products of the fp32 forward and backward kernels.
enum F32Product : int {
  kProdProj = 0,    // K2/K3-f32: the q/k/v projections
  kProdScores = 1,  // K1/K2/K3-f32: QK^T
  kProdPV = 2,      // K1/K2/K3-f32: P.V
  kProdOut = 3,     // K2/K3-f32: the out-projection
  kProdHidden = 4,  // K4-f32: x W1^T (gemm_wgmma_f32.cuh, as K4b-f32's)
  kProdY = 5,       // K4-f32: hn W2^T
  kProdBwdScores = 6,  // K1b/K2b/K3b-f32: QK^T again
  kProdDV = 7,         // K1b/K2b/K3b-f32: dV = P^T dO
  kProdDP = 8,         // K1b/K2b/K3b-f32: dP = dO V^T
  kProdDQ = 9,         // K1b/K2b/K3b-f32: dQ = dS K
  kProdDK = 10,        // K1b/K2b/K3b-f32: dK = dS^T Q
  kProdDO = 11,        // K2b/K3b-f32: dO = dOP W_out
  kProdDX = 12,        // K2b/K3b-f32: dXL = dQ Wq + dK Wk + dV Wv (K3b: and d(txt))
  kProdDW = 13,        // K2b/K3b-f32: dW = dY^T X of the four projections
  kProdRecompute = 14, // K4b-f32: x W1^T again
  kProdDHn = 15,       // K4b-f32: dhn = dy W2
  kProdDx = 16,        // K4b-f32: dx = dh W1
  kProdS2dConv = 17,   // K6-f32: the gathered patch times the packed weight
  kProdS2dWgrad = 18,  // K6b-f32: patch^T dy
  kProdDW1 = 19,       // K4b-f32: dW1 = dh^T x
  kProdDW2 = 20,       // K4b-f32: dW2 = dy^T hn
};

// A fault-check build (tools/torch_fp32_faults.py) compiles with
// -DCROG_F32_FAULT_PRODUCT=<F32Product> -DCROG_F32_FAULT_MODE=<Products>,
// and that one product loses f32 accuracy.  The port's builds define
// neither, and every product is 3xTF32.
#ifndef CROG_F32_FAULT_PRODUCT
#define CROG_F32_FAULT_PRODUCT -1
#define CROG_F32_FAULT_MODE k3xTF32
#endif

// how the fp32 kernels form product `product` (an F32Product)
constexpr int products_of(int product) {
  return product == CROG_F32_FAULT_PRODUCT ? CROG_F32_FAULT_MODE : k3xTF32;
}

template <int P>
__device__ __forceinline__ void split_p(float x, uint32_t& hi, uint32_t& lo) {
  if (P == k3xTF32) {
    split_tf32(x, hi, lo);
  } else if (P == k1xTF32) {
    hi = to_tf32(x);
    lo = 0u;
  } else {
    hi = __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
    lo = 0u;
  }
}

}  // namespace crog
