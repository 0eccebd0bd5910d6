// Softmax attention with exact (two-pass) softmax, for head dim 64.
//
// Replaces the forward Pallas kernel `_fused_fwd` of
// crog_tpu/ops/pallas_attention.py:104 (pallas_call at :111) and the
// all-head attention `_mha_fwd` inside the decoder block kernels
// (crog_tpu/ops/pallas_decoder.py:99).
//
// What it computes, per (batch, head):
//   s = (q k^T) * scale + mask[key]      (keys >= Lk score -1e30)
//   p = bf16( exp(s - max) / sum )       (normalized, then rounded, as the
//                                         TPU kernel rounds p before P.V)
//   o = bf16( p v )                      (f32 accumulation)
// q/k/v/o are [B, L, H*64] with a free row and batch stride, so q and k can
// be column slices of one packed projection.
//
// Bound on an H100 (CLIP attention pool, B=24, 32 heads, L=169): 5.6 GFLOP
// against 66 MB of q/k/v/o, so it is limited by memory, about 20 us.
//
// Design: one block of 4 warps takes 64 query rows of one head.  The whole
// score row block [64, Lk] stays in shared memory (Lk <= 768), which makes
// the softmax exact instead of online: each q/k/v tile is read from device
// memory once per block, and the probabilities never leave the SM.  The
// bf16 probabilities overwrite the first half of their own float score row,
// so no second buffer is needed.  Products run on the tensor cores (WMMA).
#pragma once

#include "common.cuh"

namespace crog {

constexpr int kAttnBQ = 64;   // query rows per block
constexpr int kAttnBK = 64;   // key rows per tile
constexpr int kAttnDH = 64;   // head dim
constexpr int kAttnLdT = kAttnDH + 8;  // bf16 tile row stride (pads banks)
constexpr int kAttnMaxLk = 768;

__host__ __device__ inline int attn_score_ld(int lk) {
  return round_up(lk, kAttnBK) + 8;
}

__host__ __device__ inline size_t attn_smem_bytes(int lk) {
  return 2 * kAttnBQ * kAttnLdT * sizeof(bf16) +
         (size_t)kAttnBQ * attn_score_ld(lk) * sizeof(float);
}

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;  // [B, Lk] additive, or nullptr
  bf16* o;
  int heads, lq, lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // in elements
  float scale;
};

// load rows [r0, r0+64) of a [L, 64] head slice into a [64, kAttnLdT] tile,
// zero-filling rows >= L
__device__ __forceinline__ void attn_load_tile(bf16* tile, const bf16* base,
                                               long long rs, int r0, int L) {
  for (int v = threadIdx.x; v < kAttnBK * (kAttnDH / 8); v += blockDim.x) {
    int r = v / (kAttnDH / 8);
    int c = (v % (kAttnDH / 8)) * 8;
    if (r0 + r < L) {
      copy8(tile + r * kAttnLdT + c, base + (long long)(r0 + r) * rs + c);
    } else {
      zero8(tile + r * kAttnLdT + c);
    }
  }
}

__global__ void __launch_bounds__(128) attention_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = qs + kAttnBQ * kAttnLdT;
  float* sc = reinterpret_cast<float*>(kvs + kAttnBQ * kAttnLdT);

  const int lkp = round_up(a.lk, kAttnBK);
  const int ls = lkp + 8;  // float row stride of the score block
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kAttnBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const bf16* qb = a.q + b * a.q_bs + h * kAttnDH;
  const bf16* kb = a.k + b * a.k_bs + h * kAttnDH;
  const bf16* vb = a.v + b * a.v_bs + h * kAttnDH;

  attn_load_tile(qs, qb, a.q_rs, q0, a.lq);
  __syncthreads();

  // ---- scores: S[64, lkp] = Q K^T, raw f32 sums
  FragA fq[kAttnDH / 16];
#pragma unroll
  for (int kk = 0; kk < kAttnDH / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], qs + r0 * kAttnLdT + kk * 16, kAttnLdT);
  for (int kt = 0; kt < lkp; kt += kAttnBK) {
    attn_load_tile(kvs, kb, a.k_rs, kt, a.lk);
    __syncthreads();
    FragC acc[kAttnBK / 16];
#pragma unroll
    for (int j = 0; j < kAttnBK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kAttnDH / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kAttnBK / 16; ++j) {
        FragBCol fk;  // element (d, key) at kvs[key * ld + d]
        wmma::load_matrix_sync(fk, kvs + (j * 16) * kAttnLdT + kk * 16, kAttnLdT);
        wmma::mma_sync(acc[j], fq[kk], fk, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kAttnBK / 16; ++j)
      wmma::store_matrix_sync(sc + r0 * ls + kt + j * 16, acc[j], ls,
                              wmma::mem_row_major);
    __syncthreads();
  }

  // ---- exact softmax over each of this warp's 16 rows
  const float* mrow = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  for (int r = 0; r < 16; ++r) {
    float* srow = sc + (r0 + r) * ls;
    float m = -3.0e38f;
    for (int c = lane; c < lkp; c += 32) {
      float s = kNeg;
      if (c < a.lk) {
        s = srow[c] * a.scale;
        if (mrow) s += mrow[c];
      }
      srow[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < lkp; c += 32) {
      // padded columns weigh exactly 0, so an all-masked row averages
      // over the Lk real keys only
      float e = c < a.lk ? expf(srow[c] - m) : 0.0f;
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    __syncwarp();
    // bf16 probabilities into the first half of the same row: the write of
    // column c lands in float c/2, which no lane still has to read once
    // every lane of this step has read its own column
    bf16* prow = reinterpret_cast<bf16*>(srow);
    for (int c = lane; c < lkp; c += 32) {
      float p = srow[c] / l;
      __syncwarp();
      prow[c] = f2bf(p);
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- O[64, 64] = P V
  FragC oacc[kAttnDH / 16];
#pragma unroll
  for (int j = 0; j < kAttnDH / 16; ++j) wmma::fill_fragment(oacc[j], 0.0f);
  const bf16* pw = reinterpret_cast<const bf16*>(sc + r0 * ls);
  for (int kt = 0; kt < lkp; kt += kAttnBK) {
    attn_load_tile(kvs, vb, a.v_rs, kt, a.lk);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kAttnBK / 16; ++kk) {
      FragA fp;
      wmma::load_matrix_sync(fp, pw + kt + kk * 16, 2 * ls);
#pragma unroll
      for (int j = 0; j < kAttnDH / 16; ++j) {
        FragBRow fv;  // element (key, d) at kvs[key * ld + d]
        wmma::load_matrix_sync(fv, kvs + (kk * 16) * kAttnLdT + j * 16, kAttnLdT);
        wmma::mma_sync(oacc[j], fp, fv, oacc[j]);
      }
    }
    __syncthreads();
  }

  // ---- stage this warp's 16 x 64 output over its own score rows, store
  float* ostage = sc + r0 * ls;
#pragma unroll
  for (int j = 0; j < kAttnDH / 16; ++j)
    wmma::store_matrix_sync(ostage + j * 16, oacc[j], ls, wmma::mem_row_major);
  __syncwarp();
  bf16* ob = a.o + b * a.o_bs + h * kAttnDH;
  for (int e = lane; e < 16 * kAttnDH; e += 32) {
    int r = e / kAttnDH;
    int c = e % kAttnDH;
    int row = q0 + r0 + r;
    if (row < a.lq) ob[(long long)row * a.o_rs + c] = f2bf(ostage[r * ls + c]);
  }
}

inline cudaError_t launch_attention(const AttnArgs& a, int batch,
                                    cudaStream_t stream) {
  if (a.lk > kAttnMaxLk || a.lk < 1 || a.lq < 1) return cudaErrorInvalidValue;
  size_t smem = attn_smem_bytes(a.lk);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + kAttnBQ - 1) / kAttnBQ, batch * a.heads);
  attention_kernel<<<grid, 128, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace crog
