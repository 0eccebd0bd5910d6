// Softmax attention on fp32 operands, head dim 64: the fp32 build of the
// attention forward (K1-f32, and the attention step of K2-f32 / K3-f32).
//
// Replaces crog_tpu/ops/pallas_attention.py:104 `_fused_fwd` (pallas_call
// at :111) and the attention `_mha_fwd` inside the decoder block kernels
// (crog_tpu/ops/pallas_decoder.py:99) where the model computes in fp32
// (`compute_dtype: float32`): the Pallas kernels work in f32 and cast to the
// operands' dtype, which is then f32, so nothing is rounded to bf16.
//
// What it computes, per (batch, head):
//   s = (q k^T) * scale + mask[key]     (keys >= Lk weigh exactly 0, so an
//                                        all-masked row averages over the Lk
//                                        real keys, as the twin's does)
//   o = softmax(s) v                    (all in f32)
//   lse = logsumexp(s) over the keys     (K1-f32 only, for K1b-f32)
// q/k/v/o are [B, L, H*64] f32 with a free row and batch stride (multiples
// of 4 floats), so q and k can be column slices of one packed projection;
// 1 <= Lk <= 768, Lq free.  The twin is ops/attention.py:attention_plain.
//
// Bound on an H100 (ops/work.py, 3xTF32 at a third of TF32's 495 TFLOP/s):
// the CLIP attention pool (B=24, 32 heads, L=169) is 5.6 GFLOP against 133
// MB of q/k/v/o, about 40 us, limited by memory; the decoder's self
// attention (B=24, 8 heads, L=676) 22.5 GFLOP, about 136 us, limited by
// the products.
//
// Design: right and simple first.  One CTA of 4 warps takes 64 query rows
// of one head, 16 per warp, and streams the head's keys in tiles of 64
// through a two-stage cp.async ring (K and V tiles, rows padded to 68
// floats so that every fragment load below is free of bank conflicts).
// Every product is mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32.cuh),
// so it keeps f32 accuracy; the Q fragments are split once and stay in
// registers.  Unlike the bf16 kernel, whose twin rounds the normalized p to
// bf16 before P.V (which an online softmax cannot reproduce), nothing here
// is rounded, so one pass with an online softmax computes the function:
// each row keeps its running max and sum, rescales its accumulators when
// the max grows, and divides by the sum once at the end.  Each key tile's
// P.V accumulates into fresh registers and joins the running output by an
// IEEE f32 multiply-add, so that the tensor cores' truncating accumulation
// sees 24 additions, not one per 8 keys of the head (gemm_f32.cuh).  The C fragments
// of S become the A fragments of P.V without leaving the thread by
// relabelling the keys within each 8-key step (logical column t is key 2t,
// t + 4 is key 2t + 1; V's rows are read in the same order).
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kF32BQ = 64;             // query rows per CTA, key rows per tile
constexpr int kF32DH = 64;             // head dim
constexpr int kF32Ld = kF32DH + 4;     // smem row stride in floats
constexpr int kF32Tile = kF32BQ * kF32Ld;
constexpr int kF32AttnThreads = 128;
constexpr int kF32MaxLk = 768;

// -inf: the score of a key past Lk (exp gives exactly 0)
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct AttnF32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;  // [B, Lk] additive, or null
  float* o;
  float* lse = nullptr;  // [B*H, Lq]: each row's logsumexp of s, or null (K2/K3-f32)
  int heads, lq, lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
};

inline size_t attn_f32_smem_bytes() { return 4u * kF32Tile * sizeof(float); }

// PS, PO: how QK^T and P.V form their products (tf32.cuh Products)
template <int PS, int PO>
__global__ void __launch_bounds__(kF32AttnThreads) attn_f32_kernel(const AttnF32Args a) {
  extern __shared__ __align__(16) float smem[];  // 2 stages x (K tile, V tile)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const float* kb = a.k + b * a.k_bs + h * kF32DH;
  const float* vb = a.v + b * a.v_bs + h * kF32DH;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const int ntiles = (a.lk + kF32BQ - 1) / kF32BQ;

  auto load_tile = [&](int kt, int stage) {
    float* ks = smem + stage * 2 * kF32Tile;
    float* vs = ks + kF32Tile;
    for (int i = threadIdx.x; i < kF32BQ * (kF32DH / 4); i += kF32AttnThreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const int key = kt * kF32BQ + r;
      const bool in = key < a.lk;
      const long long kr = in ? key : 0;  // rows past Lk are zero-filled
      cp_async16(smem_u32(ks + r * kF32Ld + c), kb + kr * a.k_rs + c, in ? 16 : 0);
      cp_async16(smem_u32(vs + r * kF32Ld + c), vb + kr * a.v_rs + c, in ? 16 : 0);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // the warp's Q fragments (rows ra, rb), split once
  const int ra = blockIdx.x * kF32BQ + warp * 16 + g, rb = ra + 8;
  uint32_t qh[8][4], ql[8][4];
  {
    const float* qa = a.q + b * a.q_bs + h * kF32DH + (long long)ra * a.q_rs;
    const float* qc = qa + 8 * a.q_rs;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int c = 8 * s + t;
      split_p<PS>(ra < a.lq ? qa[c] : 0.0f, qh[s][0], ql[s][0]);
      split_p<PS>(rb < a.lq ? qc[c] : 0.0f, qh[s][1], ql[s][1]);
      split_p<PS>(ra < a.lq ? qa[c + 4] : 0.0f, qh[s][2], ql[s][2]);
      split_p<PS>(rb < a.lq ? qc[c + 4] : 0.0f, qh[s][3], ql[s][3]);
    }
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {neg_inf(), neg_inf()};  // running max of rows ra, rb
  float l[2] = {0.0f, 0.0f};            // this thread's share of the running sums

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* ks = smem + (kt & 1) * 2 * kF32Tile;
    const float* vs = ks + kF32Tile;
    const int k0 = kt * kF32BQ;
    const int nt = min(8, (a.lk - k0 + 7) / 8);  // 8-key steps that hold a real key

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      if (j < nt) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float* kr = ks + (8 * j + g) * kF32Ld + 8 * kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_p<PS>(kr[0], bh0, bl0);
          split_p<PS>(kr[4], bh1, bl1);
          mma_p<PS>(s[j], qh[kk], ql[kk], bh0, bl0, bh1, bl1);
        }
      }
    }

    // scale, key mask, keys past Lk; then the online softmax
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = neg_inf();
        if (key < a.lk) {
          x = s[j][e] * a.scale;
          if (mk != nullptr) x += mk[key];
        }
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);  // finite: key 0 is in the first tile
      corr[r] = expf(m[r] - mnew);
      m[r] = mnew;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    // this tile's P V over its real 8-key steps, keys relabelled within
    // each step; then o = o * corr + P V
    float ot[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nt) {
        uint32_t ph[4], pl[4];
        split_p<PO>(s[j][0], ph[0], pl[0]);  // (row g,     key 2t)
        split_p<PO>(s[j][2], ph[1], pl[1]);  // (row g + 8, key 2t)
        split_p<PO>(s[j][1], ph[2], pl[2]);  // (row g,     key 2t + 1)
        split_p<PO>(s[j][3], ph[3], pl[3]);  // (row g + 8, key 2t + 1)
        const float* vr = vs + (8 * j + 2 * t) * kF32Ld + g;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_p<PO>(vr[8 * n], bh0, bl0);           // key 2t,     dim 8n + g
          split_p<PO>(vr[kF32Ld + 8 * n], bh1, bl1);  // key 2t + 1, dim 8n + g
          mma_p<PO>(ot[n], ph, pl, bh0, bl0, bh1, bl1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * corr[e >> 1] + ot[n][e];
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  if (a.lse != nullptr && t == 0) {  // m + log(l), as `_fwd_kernel` saves it
    float* ls = a.lse + (long long)blockIdx.y * a.lq;
    if (ra < a.lq) ls[ra] = m[0] + logf(l[0]);
    if (rb < a.lq) ls[rb] = m[1] + logf(l[1]);
  }
  float* ob = a.o + b * a.o_bs + h * kF32DH + 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (ra < a.lq)
      *reinterpret_cast<float2*>(ob + (long long)ra * a.o_rs + 8 * n) =
          make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (rb < a.lq)
      *reinterpret_cast<float2*>(ob + (long long)rb * a.o_rs + 8 * n) =
          make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// Internal linkage: two libraries include this header (attention_f32,
// decoder_blocks_f32), and a function-local static of an inline function
// would be one object across them.
template <int PS, int PO>
static cudaError_t launch_attn_f32_p(const AttnF32Args& a, int batch, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_f32_kernel<PS, PO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attn_f32_smem_bytes());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kF32BQ - 1) / kF32BQ, batch * a.heads);
  attn_f32_kernel<PS, PO><<<grid, kF32AttnThreads, attn_f32_smem_bytes(), stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch_attention_f32(const AttnF32Args& a, int batch, cudaStream_t stream) {
  if (a.lk > kF32MaxLk || a.lk < 1 || a.lq < 1 || batch < 1) return cudaErrorInvalidValue;
  if ((a.q_rs | a.k_rs | a.v_rs | a.o_rs | a.q_bs | a.k_bs | a.v_bs | a.o_bs) & 3)
    return cudaErrorInvalidValue;
  return launch_attn_f32_p<products_of(kProdScores), products_of(kProdPV)>(a, batch, stream);
}

}  // namespace crog
