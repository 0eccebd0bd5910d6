// The attention backward on fp32 operands, head dim 64: K1b-f32, and the
// attention step of K2b-f32 / K3b-f32.
//
// Replaces crog_tpu/ops/pallas_attention.py:133 `_fused_bwd_vjp`
// (pallas_call at :140, kernel `_bwd_kernel` :53) and the attention
// backward `_mha_bwd` inside the decoder blocks' backward kernels
// (crog_tpu/ops/pallas_decoder.py:123) where the model computes in fp32:
// every cast there goes to the operands' dtype, which is then f32, so P and
// dS are not rounded.
//
// What it computes, per (batch, head), with s = (q k^T) * scale + mask[key]:
//   p  = softmax(s)                       recomputed from q and k
//   dv = p^T do
//   dp = do v^T
//   ds = p * (dp - delta) * scale
//   dq = ds k,  dk = ds^T q
// all in f32, with delta = rowsum(do * o) as K1b's `_bwd_kernel` takes it
// (twin ops/attention.py:attention_bwd_plain), or, where o is null, delta =
// rowsum(dp * p) as the decoder blocks' `_mha_bwd` takes it (twin
// mha_bwd_plain, with the blocks' key mask and Lk != Lq): the same sum
// over the keys (o = p v), but only the second gives an exact 0 where
// one key takes all the weight.  q, o, do, dq are
// [B, Lq, H*64], k, v, dk, dv [B, Lk, H*64], f32 with a free row and batch
// stride (multiples of 4 floats); 1 <= Lq, Lk <= 768.
//
// Bound on an H100 (ops/work.py, 3xTF32 at a third of TF32's 495
// TFLOP/s): the CLIP attention pool (B=24, 32 heads, L=169) is 14.0 GFLOP
// against 266 MB, about 85 us by operations (79 us by bytes); the
// decoder's self attention (B=24, 8 heads, L=676) 56 GFLOP, about 0.34 ms.
//
// Design: right and simple first, two kernels, no atomics.  At fp32 a head
// of 169 tokens' q, k, v, o and do is 216 KB, so the bf16 kernel's whole
// head in one CTA does not fit; queries and keys are split instead, as in
// FlashAttention-2's backward:
//   attn_bwd_f32_dq_kernel: a CTA of 4 warps takes 64 query rows (16 a
//     warp) and streams the head's keys in 64-key tiles through a two-stage
//     cp.async ring: first QK^T alone for the rows' max and sum, (without
//     o) then QK^T and dO V^T for delta, then QK^T, dO V^T, dS and dQ +=
//     dS K.  It writes dq and each row's (max, sum, delta) for the second
//     kernel.
//   attn_bwd_f32_dkv_kernel: a CTA of 4 warps takes 64 keys (16 a warp) and
//     streams the query tiles with their statistics: K Q^T and V dO^T give
//     P^T and dP^T, then dV += P^T dO and dK += dS^T Q.
// Every product is mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32.cuh),
// both operands from shared memory (rows padded to 68 floats: every
// fragment load is free of bank conflicts).  The C fragments of P and dS
// become A fragments without leaving the thread by relabelling the
// contraction index within each 8-step, as attention_f32.cuh does for P.V.
// Each tile's products accumulate into fresh registers that an IEEE f32 add
// joins to the running dq, dk, dv (24 tensor-core additions, gemm_f32.cuh).
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kAbF32T = 64;              // rows per CTA, rows per streamed tile
constexpr int kAbF32DH = 64;             // head dim
constexpr int kAbF32Ld = kAbF32DH + 4;   // smem row stride in floats
constexpr int kAbF32Tile = kAbF32T * kAbF32Ld;
constexpr int kAbF32Threads = 128;
constexpr int kAbF32MaxL = 768;

struct AttnBwdF32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* mask;  // [B, Lk] additive, or null
  float* dq;
  float* dk;
  float* dv;
  float* stats;  // [B*H, 3, Lq]: row max, row sum, delta
  int heads, lq, lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs, dq_bs, dq_rs, dk_bs,
      dk_rs, dv_bs, dv_rs;
  float scale;
};

// c[j] += A B^T over the head dim: A 16 rows (row r at a + r lda), B 8 NJ
// rows (row n at b + n ldb), both 64 wide, in shared memory
template <int P, int NJ>
__device__ __forceinline__ void ab_mma_nt(float (&c)[NJ][4], const float* a, const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kAbF32DH; kk += 8) {
    uint32_t ah[4], al[4];
    const float* ar = a + g * kAbF32Ld + kk + t;
    split_p<P>(ar[0], ah[0], al[0]);
    split_p<P>(ar[8 * kAbF32Ld], ah[1], al[1]);
    split_p<P>(ar[4], ah[2], al[2]);
    split_p<P>(ar[8 * kAbF32Ld + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* br = b + (8 * j + g) * kAbF32Ld + kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_p<P>(br[0], bh0, bl0);
      split_p<P>(br[4], bh1, bl1);
      mma_p<P>(c[j], ah, al, bh0, bl0, bh1, bl1);
    }
  }
}

// c[n] += X B for X [16, 8 NJ] held as C fragments (x[j]: rows g, g + 8,
// columns 8j + 2t, 8j + 2t + 1) and B [8 NJ, 64] in shared memory (row r at
// b + r ldb): within each 8-step logical k = t is column 2t and t + 4 is
// 2t + 1, and B's rows are read in the same order
template <int P, int NJ>
__device__ __forceinline__ void ab_mma_cb(float (&c)[8][4], const float (&x)[NJ][4],
                                          const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t xh[4], xl[4];
    split_p<P>(x[j][0], xh[0], xl[0]);  // (row g,     k 2t)
    split_p<P>(x[j][2], xh[1], xl[1]);  // (row g + 8, k 2t)
    split_p<P>(x[j][1], xh[2], xl[2]);  // (row g,     k 2t + 1)
    split_p<P>(x[j][3], xh[3], xl[3]);  // (row g + 8, k 2t + 1)
    const float* br = b + (8 * j + 2 * t) * kAbF32Ld + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_p<P>(br[8 * n], bh0, bl0);             // k 2t,     column 8n + g
      split_p<P>(br[kAbF32Ld + 8 * n], bh1, bl1);  // k 2t + 1, column 8n + g
      mma_p<P>(c[n], xh, xl, bh0, bl0, bh1, bl1);
    }
  }
}

// rows [r0, r0 + 64) of a [rows, 64] head slice (row stride rs) into a
// padded tile, rows past `rows` zero-filled
__device__ __forceinline__ void ab_load_tile(float* dst, const float* src, long long rs, int r0,
                                             int rows) {
  for (int i = threadIdx.x; i < kAbF32T * (kAbF32DH / 4); i += kAbF32Threads) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool in = r0 + r < rows;
    cp_async16(smem_u32(dst + r * kAbF32Ld + c), src + (in ? (r0 + r) * rs : 0) + c,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ float ab_neg_inf() { return __int_as_float(0xff800000); }

template <int PS, int PDP, int PDQ>
__global__ void __launch_bounds__(kAbF32Threads) attn_bwd_f32_dq_kernel(const AttnBwdF32Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [64][68] this CTA's q rows
  float* dos = qs + kAbF32Tile;    // [64][68] their do rows
  float* ring = dos + kAbF32Tile;  // 2 stages x (K tile, V tile)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kAbF32T;
  const float* kb = a.k + b * a.k_bs + h * kAbF32DH;
  const float* vb = a.v + b * a.v_bs + h * kAbF32DH;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const int ntiles = (a.lk + kAbF32T - 1) / kAbF32T;
  const float* qw = qs + warp * 16 * kAbF32Ld;  // this warp's 16 rows
  const float* dow = dos + warp * 16 * kAbF32Ld;

  ab_load_tile(qs, a.q + b * a.q_bs + h * kAbF32DH, a.q_rs, q0, a.lq);
  ab_load_tile(dos, a.dout + b * a.do_bs + h * kAbF32DH, a.do_rs, q0, a.lq);
  cp_async_commit();
  // body(k0, K tile, V tile) for each 64-key tile of the head in order, the
  // tiles (V's only when with_v) streamed through the ring
  auto stream_keys = [&](bool with_v, auto&& body) {
    auto load = [&](int kt) {
      float* ks = ring + (kt & 1) * 2 * kAbF32Tile;
      ab_load_tile(ks, kb, a.k_rs, kt * kAbF32T, a.lk);
      if (with_v) ab_load_tile(ks + kAbF32Tile, vb, a.v_rs, kt * kAbF32T, a.lk);
      cp_async_commit();
    };
    load(0);
    for (int kt = 0; kt < ntiles; ++kt) {
      if (kt + 1 < ntiles) {
        load(kt + 1);
        cp_async_wait_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const float* ks = ring + (kt & 1) * 2 * kAbF32Tile;
      body(kt * kAbF32T, ks, ks + kAbF32Tile);
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
  };
  // the scaled, masked score of `key` (-inf past Lk: exp gives exactly 0)
  auto score = [&](float s, int key) {
    if (key >= a.lk) return ab_neg_inf();
    return mk != nullptr ? s * a.scale + mk[key] : s * a.scale;
  };

  // this thread's rows: ra = q0 + 16 warp + g, rb = ra + 8
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  // delta = rowsum(do * o), one warp per row of its 16, two columns a lane
  float delta[2] = {0.0f, 0.0f};
  if (a.o != nullptr) {
    const float* ob = a.o + b * a.o_bs + h * kAbF32DH + 2 * lane;
    const float* db = a.dout + b * a.do_bs + h * kAbF32DH + 2 * lane;
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + warp * 16 + r;
      float s = 0.0f;
      if (row < a.lq) {
        const float2 ov = *reinterpret_cast<const float2*>(ob + row * a.o_rs);
        const float2 dv = *reinterpret_cast<const float2*>(db + row * a.do_rs);
        s = ov.x * dv.x + ov.y * dv.y;
      }
      s = warp_sum(s);
      if (r == g) delta[0] = s;
      if (r == g + 8) delta[1] = s;
    }
  }

  // the rows' max and sum of exp over every key
  float m[2] = {ab_neg_inf(), ab_neg_inf()}, l[2] = {0.0f, 0.0f};
  stream_keys(false, [&](int k0, const float* ks, const float*) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    ab_mma_nt<PS, 8>(s, qw, ks);
    float tmax[2] = {ab_neg_inf(), ab_neg_inf()};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = score(s[j][e], k0 + 8 * j + 2 * t + (e & 1));
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);  // finite: key 0 is in the first tile
      l[r] *= expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[j][e] - m[e >> 1]);
  });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // P and dP of 32 keys from k0 (K and V tile rows from kr): p[j][e] and
  // dp[j][e] over keys k0 + 8j + 2t + (e & 1) of rows ra (e < 2), rb
  auto p_dp = [&](int k0, const float* kr, const float* vr, float (&p)[4][4],
                  float (&dp)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.0f;
    ab_mma_nt<PS, 4>(p, qw, kr);
    ab_mma_nt<PDP, 4>(dp, dow, vr);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = expf(score(p[j][e], k0 + 8 * j + 2 * t + (e & 1)) - m[e >> 1]) / l[e >> 1];
  };

  if (a.o == nullptr) {  // delta = rowsum(dP * P) over every key
    stream_keys(true, [&](int k0, const float* ks, const float* vs) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p[4][4], dp[4][4];
        p_dp(k0 + 32 * half, ks + 32 * half * kAbF32Ld, vs + 32 * half * kAbF32Ld, p, dp);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) delta[e >> 1] += dp[j][e] * p[j][e];
      }
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
  }
  if (t == 0) {
    float* st = a.stats + (long long)blockIdx.y * 3 * a.lq;
    if (ra < a.lq) {
      st[ra] = m[0];
      st[a.lq + ra] = l[0];
      st[2 * a.lq + ra] = delta[0];
    }
    if (rb < a.lq) {
      st[rb] = m[1];
      st[a.lq + rb] = l[1];
      st[2 * a.lq + rb] = delta[1];
    }
  }

  // dQ = sum over the keys of dS K, 32 keys at a time
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  stream_keys(true, [&](int k0, const float* ks, const float* vs) {
    float part[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float p[4][4], dp[4][4];
      p_dp(k0 + 32 * half, ks + 32 * half * kAbF32Ld, vs + 32 * half * kAbF32Ld, p, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = p[j][e] * (dp[j][e] - delta[e >> 1]) * a.scale;  // dS
      ab_mma_cb<PDQ, 4>(part, p, ks + 32 * half * kAbF32Ld);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] += part[n][e];
  });
  float* out = a.dq + b * a.dq_bs + h * kAbF32DH + 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (ra < a.lq)
      *reinterpret_cast<float2*>(out + (long long)ra * a.dq_rs + 8 * n) =
          make_float2(dq[n][0], dq[n][1]);
    if (rb < a.lq)
      *reinterpret_cast<float2*>(out + (long long)rb * a.dq_rs + 8 * n) =
          make_float2(dq[n][2], dq[n][3]);
  }
}

template <int PS, int PDP, int PDV, int PDK>
__global__ void __launch_bounds__(kAbF32Threads) attn_bwd_f32_dkv_kernel(const AttnBwdF32Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [64][68] this CTA's keys
  float* vs = ks + kAbF32Tile;      // [64][68] their values
  float* ring = vs + kAbF32Tile;    // 2 stages x (Q tile, dO tile)
  float* stat = ring + 4 * kAbF32Tile;  // 2 stages x [3][64]: max, sum, delta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int k0 = blockIdx.x * kAbF32T;
  const float* qb = a.q + b * a.q_bs + h * kAbF32DH;
  const float* db = a.dout + b * a.do_bs + h * kAbF32DH;
  const float* st = a.stats + (long long)blockIdx.y * 3 * a.lq;
  const int ntiles = (a.lq + kAbF32T - 1) / kAbF32T;

  ab_load_tile(ks, a.k + b * a.k_bs + h * kAbF32DH, a.k_rs, k0, a.lk);
  ab_load_tile(vs, a.v + b * a.v_bs + h * kAbF32DH, a.v_rs, k0, a.lk);
  cp_async_commit();
  auto load_q = [&](int qt, int stage) {
    float* qs = ring + stage * 2 * kAbF32Tile;
    ab_load_tile(qs, qb, a.q_rs, qt * kAbF32T, a.lq);
    ab_load_tile(qs + kAbF32Tile, db, a.do_rs, qt * kAbF32T, a.lq);
    cp_async_commit();
    float* sts = stat + stage * 3 * kAbF32T;  // read after the next barrier
    for (int i = threadIdx.x; i < 3 * kAbF32T; i += kAbF32Threads) {
      const int which = i / kAbF32T, r = qt * kAbF32T + i % kAbF32T;
      sts[i] = r < a.lq ? st[(long long)which * a.lq + r] : 0.0f;
    }
  };
  load_q(0, 0);

  // this thread's keys
  const int ka = k0 + warp * 16 + g, kb = ka + 8;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const float mka = (mk != nullptr && ka < a.lk) ? mk[ka] : 0.0f;
  const float mkb = (mk != nullptr && kb < a.lk) ? mk[kb] : 0.0f;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  for (int qt = 0; qt < ntiles; ++qt) {
    if (qt + 1 < ntiles) {
      load_q(qt + 1, (qt + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* qs = ring + (qt & 1) * 2 * kAbF32Tile;
    const float* dos = qs + kAbF32Tile;
    const float* sts = stat + (qt & 1) * 3 * kAbF32T;
    float pk[8][4], pv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[n][e] = pv[n][e] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // 32 queries at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      ab_mma_nt<PS, 4>(s, ks + warp * 16 * kAbF32Ld, qs + 32 * half * kAbF32Ld);
      ab_mma_nt<PDP, 4>(dp, vs + warp * 16 * kAbF32Ld, dos + 32 * half * kAbF32Ld);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = 32 * half + 8 * j + 2 * t + (e & 1);  // query within the tile
          float p = 0.0f, ds = 0.0f;  // 0 for queries past Lq and keys past Lk
          if (qt * kAbF32T + lq < a.lq && ((e >> 1) ? kb : ka) < a.lk) {
            const float x = s[j][e] * a.scale + ((e >> 1) ? mkb : mka);
            p = expf(x - sts[lq]) / sts[kAbF32T + lq];
            ds = p * (dp[j][e] - sts[2 * kAbF32T + lq]) * a.scale;
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }
      ab_mma_cb<PDV, 4>(pv, s, dos + 32 * half * kAbF32Ld);  // dV += P^T dO
      ab_mma_cb<PDK, 4>(pk, dp, qs + 32 * half * kAbF32Ld);  // dK += dS^T Q
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] += pk[n][e];
        dv[n][e] += pv[n][e];
      }
    __syncthreads();
  }
  float* dko = a.dk + b * a.dk_bs + h * kAbF32DH + 2 * t;
  float* dvo = a.dv + b * a.dv_bs + h * kAbF32DH + 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (ka < a.lk) {
      *reinterpret_cast<float2*>(dko + (long long)ka * a.dk_rs + 8 * n) =
          make_float2(dk[n][0], dk[n][1]);
      *reinterpret_cast<float2*>(dvo + (long long)ka * a.dv_rs + 8 * n) =
          make_float2(dv[n][0], dv[n][1]);
    }
    if (kb < a.lk) {
      *reinterpret_cast<float2*>(dko + (long long)kb * a.dk_rs + 8 * n) =
          make_float2(dk[n][2], dk[n][3]);
      *reinterpret_cast<float2*>(dvo + (long long)kb * a.dv_rs + 8 * n) =
          make_float2(dv[n][2], dv[n][3]);
    }
  }
}

inline size_t attn_bwd_f32_smem_dq() { return 6u * kAbF32Tile * sizeof(float); }
inline size_t attn_bwd_f32_smem_dkv() {
  return (6u * kAbF32Tile + 2u * 3 * kAbF32T) * sizeof(float);
}

// Internal linkage: two libraries include this header (attention_bwd_f32,
// decoder_blocks_bwd_f32).
template <int PS, int PDP, int PDQ, int PDV, int PDK>
static cudaError_t launch_attention_bwd_f32_p(const AttnBwdF32Args& a, int batch,
                                              cudaStream_t stream) {
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      attn_bwd_f32_dq_kernel<PS, PDP, PDQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_bwd_f32_smem_dq());
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      attn_bwd_f32_dkv_kernel<PS, PDP, PDV, PDK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_bwd_f32_smem_dkv());
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_dkv != cudaSuccess) return attr_dkv;
  const int bh = batch * a.heads;
  attn_bwd_f32_dq_kernel<PS, PDP, PDQ>
      <<<dim3((a.lq + kAbF32T - 1) / kAbF32T, bh), kAbF32Threads, attn_bwd_f32_smem_dq(),
         stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_f32_dkv_kernel<PS, PDP, PDV, PDK>
      <<<dim3((a.lk + kAbF32T - 1) / kAbF32T, bh), kAbF32Threads, attn_bwd_f32_smem_dkv(),
         stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch_attention_bwd_f32(const AttnBwdF32Args& a, int batch,
                                            cudaStream_t stream) {
  if (a.lq < 1 || a.lk < 1 || a.lq > kAbF32MaxL || a.lk > kAbF32MaxL || batch < 1 ||
      a.heads < 1)
    return cudaErrorInvalidValue;
  if ((a.q_rs | a.k_rs | a.v_rs | a.o_rs | a.do_rs | a.q_bs | a.k_bs | a.v_bs | a.o_bs |
       a.do_bs) & 3 ||
      (a.dq_rs | a.dk_rs | a.dv_rs | a.dq_bs | a.dk_bs | a.dv_bs) & 1)
    return cudaErrorInvalidValue;
  return launch_attention_bwd_f32_p<products_of(kProdBwdScores), products_of(kProdDP),
                                    products_of(kProdDQ), products_of(kProdDV),
                                    products_of(kProdDK)>(a, batch, stream);
}

}  // namespace crog
