// Softmax attention with an exact (normalized, then rounded) softmax, for
// head dims 8-512.
//
// Replaces the forward Pallas kernel `_fused_fwd` of
// crog_tpu/ops/pallas_attention.py:104 (pallas_call at :111) and the
// all-head attention `_mha_fwd` inside the decoder block kernels
// (crog_tpu/ops/pallas_decoder.py:99).
//
// What it computes, per (batch, head):
//   s = (q k^T) * scale + mask[key]      (keys >= Lk weigh exactly 0, so an
//                                         all-masked row averages over the
//                                         Lk real keys)
//   p = bf16( exp(s - max) / sum )       (normalized, then rounded, as the
//                                         TPU kernel rounds p before P.V)
//   o = bf16( p v )                      (f32 accumulation)
// q/k/v/o are [B, L, H*dh] with a free row and batch stride, so q and k can
// be column slices of one packed projection.  Any Lk >= 1: the two-pass
// path streams the key tiles, so nothing is sized by Lk.  The head tile DH
// (32, 64 or 128, common.cuh attn_head_tile) is a template
// parameter that sizes the tiles and the O and Q registers; the head's dh
// (8 to DH) is a run-time value: its columns past dh load as zeros into
// shared memory and are not stored, so dh 8 and 16 run in the DH 32 build.
// Head tiles 256 and 512 run attn_fwd_wide_kernel (below).
//
// Bound on an H100: the CLIP attention pool (B=24, 32 heads, L=169) is 5.6
// GFLOP against 66 MB of q/k/v/o, about 20 us, limited by memory; the
// decoder's self attention (B=24, 8 heads, L=676) 22.5 GFLOP (with the
// second pass's QK^T, 34) against 66 MB, about 23-34 us; at 640^2 (L =
// 1600) 126 GFLOP (189 with the second QK^T) against 157 MB.
//
// Design.  Because p is normalized before P.V, a one-pass online softmax
// does not compute this function: each query row needs its max and sum
// before any p.  One CTA of 4 warps takes 64 query rows of one head, 16 per
// warp; every product is ldmatrix + mma.sync m16n8k16 (bf16 operands, f32
// sums) with the scores in registers (the C fragments of S become the A
// fragments of P.V without leaving the thread), the Q fragments stay in
// registers, and scores are taken in the log2 domain (s * log2(e)) so that
// each exponential is one exp2 and the normalization one multiply by the
// reciprocal sum.  Two paths, by key count (attn_fwd_key_tiles; the Python
// mirror is ops/attention.py:fwd_path):
//   one pass (Lk <= 192: K1's 169, K3's 17): the head's KT = ceil(Lk / 64)
//     key tiles of scores stay in registers (8 KT fragments of 16 x 8 per
//     warp).  All K and V tiles of the head are requested by cp.async at
//     once, K first, so V lands while QK^T and the softmax run.  K/V rows
//     are loaded up to the next multiple of 16 past Lk and n-tiles past Lk
//     are skipped, so K3's 17 keys cost three n-tiles of 8, not 64 keys.
//   two passes (Lk > 192: K2's 676): the key tiles stream through a
//     two-stage cp.async ring twice.  The first pass keeps each row's
//     running max and rescaled sum; the second recomputes QK^T, forms p =
//     bf16(exp2(s - max) / sum) in registers and accumulates P.V.
// At DH 64 shared memory is 27-64 KB (one pass) or 36 KB (two passes: Q
// sits in the ring slot the first pass leaves free), so three to five CTAs
// share an SM (DH 128: 52-122 KB or 70 KB, and launch bounds that leave
// the O accumulator's 64 registers room); the output leaves the registers
// as 16-byte bf16 row segments after a shuffle within each quad.
#pragma once

#include "attention_bwd.cuh"  // the ldmatrix / mma.sync fragment helpers ab_*
#include "common.cuh"
#include "sm90.cuh"

namespace crog {

constexpr int kAttnBQ = 64;   // query rows per CTA, and key rows per tile
constexpr int kAttnOnePassTiles = 3;  // the one-pass path holds up to 192 keys
constexpr int kAttnThreads = 128;
static_assert(kAttnBQ == kAbBQ, "tiles shared with the ab_* helpers");

// key tiles whose scores one CTA holds in registers (the one-pass path), or
// 0 for the two-pass path
__host__ __device__ inline int attn_fwd_key_tiles(int lk) {
  const int t = (lk + kAttnBQ - 1) / kAttnBQ;
  return t <= kAttnOnePassTiles ? t : 0;
}

// Q, then KT K tiles and KT V tiles (one pass); or two ring stages of K and
// V, Q in the second stage's V slot, which the first pass leaves unused (two
// passes)
template <int DH>
__host__ __device__ constexpr size_t attn_fwd_smem_bytes(int kt) {
  return (size_t)(kt > 0 ? 1 + 2 * kt : 4) * AbTile<DH>::kElems * sizeof(bf16);
}

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;  // [B, Lk] additive, or nullptr
  bf16* o;
  int heads, lq, lk;
  int dh;  // head dim; head h's columns are [h * dh, (h + 1) * dh)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // in elements
  float scale;
};

// the A fragments of this warp's 16 query rows over the head tile
template <int DH>
__device__ __forceinline__ void attn_q_frags(const bf16* qs, int r0, uint32_t (&fq)[DH / 16][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(smem_u32(qs + (r0 + (lane & 15)) * AbTile<DH>::kLd + kk * 16 + (lane >> 4) * 8),
            fq[kk]);
}

// s = this warp's 16 query rows against the 64 keys of tile ks, in the log2
// domain with the key mask: s * scale * log2(e) + mask * log2(e) for keys
// < lk, -3e38 past it (below any real score; such keys weigh exactly 0).
// n-tiles j >= nv are not multiplied.
template <int DH>
__device__ __forceinline__ void attn_scores(float (&s)[8][4], const uint32_t (&fq)[DH / 16][4],
                                            const bf16* ks, int kt, int lk, const float* mrow,
                                            float sl2) {
  constexpr int LD = AbTile<DH>::kLd;
  const int lane = threadIdx.x & 31;
  const int qd = lane & 3;
  const int nv = min(8, (lk - kt + 7) / 8);
  ab_zero(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nv) {
#pragma unroll
      for (int k2 = 0; k2 < DH / 32; ++k2) {
        uint32_t bb[4];
        ldsm_x4(smem_u32(ks + (j * 8 + (lane & 7)) * LD + k2 * 32 + (lane >> 3) * 8), bb);
        mma_bf16(s[j], fq[2 * k2], bb[0], bb[1]);
        mma_bf16(s[j], fq[2 * k2 + 1], bb[2], bb[3]);
      }
    }
  }
  if (!mrow && kt + kAttnBQ <= lk) {  // a whole tile of unmasked keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kt + j * 8 + 2 * qd + (e & 1);
      s[j][e] = key < lk ? s[j][e] * sl2 + (mrow ? mrow[key] * kLog2e : 0.0f) : -3.0e38f;
    }
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float attn_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the quad's row max and sum over its four threads' partials (rows g, g + 8),
// in a fixed order; returns the reciprocal sums in inv
__device__ __forceinline__ void attn_quad_stats(float (&m)[2], const float (&l)[2],
                                                float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mq = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float lq = l[r] * attn_exp2(m[r] - mq);
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    m[r] = mq;
    inv[r] = 1.0f / lq;
  }
}

// the rows' bf16 outputs as 16-byte segments: per pair of 8-column fragments
// a quad holds four row segments; quad_gather16 gives each thread one whole.
// Segments at or past column dh are not stored.
template <int DH>
__device__ __forceinline__ void attn_store(const float (&o)[DH / 8][4], bf16* ob, long long rs,
                                           int row0, int lq, int dh) {
  const int lane = threadIdx.x & 31;
  const int qi = lane & 3;
  const int row = row0 + (lane >> 2) + 8 * (qi & 1);
#pragma unroll
  for (int j = 0; j < DH / 8; j += 2) {
    const uint32_t v[4] = {pack_bf16(o[j][0], o[j][1]), pack_bf16(o[j][2], o[j][3]),
                           pack_bf16(o[j + 1][0], o[j + 1][1]),
                           pack_bf16(o[j + 1][2], o[j + 1][3])};
    const uint4 seg = quad_gather16(v);
    const int col = (j + (qi >> 1)) * 8;
    if (row < lq && col < dh) *reinterpret_cast<uint4*>(ob + (long long)row * rs + col) = seg;
  }
}

// rows of a K or V tile a CTA loads: up to the next multiple of 16 past lk
__device__ __forceinline__ int attn_tile_rows(int kt, int lk) {
  return min(kAttnBQ, round_up(lk - kt, 16));
}

// CTAs an SM the launch bounds ask for: 2 for the one-pass kernel; for the
// two-pass one 5 at DH 64, 4 at DH 32 (its run-time column checks), 2 at DH
// 128 (its O 64, Q 32 and score 32 registers)
template <int KT, int DH>
__global__ void __launch_bounds__(kAttnThreads, KT > 0 || DH > 64 ? 2 : DH == 64 ? 5 : 4)
    attn_fwd_kernel(AttnArgs a) {
  constexpr int TILE = AbTile<DH>::kElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // one pass: Q, K tiles, V tiles; two passes: [2 stages][K, V], Q in stage 1's V
  bf16* ts = reinterpret_cast<bf16*>(smem_raw) + (KT > 0 ? TILE : 0);
  bf16* qs = KT > 0 ? reinterpret_cast<bf16*>(smem_raw) : ts + 3 * TILE;

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kAttnBQ;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's query rows
  const int dh = attn_run_dh<DH>(a.dh);

  const bf16* qb = a.q + b * a.q_bs + h * dh;
  const bf16* kb = a.k + b * a.k_bs + h * dh;
  const bf16* vb = a.v + b * a.v_bs + h * dh;
  const float* mrow = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const float sl2 = a.scale * kLog2e;

  ab_load_rows<kAttnThreads, DH>(qs, qb, a.q_rs, q0, kAttnBQ, a.lq, dh);
  uint32_t fq[DH / 16][4];
  float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.0f, 0.0f}, inv[2];
  float o[DH / 8][4];
  ab_zero(o);

  if constexpr (KT > 0) {
    // ---- one pass: every K tile (with Q) as one group, every V tile as a second
#pragma unroll
    for (int t = 0; t < KT; ++t)
      ab_load_rows<kAttnThreads, DH>(ts + t * TILE, kb, a.k_rs, t * kAttnBQ,
                                     attn_tile_rows(t * kAttnBQ, a.lk), a.lk, dh);
    cp_async_commit();
#pragma unroll
    for (int t = 0; t < KT; ++t)
      ab_load_rows<kAttnThreads, DH>(ts + (KT + t) * TILE, vb, a.v_rs, t * kAttnBQ,
                                     attn_tile_rows(t * kAttnBQ, a.lk), a.lk, dh);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    attn_q_frags<DH>(qs, r0, fq);
    float s[KT][8][4];
#pragma unroll
    for (int t = 0; t < KT; ++t)
      attn_scores<DH>(s[t], fq, ts + t * TILE, t * kAttnBQ, a.lk, mrow, sl2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int t = 0; t < KT; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          m[r] = fmaxf(m[r], fmaxf(s[t][j][2 * r], s[t][j][2 * r + 1]));
    }
    // the quad's max first, so that every exp2 is taken once against it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[t][j][e] > -3.0e38f ? attn_exp2(s[t][j][e] - m[e >> 1]) : 0.0f;
          s[t][j][e] = x;
          l[e >> 1] += x;
        }
    attn_quad_stats(m, l, inv);  // m is already the quad's: only the sums move
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][j][e] *= inv[e >> 1];
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < KT; ++t)
      ab_nn_all<kBwdBf16, DH, DH>(o, s[t], ts + (KT + t) * TILE,
                                  min(8, (a.lk - t * kAttnBQ + 7) / 8));
  } else {
    // ---- two passes over the key tiles: the statistics, then P.V
    const int T = (a.lk + kAttnBQ - 1) / kAttnBQ;
    auto load = [&](int i) {
      bf16* st = ts + (i & 1) * 2 * TILE;
      const int kt = (i % T) * kAttnBQ;
      const int rows = attn_tile_rows(kt, a.lk);
      ab_load_rows<kAttnThreads, DH>(st, kb, a.k_rs, kt, rows, a.lk, dh);
      if (i >= T) ab_load_rows<kAttnThreads, DH>(st + TILE, vb, a.v_rs, kt, rows, a.lk, dh);
    };
    load(0);
    cp_async_commit();
#pragma unroll 1
    for (int i = 0; i < 2 * T; ++i) {
      if (i + 1 < 2 * T) load(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile i (and Q) landed for every thread
      if (i == 0) attn_q_frags<DH>(qs, r0, fq);
      const int kt = (i % T) * kAttnBQ;
      const bf16* ks = ts + (i & 1) * 2 * TILE;
      float s[8][4];
      attn_scores<DH>(s, fq, ks, kt, a.lk, mrow, sl2);
      if (i < T) {  // running max and rescaled sum over this thread's keys
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = m[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          float lt = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              lt += s[j][2 * r + e] > -3.0e38f ? attn_exp2(s[j][2 * r + e] - mt) : 0.0f;
          l[r] = l[r] * attn_exp2(m[r] - mt) + lt;
          m[r] = mt;
        }
        if (i == T - 1) attn_quad_stats(m, l, inv);
      } else {  // p = bf16(exp2(s - max) / sum); o += P V
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = s[j][e] > -3.0e38f ? attn_exp2(s[j][e] - m[e >> 1]) * inv[e >> 1] : 0.0f;
        ab_nn_all<kBwdBf16, DH, DH>(o, s, ks + TILE, min(8, (a.lk - kt + 7) / 8));
      }
      __syncthreads();  // every warp is done with stage i & 1 before it refills
    }
  }
  attn_store<DH>(o, a.o + b * a.o_bs + h * dh, a.o_rs, q0 + r0, a.lq, dh);
}

// ------------------------------------------------- head tiles 256 and 512
// A head of 256 or 512 columns (num_head 2 and 1 at d_model 512) would hold
// Q's fragments and O's accumulator in 192 or 384 registers a thread, and a
// 64-key tile of K at DH 512 is 66,560 bytes.  So the wide kernel streams
// the head in 64-column chunks: a CTA of 4 warps takes 64 query rows and
// kAttnWideCols of O's columns (grid z: 2 CTAs a query block at DH 256, 4
// at 512), keeps its rows of Q whole in shared memory ([DH / 64][64 x 72]),
// and walks the key tiles twice through a kAttnWideStages ring of 64 x 64
// chunks.  Each key tile's scores sum over the head's K chunks (ldmatrix +
// mma.sync, each chunk's Q fragments read from shared memory when it is
// multiplied, each chunk's product in fresh registers joined by f32 adds,
// as attention_bwd.cuh's wide kernels sum); the first pass keeps each
// row's running max and rescaled sum, the second forms p = bf16(exp2(s -
// max) / sum) in registers, as attn_fwd_kernel<0> does, and multiplies it
// by the CTA's V chunks.  Every CTA of a query block forms the whole head's
// scores, twice: S four times at DH 256, eight times at 512 (the softmax
// work is a quarter or an eighth of num_head 8's).  Shared memory (DH / 64
// + 3) chunks: 64,512 bytes at DH 256, 101,376 at 512; 186 registers, two
// CTAs an SM.
constexpr int kAttnWideCols = 128;  // O's columns a CTA owns
constexpr int kAttnWideStages = 3;  // 64 x 64 chunks in flight

template <int DH>
__host__ __device__ constexpr size_t attn_fwd_wide_smem_bytes() {
  return (size_t)(DH / 64 + kAttnWideStages) * kAbChunk * sizeof(bf16);
}

// s += this warp's 16 query rows times the 64 keys of a chunk of K (64
// columns of the head), n-tiles j >= nv skipped, summed in fresh registers
// and joined to s by f32 adds
__device__ __forceinline__ void attn_qk_chunk(float (&s)[8][4], const uint32_t (&fq)[4][4],
                                              const bf16* ks, int nv) {
  constexpr int LD = AbTile<64>::kLd;
  const int lane = threadIdx.x & 31;
  float t[8][4];
  ab_zero(t);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nv) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t bb[4];
        ldsm_x4(smem_u32(ks + (j * 8 + (lane & 7)) * LD + k2 * 32 + (lane >> 3) * 8), bb);
        mma_bf16(t[j], fq[2 * k2], bb[0], bb[1]);
        mma_bf16(t[j], fq[2 * k2 + 1], bb[2], bb[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += t[j][e];
}

// the scores of key tile kt in the log2 domain with the key mask, as
// attn_scores leaves them
__device__ __forceinline__ void attn_scale_mask(float (&s)[8][4], int kt, int lk,
                                                const float* mrow, float sl2) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kt + j * 8 + 2 * qd + (e & 1);
      s[j][e] = key < lk ? s[j][e] * sl2 + (mrow ? mrow[key] * kLog2e : 0.0f) : -3.0e38f;
    }
}

template <int DH>
__global__ void __launch_bounds__(kAttnThreads, 2) attn_fwd_wide_kernel(AttnArgs a) {
  constexpr int NCH = DH / 64;              // K chunks a key tile
  constexpr int NV = kAttnWideCols / 64;    // V chunks of this CTA's columns
  constexpr int ST = kAttnWideStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [NCH] chunks of Q's rows
  bf16* ring = qs + NCH * kAbChunk;           // [ST] chunks of K or V

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kAttnBQ;
  const int c0 = blockIdx.z * kAttnWideCols;  // this CTA's columns of O
  const int r0 = (threadIdx.x >> 5) * 16;
  const bf16* kb = a.k + b * a.k_bs + h * DH;
  const bf16* vb = a.v + b * a.v_bs + h * DH + c0;
  const float* mrow = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const float sl2 = a.scale * kLog2e;
  const int T = (a.lk + kAttnBQ - 1) / kAttnBQ;
  // the chunks in order: each key tile's NCH K chunks (first pass), then
  // each key tile's NCH K chunks and NV V chunks (second pass)
  const int n1 = T * NCH, n = n1 + T * (NCH + NV);
  auto load = [&](int i) {
    const int per = i < n1 ? NCH : NCH + NV, u = i < n1 ? i : i - n1;
    const int kt = (u / per) * kAttnBQ, j = u % per;
    const bool kc = j < NCH;
    ab_load_rows<kAttnThreads, 64>(ring + (i % ST) * kAbChunk,
                                   kc ? kb + j * 64 : vb + (j - NCH) * 64, kc ? a.k_rs : a.v_rs,
                                   kt, attn_tile_rows(kt, a.lk), a.lk, 64);
  };
#pragma unroll
  for (int c = 0; c < NCH; ++c)  // Q, in the first chunk's group
    ab_load_rows<kAttnThreads, 64>(qs + c * kAbChunk, a.q + b * a.q_bs + h * DH + c * 64,
                                   a.q_rs, q0, kAttnBQ, a.lq, 64);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();
  }

  float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
  float o[NV][8][4], s[8][4];
#pragma unroll
  for (int v = 0; v < NV; ++v) ab_zero(o[v]);
  ab_zero(s);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // chunk i landed; every warp is done with chunk i - 1's slot
    if (i + ST - 1 < n) load(i + ST - 1);
    cp_async_commit();
    const bool second = i >= n1;
    const int per = second ? NCH + NV : NCH, u = second ? i - n1 : i;
    const int kt = (u / per) * kAttnBQ, j = u % per;
    const int nv = min(8, (a.lk - kt + 7) / 8);
    const bf16* cs = ring + (i % ST) * kAbChunk;
    if (j < NCH) {
      uint32_t fq[4][4];
      attn_q_frags<64>(qs + j * kAbChunk, r0, fq);
      if (j == 0) ab_zero(s);
      attn_qk_chunk(s, fq, cs, nv);
      if (j == NCH - 1) {
        attn_scale_mask(s, kt, a.lk, mrow, sl2);
        if (!second) {  // running max and rescaled sum over this thread's keys
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mt = m[r];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) mt = fmaxf(mt, fmaxf(s[jj][2 * r], s[jj][2 * r + 1]));
            float lt = 0.0f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                lt += s[jj][2 * r + e] > -3.0e38f ? attn_exp2(s[jj][2 * r + e] - mt) : 0.0f;
            l[r] = l[r] * attn_exp2(m[r] - mt) + lt;
            m[r] = mt;
          }
          if (kt + kAttnBQ >= a.lk) attn_quad_stats(m, l, inv);
        } else {  // p = bf16(exp2(s - max) / sum), kept for the V chunks
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[jj][e] = s[jj][e] > -3.0e38f ? attn_exp2(s[jj][e] - m[e >> 1]) * inv[e >> 1] : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (j == NCH + v) ab_nn_all<kBwdBf16, 64, 64>(o[v], s, cs, nv);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int v = 0; v < NV; ++v)
    attn_store<64>(o[v], a.o + b * a.o_bs + h * DH + c0 + v * 64, a.o_rs, q0 + r0, a.lq, 64);
}

template <int DH>
static cudaError_t attn_fwd_wide_set_smem_once() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_fwd_wide_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attn_fwd_wide_smem_bytes<DH>());
  return attr;
}

template <int DH>
static cudaError_t launch_attention_wide(const AttnArgs& a, int batch, cudaStream_t stream) {
  const cudaError_t attr = attn_fwd_wide_set_smem_once<DH>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kAttnBQ - 1) / kAttnBQ, batch * a.heads, DH / kAttnWideCols);
  attn_fwd_wide_kernel<DH><<<grid, kAttnThreads, attn_fwd_wide_smem_bytes<DH>(), stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t attention_fwd_wide_attrs(int* out) {
  cudaError_t err = attn_fwd_wide_set_smem_once<DH>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, attn_fwd_wide_kernel<DH>);
  if (err != cudaSuccess) return err;
  out[0] = 0;  // two passes at any length
  out[1] = fa.numRegs;
  out[2] = (int)(fa.sharedSizeBytes + attn_fwd_wide_smem_bytes<DH>());
  out[3] = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], attn_fwd_wide_kernel<DH>,
                                                        kAttnThreads,
                                                        attn_fwd_wide_smem_bytes<DH>());
}

// Each kernel's dynamic shared memory limit, set once per library and card.
// Internal linkage: two libraries include this header (attention,
// decoder_blocks), and a function-local static of an inline function would
// be one object across them.
template <int KT, int DH>
static cudaError_t attn_fwd_set_smem_once() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_kernel<KT, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_fwd_smem_bytes<DH>(KT));
  return attr;
}

template <int KT, int DH>
static cudaError_t launch_attn_fwd(const AttnArgs& a, int batch, cudaStream_t stream) {
  const cudaError_t attr = attn_fwd_set_smem_once<KT, DH>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kAttnBQ - 1) / kAttnBQ, batch * a.heads);
  attn_fwd_kernel<KT, DH><<<grid, kAttnThreads, attn_fwd_smem_bytes<DH>(KT), stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_attention_dh(const AttnArgs& a, int batch, cudaStream_t stream) {
  switch (attn_fwd_key_tiles(a.lk)) {
    case 1: return launch_attn_fwd<1, DH>(a, batch, stream);
    case 2: return launch_attn_fwd<2, DH>(a, batch, stream);
    case 3: return launch_attn_fwd<3, DH>(a, batch, stream);
    default: return launch_attn_fwd<0, DH>(a, batch, stream);
  }
}

static cudaError_t launch_attention(const AttnArgs& a, int batch, cudaStream_t stream) {
  if (a.lk < 1 || a.lq < 1 || batch < 1) return cudaErrorInvalidValue;
  switch (attn_head_tile(a.dh)) {
    case 32: return launch_attention_dh<32>(a, batch, stream);
    case 64: return launch_attention_dh<64>(a, batch, stream);
    case 128: return launch_attention_dh<128>(a, batch, stream);
    case 256: return launch_attention_wide<256>(a, batch, stream);
    case 512: return launch_attention_wide<512>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int KT, int DH>
static cudaError_t attn_fwd_attrs_of(int* out) {
  cudaError_t err = attn_fwd_set_smem_once<KT, DH>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, attn_fwd_kernel<KT, DH>);
  if (err != cudaSuccess) return err;
  out[0] = KT;
  out[1] = fa.numRegs;
  out[2] = (int)(fa.sharedSizeBytes + attn_fwd_smem_bytes<DH>(KT));
  out[3] = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], attn_fwd_kernel<KT, DH>,
                                                        kAttnThreads,
                                                        attn_fwd_smem_bytes<DH>(KT));
}

template <int DH>
static cudaError_t attention_fwd_attrs_dh(int lk, int* out) {
  switch (attn_fwd_key_tiles(lk)) {
    case 1: return attn_fwd_attrs_of<1, DH>(out);
    case 2: return attn_fwd_attrs_of<2, DH>(out);
    case 3: return attn_fwd_attrs_of<3, DH>(out);
    default: return attn_fwd_attrs_of<0, DH>(out);
  }
}

// out[5] for the kernel that takes lk keys of head dim dh: its key tiles
// held in registers (0: the two-pass kernel), registers per thread, shared
// memory per CTA (static + dynamic), spill bytes per thread, and CTAs per SM
static cudaError_t attention_fwd_attrs(int lk, int dh, int* out) {
  if (lk < 1) return cudaErrorInvalidValue;
  switch (attn_head_tile(dh)) {
    case 32: return attention_fwd_attrs_dh<32>(lk, out);
    case 64: return attention_fwd_attrs_dh<64>(lk, out);
    case 128: return attention_fwd_attrs_dh<128>(lk, out);
    case 256: return attention_fwd_wide_attrs<256>(out);
    case 512: return attention_fwd_wide_attrs<512>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace crog
