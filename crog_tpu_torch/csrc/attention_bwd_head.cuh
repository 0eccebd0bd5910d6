// K1b for heads that fit one CTA: the f32 softmax attention backward of
// the CLIP attention pool, one CTA per (batch, head).
//
// Replaces the backward Pallas kernel `_bwd_kernel` of
// crog_tpu/ops/pallas_attention.py:53 (pallas_call at :140) for self
// attention over L <= kHbMaxL = 256 tokens, head dim 64, no mask (the pool
// has 169 tokens at 416^2, 256 at 512^2).  Longer heads, of any length, take
// the two-kernel path of attention_bwd.cuh.  Same function and cast points
// as that path and as the twin `attention_bwd_plain`: P, dP and dS in f32,
// delta = rowsum(dO * O), the f32 operands of dV = P^T dO, dK = dS^T Q and
// dQ = dS K split into bf16 hi + lo halves for the tensor cores, and only
// dq, dk, dv rounded to bf16.
//
// Bound on an H100 at the main path (B = 24, 32 heads, L = 169): 133 MB of
// q, k, v, o, dO in and dq, dk, dv out, 40 us at 3.35 TB/s; the products
// are 14 GFLOP at their useful size, 14 us at the bf16 peak.
//
// Design.  A CTA holds every key of its head, so nothing is summed across
// CTAs and nothing is computed twice:
//   - K and V for the whole head go to shared memory once, padded with
//     zeros to LP = L rounded up to 64 rows (a template parameter, so every
//     register array has a compile-time size);
//   - the CTA walks its query tiles of 32 rows; Q, dO and O of tile t + 1
//     arrive by cp.async into the second of two stages while tile t is
//     multiplied; delta is formed from the tile in shared memory;
//   - S = Q K^T and dP = dO V^T are computed once each with ldmatrix +
//     mma.sync m16n8k16 and stay in registers: 16 warps, each 16 query rows
//     x LP/8 keys.  The row max and sum come from quad shuffles and an
//     8-entry exchange in shared memory, in a fixed order, so P is the
//     forward's softmax, exp(s - m) * (1 / l), and needs no statistics in
//     device memory;
//   - P and dS are written to shared memory once each, as bf16 hi + lo
//     pairs in buffers of their own (TF32's 10-bit mantissa would move more
//     of the bf16 outputs); dV += P^T dO and dK += dS^T Q read them with
//     ldmatrix.trans and accumulate in registers across all query tiles
//     (each warp owns 16 head columns of LP/64 key tiles); at the end they
//     are staged over K and V in shared memory and written in 16-byte rows;
//   - dQ = dS K of the tile is complete in the CTA and goes out as bf16.
// No atomics: the same bits in every run.  Attributes are set once per
// process.  Four CTA barriers per query tile; 16 warps (one CTA per SM:
// 136 KB of shared memory at LP = 192) hide the latency between them.
// The per-element softmax work (exp, the hi/lo splits) issues about as
// many instructions as the products, so the kernel sits far above its
// byte bound (PERF.md, PR 5).
//
// What carries to the decoder blocks' L = 676 attention (K2b/K3b, kBwdBf16,
// still the two-kernel path): the register-resident S/dP tiles with
// ldmatrix + mma.sync, the cp.async double buffer of the query tiles, and
// dK/dV accumulated in registers by key-owning warps.  What does not: a
// head of 676 keys does not fit one CTA's registers and shared memory, so
// that path keeps its rows/cols split, or takes a flash-style online
// softmax with the forward's saved row statistics.
#pragma once

#include "attention_bwd.cuh"
#include "sm90.cuh"

namespace crog {

constexpr int kHbQ = 32;          // query rows per tile
constexpr int kHbDH = 64;         // head dim
constexpr int kHbLd = kHbDH + 8;  // bf16 row stride of the K, V, Q, dO, O tiles

constexpr int kHbMaxL = 256;      // longest head this kernel takes
constexpr int kHbThreads = 512;   // 16 warps

__host__ __device__ constexpr size_t hb_smem(int lp) {
  return (size_t)2 * lp * kHbLd * 2          // K, V
         + (size_t)2 * 3 * kHbQ * kHbLd * 2  // two stages of Q, dO, O
         + (size_t)4 * kHbQ * (lp + 8) * 2   // P and dS, hi and lo
         + (size_t)(2 * 8 * kHbQ + kHbQ) * 4;  // row max, row sum, delta
}

// rows [r0, r0 + rows) of a [L, 64] head slice into a [rows, kHbLd] tile by
// cp.async over the CTA's threads, zeros for rows >= L
__device__ __forceinline__ void hb_load_rows(bf16* tile, const bf16* base, long long rs, int r0,
                                             int rows, int L) {
  for (int v = threadIdx.x; v < rows * 8; v += kHbThreads) {
    const int r = v >> 3;
    const int c = (v & 7) * 8;
    const bool ok = r0 + r < L;
    cp_async16(smem_u32(tile + r * kHbLd + c), base + (ok ? (long long)(r0 + r) * rs : 0) + c,
               ok ? 16 : 0);
  }
}

// the hi and lo bf16 halves of two f32 values, as packed pairs
__device__ __forceinline__ void hb_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

template <int LP>
__global__ void __launch_bounds__(kHbThreads, 1) attn_bwd_head_kernel(AttnBwdArgs a) {
  constexpr int NT = LP / 64;  // per warp: 8-key tiles for S and dP; 16-key tiles of dK, dV
  constexpr int PLD = LP + 8;  // row stride of the P / dS tiles
  constexpr int TILE = kHbQ * kHbLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + LP * kHbLd;
  bf16* stg = vs + LP * kHbLd;  // [2 stages][q, dO, o][kHbQ][kHbLd]
  bf16* ph = stg + 6 * TILE;    // P hi, P lo, dS hi, dS lo: [kHbQ][PLD] each
  bf16* pl = ph + kHbQ * PLD;
  bf16* sh = pl + kHbQ * PLD;
  bf16* sl = sh + kHbQ * PLD;
  float* red_max = reinterpret_cast<float*>(sl + kHbQ * PLD);  // [8 key groups][kHbQ]
  float* red_sum = red_max + 8 * kHbQ;
  float* delta_s = red_sum + 8 * kHbQ;

  const int L = a.lq;
  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;

  const bf16* qb = a.q + b * a.q_bs + h * kHbDH;
  const bf16* kb = a.k + b * a.k_bs + h * kHbDH;
  const bf16* vb = a.v + b * a.v_bs + h * kHbDH;
  const bf16* ob = a.o + b * a.o_bs + h * kHbDH;
  const bf16* db = a.dout + b * a.do_bs + h * kHbDH;

  auto load_tile = [&](int t, int st) {
    bf16* base = stg + st * 3 * TILE;
    hb_load_rows(base, qb, a.q_rs, t * kHbQ, kHbQ, L);
    hb_load_rows(base + TILE, db, a.do_rs, t * kHbQ, kHbQ, L);
    hb_load_rows(base + 2 * TILE, ob, a.o_rs, t * kHbQ, kHbQ, L);
  };
  hb_load_rows(ks, kb, a.k_rs, 0, LP, L);
  hb_load_rows(vs, vb, a.v_rs, 0, LP, L);
  load_tile(0, 0);
  cp_async_commit();

  // warp roles: scores (rows sr0.., keys key0..), dQ (rows sr0.., head
  // columns dn*8..), dK/dV (head columns dq4*16.., key tiles kt0 + 4i)
  const int sr0 = (warp & 1) * 16;
  const int key0 = (warp >> 1) * (LP / 8);
  const int dn = warp >> 1;
  const int dq4 = warp & 3;
  const int kt0 = warp >> 2;

  float dk[NT][2][4], dv[NT][2][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][n][e] = dv[i][n][e] = 0.0f;

  // ldmatrix lane offsets: A non-trans (row, col), B from a [n][k] tile
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  // A^T from a [k][m] tile (.trans): k row, m column
  const int at_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int at_col = ((lane >> 3) & 1) * 8;

  const int ntiles = (L + kHbQ - 1) / kHbQ;
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t (and K, V) landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) {
      load_tile(t + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* qs = stg + st * 3 * TILE;
    const bf16* dos = qs + TILE;
    const bf16* os = dos + TILE;

    {  // delta = rowsum(dO * O): 16 threads per row, 4 columns each
      const int r = tid >> 4;
      const int c = (tid & 15) * 4;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += bf2f(dos[r * kHbLd + c + j]) * bf2f(os[r * kHbLd + c + j]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((tid & 15) == 0) delta_s[r] = s;
    }

    // ---- S = Q K^T for rows sr0.., keys key0.. (raw sums)
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      uint32_t a0[4], a1[4];
      ldsm_x4(smem_u32(qs + (sr0 + a_row) * kHbLd + k2 * 32 + a_col), a0);
      ldsm_x4(smem_u32(qs + (sr0 + a_row) * kHbLd + k2 * 32 + 16 + a_col), a1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bb[4];  // keys key0 + 8j.., head columns k2*32 + 8m..
        ldsm_x4(smem_u32(ks + (key0 + j * 8 + (lane & 7)) * kHbLd + k2 * 32 + (lane >> 3) * 8), bb);
        mma_bf16(sc[j], a0, bb[0], bb[1]);
        mma_bf16(sc[j], a1, bb[2], bb[3]);
      }
    }

    // ---- P = exp(s - m) / l in f32, s = S * scale (keys >= L masked)
    float mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * qd + (e & 1);
        const float s = key < L ? sc[j][e] * a.scale : kNeg;
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (qd == 0) {
      red_max[(warp >> 1) * kHbQ + sr0 + g] = mx[0];
      red_max[(warp >> 1) * kHbQ + sr0 + g + 8] = mx[1];
    }
    __syncthreads();
    float m[2], l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = red_max[sr0 + g + 8 * i];
#pragma unroll
      for (int w = 1; w < 8; ++w) m[i] = fmaxf(m[i], red_max[w * kHbQ + sr0 + g + 8 * i]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(sc[j][e] - m[e >> 1]);
        sc[j][e] = x;
        l[e >> 1] += x;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if (qd == 0) {
      red_sum[(warp >> 1) * kHbQ + sr0 + g] = l[0];
      red_sum[(warp >> 1) * kHbQ + sr0 + g + 8] = l[1];
    }
    __syncthreads();
    float inv[2];  // P = e * (1 / l), as PyTorch's softmax normalizes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = red_sum[sr0 + g + 8 * i];
#pragma unroll
      for (int w = 1; w < 8; ++w) l[i] += red_sum[w * kHbQ + sr0 + g + 8 * i];
      inv[i] = 1.0f / l[i];
    }
    const float dl[2] = {delta_s[sr0 + g], delta_s[sr0 + g + 8]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = key0 + j * 8 + 2 * qd;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sc[j][2 * i] *= inv[i];
        sc[j][2 * i + 1] *= inv[i];
        uint32_t hi, lo;
        hb_split(sc[j][2 * i], sc[j][2 * i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(ph + (sr0 + g + 8 * i) * PLD + col) = hi;
        *reinterpret_cast<uint32_t*>(pl + (sr0 + g + 8 * i) * PLD + col) = lo;
      }
    }

    // ---- dP = dO V^T, then dS = P (dP - delta) * scale over P's registers
    {
      float dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.0f;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t a0[4], a1[4];
        ldsm_x4(smem_u32(dos + (sr0 + a_row) * kHbLd + k2 * 32 + a_col), a0);
        ldsm_x4(smem_u32(dos + (sr0 + a_row) * kHbLd + k2 * 32 + 16 + a_col), a1);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bb[4];
          ldsm_x4(smem_u32(vs + (key0 + j * 8 + (lane & 7)) * kHbLd + k2 * 32 + (lane >> 3) * 8),
                  bb);
          mma_bf16(dp[j], a0, bb[0], bb[1]);
          mma_bf16(dp[j], a1, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = key0 + j * 8 + 2 * qd;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d0 = sc[j][2 * i] * (dp[j][2 * i] - dl[i]) * a.scale;
          const float d1 = sc[j][2 * i + 1] * (dp[j][2 * i + 1] - dl[i]) * a.scale;
          uint32_t hi, lo;
          hb_split(d0, d1, hi, lo);
          *reinterpret_cast<uint32_t*>(sh + (sr0 + g + 8 * i) * PLD + col) = hi;
          *reinterpret_cast<uint32_t*>(sl + (sr0 + g + 8 * i) * PLD + col) = lo;
        }
      }
    }
    __syncthreads();  // P's and dS's hi and lo are complete

    // ---- dV += P^T dO and dK += dS^T Q: B (queries x 16 head columns)
    // once per tile
    {
      uint32_t bo[2][4], bq[2][4];
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        ldsm_x4_t(smem_u32(dos + (kq * 16 + a_row) * kHbLd + dq4 * 16 + a_col), bo[kq]);
        ldsm_x4_t(smem_u32(qs + (kq * 16 + a_row) * kHbLd + dq4 * 16 + a_col), bq[kq]);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int kt = kt0 + 4 * i;
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const int off = (kq * 16 + at_row) * PLD + kt * 16 + at_col;
          uint32_t ah[4], al[4];
          ldsm_x4_t(smem_u32(ph + off), ah);
          ldsm_x4_t(smem_u32(pl + off), al);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(dv[i][n], ah, bo[kq][2 * n], bo[kq][2 * n + 1]);
            mma_bf16(dv[i][n], al, bo[kq][2 * n], bo[kq][2 * n + 1]);
          }
          ldsm_x4_t(smem_u32(sh + off), ah);
          ldsm_x4_t(smem_u32(sl + off), al);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(dk[i][n], ah, bq[kq][2 * n], bq[kq][2 * n + 1]);
            mma_bf16(dk[i][n], al, bq[kq][2 * n], bq[kq][2 * n + 1]);
          }
        }
      }
    }

    // ---- dQ = dS K for rows sr0.., head columns dn*8.. : complete here
    // (the hi and lo products in two sums, added at the end)
    {
      float acc_h[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc_l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < LP / 16; kk += 2) {
        uint32_t bk[4];  // keys kk*16 + 8m.., head columns dn*8..
        ldsm_x4_t(smem_u32(ks + (kk * 16 + lane) * kHbLd + dn * 8), bk);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t ah[4], al[4];
          const int off = (sr0 + a_row) * PLD + (kk + u) * 16 + a_col;
          ldsm_x4(smem_u32(sh + off), ah);
          ldsm_x4(smem_u32(sl + off), al);
          mma_bf16(acc_h, ah, bk[2 * u], bk[2 * u + 1]);
          mma_bf16(acc_l, al, bk[2 * u], bk[2 * u + 1]);
        }
      }
      bf16* dqb = a.dq + b * a.dq_bs + h * kHbDH + dn * 8 + 2 * qd;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = t * kHbQ + sr0 + g + 8 * i;
        if (row < L)
          *reinterpret_cast<uint32_t*>(dqb + (long long)row * a.dq_rs) =
              pack_bf16(acc_h[2 * i] + acc_l[2 * i], acc_h[2 * i + 1] + acc_l[2 * i + 1]);
      }
    }
  }

  // ---- dK, dV out (bf16), once: staged over K and V in shared memory, then
  // written in 16-byte rows
  __syncthreads();  // every warp is done reading K and V
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = ((kt0 + 4 * i) * 16 + g + 8 * r) * kHbLd + dq4 * 16 + n * 8 + 2 * qd;
        *reinterpret_cast<uint32_t*>(ks + at) = pack_bf16(dk[i][n][2 * r], dk[i][n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(vs + at) = pack_bf16(dv[i][n][2 * r], dv[i][n][2 * r + 1]);
      }
  __syncthreads();
  bf16* dkb = a.dk + b * a.dk_bs + h * kHbDH;
  bf16* dvb = a.dv + b * a.dv_bs + h * kHbDH;
  for (int v = tid; v < L * 8; v += kHbThreads) {
    const int r = v >> 3;
    const int c = (v & 7) * 8;
    copy8(dkb + (long long)r * a.dk_rs + c, ks + r * kHbLd + c);
    copy8(dvb + (long long)r * a.dv_rs + c, vs + r * kHbLd + c);
  }
}

template <int LP>
cudaError_t launch_attn_bwd_head_lp(const AttnBwdArgs& a, int batch, cudaStream_t st) {
  // once per process (one card): the kernel's dynamic shared memory limit
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bwd_head_kernel<LP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hb_smem(LP));
  if (attr != cudaSuccess) return attr;
  attn_bwd_head_kernel<LP><<<batch * a.heads, kHbThreads, hb_smem(LP), st>>>(a);
  return cudaGetLastError();
}

// unmasked self attention, 1 <= L <= kHbMaxL, head dim 64
inline cudaError_t launch_attention_bwd_head(const AttnBwdArgs& a, int batch,
                                             cudaStream_t st) {
  if (a.lq != a.lk || a.lq < 1 || a.lq > kHbMaxL || a.mask != nullptr || batch < 1 ||
      a.dh != kHbDH)
    return cudaErrorInvalidValue;
  switch (round_up(a.lq, 64)) {
    case 64: return launch_attn_bwd_head_lp<64>(a, batch, st);
    case 128: return launch_attn_bwd_head_lp<128>(a, batch, st);
    case 192: return launch_attn_bwd_head_lp<192>(a, batch, st);
    default: return launch_attn_bwd_head_lp<256>(a, batch, st);
  }
}

// registers per thread, shared memory per CTA (static + dynamic) and local
// (spill) bytes per thread of the instance that takes L tokens
template <int LP>
cudaError_t attn_bwd_head_attrs(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, attn_bwd_head_kernel<LP>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + hb_smem(LP));
  out[2] = (int)fa.localSizeBytes;
  return cudaSuccess;
}

}  // namespace crog
