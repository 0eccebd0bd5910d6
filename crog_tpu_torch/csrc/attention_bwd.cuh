// Softmax attention backward for head dim 64, in two kernels.
//
// Replaces the backward Pallas kernel `_bwd_kernel` of
// crog_tpu/ops/pallas_attention.py:53 (pallas_call at :140, K1b) and the
// all-head attention backward `_mha_bwd` inside the decoder block backward
// kernels (crog_tpu/ops/pallas_decoder.py:126, K2b/K3b).  The two differ in
// their cast points, so the mode is a template parameter:
//   kBwdF32  (K1b): P, dP, dS in f32, delta = rowsum(dO * O); the f32
//                   operands of dV = P^T dO, dQ = dS K and dK = dS^T Q are
//                   split into bf16 hi + lo halves, so the tensor-core
//                   products keep about 16 bits of the f32 value (the
//                   output is rounded to bf16's 8 anyway);
//   kBwdBf16 (K2b/K3b): P and dS rounded to bf16 before their products,
//                   delta = rowsum(dP * P) on the f32 P.
// Per (batch, head), with s = q k^T * scale + mask:
//   P = exp(s - m) / l            (m, l: row max and sum, as the forward)
//   dP = dO V^T,  dS = P (dP - delta) * scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
//
// Bound on an H100: 2.5x the forward's products (five [L, L, 64] products
// against the forward's two) over q, k, v, o, dO in and dq, dk, dv out.  At
// the CLIP attention pool (B=24, 32 heads, L=169) that is 14 GFLOP against
// 133 MB: memory-bound, about 40 us.
//
// Design.  Hopper blocks cannot carry a sum from one grid step to the next
// as the TPU's sequential grid does, and dK/dV sum over queries while dQ
// sums over keys.  So, as FlashAttention-2 does, one kernel owns query rows
// and one owns key rows; neither uses atomics, so the result is the same in
// every run.
//   attn_bwd_rows: a block of 4 warps takes 64 query rows of one head,
//     keeps their whole [64, Lk] score block in shared memory (Lk <= 768,
//     as the forward), recomputes P exactly as the forward did, forms delta
//     and dS in place, and writes dQ plus the row statistics (m, l, delta)
//     for the second kernel.
//   attn_bwd_cols: a block takes 64 key rows of one head, walks the query
//     tiles, rebuilds P^T and dS^T for its keys from those statistics, and
//     accumulates dK and dV in registers.
#pragma once

#include "common.cuh"

namespace crog {

enum AttnBwdMode { kBwdF32 = 0, kBwdBf16 = 1 };

constexpr int kAbBQ = 64;             // rows per block (queries or keys)
constexpr int kAbDH = 64;             // head dim
constexpr int kAbLdT = kAbDH + 8;     // bf16 tile row stride
constexpr int kAbMaxLk = 768;
constexpr int kAbTileBytes = kAbBQ * kAbLdT * 2;  // 9216
constexpr int kAbStLd = 36;           // row kernel: per-warp [16, 32] f32 staging
constexpr int kAbCsLd = 68;           // col kernel: per-warp [16, 64] f32 staging

struct AttnBwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;      // kBwdF32 only (delta = rowsum(dO * O))
  const bf16* dout;
  const float* mask;  // [B, Lk] additive, or nullptr
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* stats;       // [3][B*H][Lq]: row max, row sum, delta
  int heads, lq, lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;  // in elements
  float scale;
};

__host__ __device__ inline int ab_score_ld(int lk) { return round_up(lk, kAbBQ) + 8; }

__host__ __device__ inline size_t ab_rows_smem(int lk) {
  return 2 * kAbTileBytes + 3 * kAbBQ * sizeof(float) +
         (size_t)kAbBQ * ab_score_ld(lk) * sizeof(float);
}

constexpr size_t kAbColsSmem =
    2 * kAbTileBytes + 3 * kAbBQ * sizeof(float) +
    4 * (2 * 16 * kAbCsLd * sizeof(float) + 4 * 16 * kAbLdT * sizeof(bf16));

// rows [r0, r0+64) of a [L, 64] head slice into a [64, kAbLdT] tile, zero
// rows >= L
__device__ __forceinline__ void ab_load_tile(bf16* tile, const bf16* base, long long rs,
                                             int r0, int L) {
  for (int v = threadIdx.x; v < kAbBQ * (kAbDH / 8); v += blockDim.x) {
    const int r = v / (kAbDH / 8);
    const int c = (v % (kAbDH / 8)) * 8;
    if (r0 + r < L) {
      copy8(tile + r * kAbLdT + c, base + (long long)(r0 + r) * rs + c);
    } else {
      zero8(tile + r * kAbLdT + c);
    }
  }
}

// ------------------------------------------------------------- rows
template <int MODE>
__global__ void __launch_bounds__(128) attn_bwd_rows_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q, then dO, then staging
  bf16* kvs = reinterpret_cast<bf16*>(smem_raw + kAbTileBytes);
  float* rstat = reinterpret_cast<float*>(smem_raw + 2 * kAbTileBytes);  // m, l, delta
  float* sc = rstat + 3 * kAbBQ;

  const int lkp = round_up(a.lk, kAbBQ);
  const int ls = lkp + 8;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kAbBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  float* stg = reinterpret_cast<float*>(qs) + warp * 16 * kAbStLd;

  const bf16* qb = a.q + b * a.q_bs + h * kAbDH;
  const bf16* kb = a.k + b * a.k_bs + h * kAbDH;
  const bf16* vb = a.v + b * a.v_bs + h * kAbDH;
  const bf16* db = a.dout + b * a.do_bs + h * kAbDH;

  // ---- raw scores S[64, lkp] = Q K^T into sc (the forward's sums)
  ab_load_tile(qs, qb, a.q_rs, q0, a.lq);
  __syncthreads();
  {
    FragA fq[kAbDH / 16];
#pragma unroll
    for (int kk = 0; kk < kAbDH / 16; ++kk)
      wmma::load_matrix_sync(fq[kk], qs + r0 * kAbLdT + kk * 16, kAbLdT);
    for (int kt = 0; kt < lkp; kt += kAbBQ) {
      ab_load_tile(kvs, kb, a.k_rs, kt, a.lk);
      __syncthreads();
      FragC acc[kAbBQ / 16];
#pragma unroll
      for (int j = 0; j < kAbBQ / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < kAbDH / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < kAbBQ / 16; ++j) {
          FragBCol fk;
          wmma::load_matrix_sync(fk, kvs + (j * 16) * kAbLdT + kk * 16, kAbLdT);
          wmma::mma_sync(acc[j], fq[kk], fk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kAbBQ / 16; ++j)
        wmma::store_matrix_sync(sc + r0 * ls + kt + j * 16, acc[j], ls,
                                wmma::mem_row_major);
      __syncthreads();
    }
  }

  // ---- dO tile into qs, fragments into registers
  ab_load_tile(qs, db, a.do_rs, q0, a.lq);
  __syncthreads();
  FragA fdo[kAbDH / 16];
#pragma unroll
  for (int kk = 0; kk < kAbDH / 16; ++kk)
    wmma::load_matrix_sync(fdo[kk], qs + r0 * kAbLdT + kk * 16, kAbLdT);
  __syncthreads();  // qs is staging from here on

  // ---- P = exp(s - m) / l in place, f32 (the forward's arithmetic)
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
      const float e = c < a.lk ? expf(srow[c] - m) : 0.0f;
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int c = lane; c < lkp; c += 32) srow[c] = srow[c] / l;
    if (lane == 0) {
      rstat[r0 + r] = m;
      rstat[kAbBQ + r0 + r] = l;
    }
  }
  __syncwarp();

  // dP for this warp's 16 rows against keys [kt + 32 half, +32) into stg
  auto dp_half = [&](int half) {
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kAbDH / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBCol fv;  // element (d, key) at kvs[key * ld + d]
        wmma::load_matrix_sync(fv, kvs + (half * 32 + j * 16) * kAbLdT + kk * 16, kAbLdT);
        wmma::mma_sync(acc[j], fdo[kk], fv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(stg + j * 16, acc[j], kAbStLd, wmma::mem_row_major);
    __syncwarp();
  };

  // ---- delta per row
  float delta[16];
  if (MODE == kBwdF32) {
    const bf16* ob = a.o + b * a.o_bs + h * kAbDH;
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + r0 + r;
      float t = 0.0f;
      if (row < a.lq) {
        for (int c = lane; c < kAbDH; c += 32)
          t += bf2f(db[(long long)row * a.do_rs + c]) * bf2f(ob[(long long)row * a.o_rs + c]);
      }
      delta[r] = warp_sum(t);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) delta[r] = 0.0f;
    for (int kt = 0; kt < lkp; kt += kAbBQ) {
      ab_load_tile(kvs, vb, a.v_rs, kt, a.lk);
      __syncthreads();
      for (int half = 0; half < 2; ++half) {
        dp_half(half);
        const int c = kt + half * 32 + lane;
#pragma unroll
        for (int r = 0; r < 16; ++r)
          delta[r] += stg[r * kAbStLd + lane] * sc[(r0 + r) * ls + c];
        __syncwarp();
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) delta[r] = warp_sum(delta[r]);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) rstat[2 * kAbBQ + r0 + r] = delta[r];
  }

  // ---- dS = P (dP - delta) * scale, in place over P (f32)
  for (int kt = 0; kt < lkp; kt += kAbBQ) {
    ab_load_tile(kvs, vb, a.v_rs, kt, a.lk);
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      dp_half(half);
      const int c = kt + half * 32 + lane;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float* p = sc + (r0 + r) * ls + c;
        *p = c < a.lk ? *p * (stg[r * kAbStLd + lane] - delta[r]) * a.scale : 0.0f;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // ---- dS to bf16 operands over the same rows: hi at bf16 [0, lkp),
  // and for kBwdF32 lo = bf16(dS - hi) at bf16 [ls + 8, ls + 8 + lkp)
  constexpr int kPer = kAbMaxLk / 32;
  for (int r = 0; r < 16; ++r) {
    float* srow = sc + (r0 + r) * ls;
    float vals[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) vals[i] = (i * 32 + lane < lkp) ? srow[i * 32 + lane] : 0.f;
    __syncwarp();
    bf16* hrow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = i * 32 + lane;
      if (c < lkp) {
        const bf16 hi = f2bf(vals[i]);
        hrow[c] = hi;
        if (MODE == kBwdF32) hrow[ls + 8 + c] = f2bf(vals[i] - bf2f(hi));
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- dQ = dS K
  FragC dqacc[kAbDH / 16];
#pragma unroll
  for (int j = 0; j < kAbDH / 16; ++j) wmma::fill_fragment(dqacc[j], 0.0f);
  const bf16* dsw = reinterpret_cast<const bf16*>(sc + r0 * ls);
  for (int kt = 0; kt < lkp; kt += kAbBQ) {
    ab_load_tile(kvs, kb, a.k_rs, kt, a.lk);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kAbBQ / 16; ++kk) {
      FragA fs, fsl;
      wmma::load_matrix_sync(fs, dsw + kt + kk * 16, 2 * ls);
      if (MODE == kBwdF32) wmma::load_matrix_sync(fsl, dsw + ls + 8 + kt + kk * 16, 2 * ls);
#pragma unroll
      for (int j = 0; j < kAbDH / 16; ++j) {
        FragBRow fk;  // element (key, d) at kvs[key * ld + d]
        wmma::load_matrix_sync(fk, kvs + (kk * 16) * kAbLdT + j * 16, kAbLdT);
        wmma::mma_sync(dqacc[j], fs, fk, dqacc[j]);
        if (MODE == kBwdF32) wmma::mma_sync(dqacc[j], fsl, fk, dqacc[j]);
      }
    }
    __syncthreads();
  }

  // ---- stage and store dQ (bf16) and the row statistics
  float* ostage = sc + r0 * ls;
#pragma unroll
  for (int j = 0; j < kAbDH / 16; ++j)
    wmma::store_matrix_sync(ostage + j * 16, dqacc[j], ls, wmma::mem_row_major);
  __syncwarp();
  bf16* dqb = a.dq + b * a.dq_bs + h * kAbDH;
  for (int e = lane; e < 16 * kAbDH; e += 32) {
    const int r = e / kAbDH;
    const int c = e % kAbDH;
    const int row = q0 + r0 + r;
    if (row < a.lq) dqb[(long long)row * a.dq_rs + c] = f2bf(ostage[r * ls + c]);
  }
  if (lane < 16) {
    const int row = q0 + r0 + lane;
    if (row < a.lq) {
      const long long n = (long long)gridDim.y * a.lq;
      float* st = a.stats + (long long)bh * a.lq + row;
      st[0] = rstat[r0 + lane];
      st[n] = rstat[kAbBQ + r0 + lane];
      st[2 * n] = rstat[2 * kAbBQ + r0 + lane];
    }
  }
}

// ------------------------------------------------------------- cols
template <int MODE>
__global__ void __launch_bounds__(128) attn_bwd_cols_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* t0 = reinterpret_cast<bf16*>(smem_raw);                 // k, then q tiles
  bf16* t1 = reinterpret_cast<bf16*>(smem_raw + kAbTileBytes);  // v, then dO tiles
  float* qstat = reinterpret_cast<float*>(smem_raw + 2 * kAbTileBytes);  // m, l, delta
  unsigned char* wbase = smem_raw + 2 * kAbTileBytes + 3 * kAbBQ * sizeof(float);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t per_warp = 2 * 16 * kAbCsLd * sizeof(float) + 4 * 16 * kAbLdT * sizeof(bf16);
  float* sst = reinterpret_cast<float*>(wbase + warp * per_warp);  // S^T [16, 64]
  float* pst = sst + 16 * kAbCsLd;                                 // dP^T [16, 64]
  bf16* ph = reinterpret_cast<bf16*>(pst + 16 * kAbCsLd);          // P^T hi
  bf16* pl = ph + 16 * kAbLdT;                                     // P^T lo
  bf16* dsh = pl + 16 * kAbLdT;                                    // dS^T hi
  bf16* dsl = dsh + 16 * kAbLdT;                                   // dS^T lo

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int k0 = blockIdx.x * kAbBQ;
  const int kr = warp * 16;  // this warp's keys [k0 + kr, +16)

  const bf16* qb = a.q + b * a.q_bs + h * kAbDH;
  const bf16* kb = a.k + b * a.k_bs + h * kAbDH;
  const bf16* vb = a.v + b * a.v_bs + h * kAbDH;
  const bf16* db = a.dout + b * a.do_bs + h * kAbDH;
  const long long n = (long long)gridDim.y * a.lq;
  const float* stb = a.stats + (long long)bh * a.lq;
  const float* mrow = a.mask ? a.mask + (long long)b * a.lk : nullptr;

  ab_load_tile(t0, kb, a.k_rs, k0, a.lk);
  ab_load_tile(t1, vb, a.v_rs, k0, a.lk);
  __syncthreads();
  FragA fk[kAbDH / 16], fv[kAbDH / 16];
#pragma unroll
  for (int kk = 0; kk < kAbDH / 16; ++kk) {
    wmma::load_matrix_sync(fk[kk], t0 + kr * kAbLdT + kk * 16, kAbLdT);
    wmma::load_matrix_sync(fv[kk], t1 + kr * kAbLdT + kk * 16, kAbLdT);
  }
  FragC dkacc[kAbDH / 16], dvacc[kAbDH / 16];
#pragma unroll
  for (int j = 0; j < kAbDH / 16; ++j) {
    wmma::fill_fragment(dkacc[j], 0.0f);
    wmma::fill_fragment(dvacc[j], 0.0f);
  }

  for (int q0 = 0; q0 < a.lq; q0 += kAbBQ) {
    __syncthreads();  // every warp is done with the previous tiles
    ab_load_tile(t0, qb, a.q_rs, q0, a.lq);
    ab_load_tile(t1, db, a.do_rs, q0, a.lq);
    for (int i = threadIdx.x; i < kAbBQ; i += blockDim.x) {
      const bool ok = q0 + i < a.lq;
      qstat[i] = ok ? stb[q0 + i] : 0.0f;
      qstat[kAbBQ + i] = ok ? stb[n + q0 + i] : 1.0f;
      qstat[2 * kAbBQ + i] = ok ? stb[2 * n + q0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    {
      FragC sacc[kAbBQ / 16], pacc[kAbBQ / 16];
#pragma unroll
      for (int j = 0; j < kAbBQ / 16; ++j) {
        wmma::fill_fragment(sacc[j], 0.0f);
        wmma::fill_fragment(pacc[j], 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < kAbDH / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < kAbBQ / 16; ++j) {
          FragBCol fb;  // element (d, query) at tile[query * ld + d]
          wmma::load_matrix_sync(fb, t0 + (j * 16) * kAbLdT + kk * 16, kAbLdT);
          wmma::mma_sync(sacc[j], fk[kk], fb, sacc[j]);
          wmma::load_matrix_sync(fb, t1 + (j * 16) * kAbLdT + kk * 16, kAbLdT);
          wmma::mma_sync(pacc[j], fv[kk], fb, pacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kAbBQ / 16; ++j) {
        wmma::store_matrix_sync(sst + j * 16, sacc[j], kAbCsLd, wmma::mem_row_major);
        wmma::store_matrix_sync(pst + j * 16, pacc[j], kAbCsLd, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // P^T, dS^T elementwise, rounded to the bf16 operands
    for (int e = lane; e < 16 * kAbBQ; e += 32) {
      const int r = e / kAbBQ;  // key within the warp's 16
      const int c = e % kAbBQ;  // query within the tile
      const int key = k0 + kr + r;
      const bool ok = key < a.lk && q0 + c < a.lq;
      float p = 0.0f, ds = 0.0f;
      if (ok) {
        float s = sst[r * kAbCsLd + c] * a.scale;
        if (mrow) s += mrow[key];
        p = expf(s - qstat[c]) / qstat[kAbBQ + c];
        ds = p * (pst[r * kAbCsLd + c] - qstat[2 * kAbBQ + c]) * a.scale;
      }
      const bf16 phi = f2bf(p);
      const bf16 dhi = f2bf(ds);
      ph[r * kAbLdT + c] = phi;
      dsh[r * kAbLdT + c] = dhi;
      if (MODE == kBwdF32) {
        pl[r * kAbLdT + c] = f2bf(p - bf2f(phi));
        dsl[r * kAbLdT + c] = f2bf(ds - bf2f(dhi));
      }
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kAbBQ / 16; ++kk) {
      FragA fp, fs, fpl, fsl;
      wmma::load_matrix_sync(fp, ph + kk * 16, kAbLdT);
      wmma::load_matrix_sync(fs, dsh + kk * 16, kAbLdT);
      if (MODE == kBwdF32) {
        wmma::load_matrix_sync(fpl, pl + kk * 16, kAbLdT);
        wmma::load_matrix_sync(fsl, dsl + kk * 16, kAbLdT);
      }
#pragma unroll
      for (int j = 0; j < kAbDH / 16; ++j) {
        FragBRow fb;  // element (query, d) at tile[query * ld + d]
        wmma::load_matrix_sync(fb, t1 + (kk * 16) * kAbLdT + j * 16, kAbLdT);
        wmma::mma_sync(dvacc[j], fp, fb, dvacc[j]);
        if (MODE == kBwdF32) wmma::mma_sync(dvacc[j], fpl, fb, dvacc[j]);
        wmma::load_matrix_sync(fb, t0 + (kk * 16) * kAbLdT + j * 16, kAbLdT);
        wmma::mma_sync(dkacc[j], fs, fb, dkacc[j]);
        if (MODE == kBwdF32) wmma::mma_sync(dkacc[j], fsl, fb, dkacc[j]);
      }
    }
  }

  // ---- dK, dV through the warp's f32 staging, bf16 out
  bf16* dkb = a.dk + b * a.dk_bs + h * kAbDH;
  bf16* dvb = a.dv + b * a.dv_bs + h * kAbDH;
#pragma unroll
  for (int j = 0; j < kAbDH / 16; ++j) {
    wmma::store_matrix_sync(sst + j * 16, dkacc[j], kAbCsLd, wmma::mem_row_major);
    wmma::store_matrix_sync(pst + j * 16, dvacc[j], kAbCsLd, wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kAbDH; e += 32) {
    const int r = e / kAbDH;
    const int c = e % kAbDH;
    const int key = k0 + kr + r;
    if (key < a.lk) {
      dkb[(long long)key * a.dk_rs + c] = f2bf(sst[r * kAbCsLd + c]);
      dvb[(long long)key * a.dv_rs + c] = f2bf(pst[r * kAbCsLd + c]);
    }
  }
}

template <int MODE>
inline cudaError_t launch_attention_bwd(const AttnBwdArgs& a, int batch,
                                        cudaStream_t stream) {
  if (a.lk > kAbMaxLk || a.lk < 1 || a.lq < 1) return cudaErrorInvalidValue;
  const size_t rows_smem = ab_rows_smem(a.lk);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_rows_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)rows_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_cols_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kAbColsSmem);
  if (err != cudaSuccess) return err;
  dim3 grid_rows((a.lq + kAbBQ - 1) / kAbBQ, batch * a.heads);
  attn_bwd_rows_kernel<MODE><<<grid_rows, 128, rows_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_cols((a.lk + kAbBQ - 1) / kAbBQ, batch * a.heads);
  attn_bwd_cols_kernel<MODE><<<grid_cols, 128, kAbColsSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace crog
