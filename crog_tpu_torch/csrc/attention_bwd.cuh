// Softmax attention backward for head dims 8-512, in two kernels.
//
// Replaces the backward Pallas kernel `_bwd_kernel` of
// crog_tpu/ops/pallas_attention.py:53 (pallas_call at :140, K1b, for heads
// the one-CTA-per-head kernel of attention_bwd_head.cuh does not take)
// and the all-head attention backward `_mha_bwd` inside the decoder block
// backward kernels (crog_tpu/ops/pallas_decoder.py:126, K2b/K3b).  The two
// differ in their cast points, so the mode is a template parameter:
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
// Head dims.  The head tile DH (a template parameter: 32, 64 or 128,
// attn_head_tile) sets every tile's width and every register array over
// the head dim; the head's own width dh (8 to DH, a multiple of 8) is a
// run-time value: the loads zero-fill the columns dh .. DH - 1 in shared
// memory (so they add nothing to QK^T and dO V^T, and dQ, dK, dV come out
// zero there) and the stores skip them, so dh 8 and 16 run in the DH = 32
// instantiation.  Nothing is padded in device memory.  Head tiles 256 and
// 512 run the wide rows / cols kernels (below).
//
// Bound on an H100 at the decoder's self block (B = 24, 8 heads, L = 676):
// five [L, L, 64] products, 56 GFLOP, 0.057 ms at the bf16 peak, against
// 58 MB of q, k, v, dO in and dq, dk, dv out, 0.017 ms: the products bound
// it (the FLOPs and bytes do not depend on dh at a fixed model width).
// This design does nine product units (S three times, dP twice), and its
// per-element softmax work (an exp2 per score and pass, the casts) costs
// about as much as the products.
//
// Design.  Hopper blocks cannot carry a sum from one grid step to the next
// as the TPU's sequential grid does, and dK/dV sum over queries while dQ
// sums over keys.  So, as FlashAttention-2 does, one kernel owns query rows
// and one owns key rows; neither uses atomics, so the result is the same in
// every run.  Both keep every score tile in registers (ldmatrix + mma.sync
// m16n8k16, bf16 operands, f32 sums; the C fragments of S become the A
// fragments of the next product without leaving the thread) and stream
// their operand tiles through a two-stage cp.async ring, so a tile's loads
// run behind the previous tile's products.  Scores are taken in the log2
// domain (s * log2(e)), so each exponential is one exp2, and normalized by
// a reciprocal.  At DH 64 shared memory is 55-57 KB and registers at most
// 168, so three CTAs of 4 warps share an SM.
//   attn_bwd_rows: 4 warps take 64 query rows of one head, 16 each, and
//     walk the key tiles twice.  The first pass keeps each row's running
//     max and sum and (kBwdBf16) the running sum of dP exp2(s - max), all
//     rescaled when the max grows, which gives delta = rowsum(dP * P) in
//     the same pass (kBwdF32: delta = rowsum(dO * O) from dO and O).  The
//     second forms dS and accumulates dQ = dS K in registers.  It writes dQ
//     and the row statistics (max, 1 / sum, delta).
//   attn_bwd_cols: 4 warps take 64 key rows of one head, 16 each, and walk
//     the query tiles with their saved row statistics (flash-style): S^T =
//     K Q^T and dP^T = V dO^T in registers, P^T and dS^T from them, and dV
//     += P^T dO, dK += dS^T Q accumulated in registers across all query
//     tiles.  A CTA owns at most 64 of dK's and dV's head columns: at DH
//     128 two CTAs (grid z) take the two halves of a key block, each
//     forming S^T and dP^T over the whole head, so that the accumulators
//     stay at DH 64's registers.
// Key and query n-tiles past the last row are skipped (the cross block's 17
// keys take three of a tile's eight).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace crog {

enum AttnBwdMode { kBwdF32 = 0, kBwdBf16 = 1 };

constexpr int kAbBQ = 64;  // rows per block (queries or keys), and per tile

// bf16 row stride of a tile of head tile DH (conflict-free ldmatrix), and
// the elements of one [64, DH] tile
template <int DH>
struct AbTile {
  static constexpr int kLd = DH + 8;
  static constexpr int kElems = kAbBQ * kLd;
};

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
  float* stats;       // [3][B*H][Lq]: row max, 1 / row sum, delta (attn_bwd_rows)
  int heads, lq, lk;
  int dh;             // head dim; head h's columns are [h * dh, (h + 1) * dh)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;  // in elements
  float scale;
};

constexpr int kAbThreads = 128;  // 4 warps, 16 rows each
template <int DH>
__host__ __device__ constexpr size_t ab_rows_smem() {
  return 6 * AbTile<DH>::kElems * sizeof(bf16);
}
template <int DH>
__host__ __device__ constexpr size_t ab_cols_smem() {
  return 6 * AbTile<DH>::kElems * sizeof(bf16) + 2 * 3 * kAbBQ * sizeof(float);
}
// head columns of dK and dV one cols-kernel CTA owns
template <int DH>
__host__ __device__ constexpr int ab_cols_width() {
  return DH < 64 ? DH : 64;
}

// rows [r0, r0 + rows) of a head slice of dh columns (row stride rs) into a
// [rows, DH + 8] tile by cp.async over THREADS threads: zeros for rows >= L
// and for the columns dh .. DH - 1 (a head narrower than its tile)
template <int THREADS, int DH>
__device__ __forceinline__ void ab_load_rows(bf16* tile, const bf16* base, long long rs,
                                             int r0, int rows, int L, int dh) {
  constexpr int C = DH / 8;  // 16-byte chunks per row
  for (int v = threadIdx.x; v < rows * C; v += THREADS) {
    const int r = (unsigned)v / C;
    const int c = ((unsigned)v % C) * 8;
    const bool ok = r0 + r < L && c < dh;
    cp_async16(smem_u32(tile + r * AbTile<DH>::kLd + c),
               base + (ok ? (long long)(r0 + r) * rs : 0) + (c < dh ? c : 0), ok ? 16 : 0);
  }
}

template <int DH>
__device__ __forceinline__ void ab_load_async(bf16* tile, const bf16* base, long long rs,
                                              int r0, int L, int dh) {
  ab_load_rows<kAbThreads, DH>(tile, base, rs, r0, kAbBQ, L, dh);
}

// acc[j] (16 rows x 8 columns each) = rows r0.. of tile A times rows 8j.. of
// tile B, transposed: A [., DH] and B [64, DH] both row-major with the head
// dim inner, j < nv (the later n-tiles are left as they are)
template <int DH>
__device__ __forceinline__ void ab_nt(float (&acc)[8][4], const bf16* A, int r0, const bf16* B,
                                      int nv) {
  constexpr int LD = AbTile<DH>::kLd;
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
#pragma unroll
  for (int k2 = 0; k2 < DH / 32; ++k2) {
    uint32_t a0[4], a1[4];
    ldsm_x4(smem_u32(A + (r0 + a_row) * LD + k2 * 32 + a_col), a0);
    ldsm_x4(smem_u32(A + (r0 + a_row) * LD + k2 * 32 + 16 + a_col), a1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nv) {
        uint32_t bb[4];
        ldsm_x4(smem_u32(B + (j * 8 + (lane & 7)) * LD + k2 * 32 + (lane >> 3) * 8), bb);
        mma_bf16(acc[j], a0, bb[0], bb[1]);
        mma_bf16(acc[j], a1, bb[2], bb[3]);
      }
    }
  }
}

// acc (16 rows x NC head columns c0.. as NC / 8 C fragments) += a (16 x 16)
// times rows k0..k0+15 of the row-major [64, DH] tile B
template <int DH, int NC>
__device__ __forceinline__ void ab_nn(float (&acc)[NC / 8][4], const uint32_t (&a)[4],
                                      const bf16* B, int k0, int c0) {
  constexpr int LD = AbTile<DH>::kLd;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n2 = 0; n2 < NC / 16; ++n2) {
    uint32_t r[4];
    ldsm_x4_t(smem_u32(B + (k0 + (lane & 15)) * LD + c0 + (2 * n2 + (lane >> 4)) * 8), r);
    mma_bf16(acc[2 * n2], a, r[0], r[1]);
    mma_bf16(acc[2 * n2 + 1], a, r[2], r[3]);
  }
}

// the A fragment of k-step kk from the f32 C fragments of n-tiles 2kk and
// 2kk + 1: bf16(x), and for kBwdF32 also bf16(x - bf16(x))
template <int MODE>
__device__ __forceinline__ void ab_frag(const float (&c)[8][4], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float x0 = c[2 * kk + (u >> 1)][2 * (u & 1)];
    const float x1 = c[2 * kk + (u >> 1)][2 * (u & 1) + 1];
    hi[u] = pack_bf16(x0, x1);
    if (MODE == kBwdF32) {
      const float2 h = unpack_bf16(hi[u]);
      lo[u] = pack_bf16(x0 - h.x, x1 - h.y);
    }
  }
}

// acc += P B[:, c0 .. c0 + NC) for k-steps kk with 2kk < nv (the product of
// every live key or query n-tile), P in f32 C fragments: hi (and lo) halves
template <int MODE, int DH, int NC>
__device__ __forceinline__ void ab_nn_all(float (&acc)[NC / 8][4], const float (&p)[8][4],
                                          const bf16* B, int nv, int c0 = 0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (2 * kk < nv) {
      uint32_t hi[4], lo[4];
      ab_frag<MODE>(p, kk, hi, lo);
      ab_nn<DH, NC>(acc, hi, B, kk * 16, c0);
      if (MODE == kBwdF32) ab_nn<DH, NC>(acc, lo, B, kk * 16, c0);
    }
  }
}

template <int N>
__device__ __forceinline__ void ab_zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// this thread's bf16 pairs of C fragments [N][4] (rows g, g + 8 of a warp's
// 16 from row0, columns c0 + 8j + 2qd) into rows < nrows of a row-major
// [., rs] slice, the columns past dh skipped
template <int N>
__device__ __forceinline__ void ab_store_pairs(const float (&c)[N][4], bf16* base, long long rs,
                                               int row0, int nrows, int c0, int dh) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c0 + j * 8 < dh)
        *reinterpret_cast<uint32_t*>(base + (long long)row * rs + c0 + j * 8 + 2 * (lane & 3)) =
            pack_bf16(c[j][2 * r], c[j][2 * r + 1]);
  }
}

// ------------------------------------------------------------- rows
// The row statistics kept for the cols kernel, per query row: the row max of
// s * log2(e), the reciprocal of the row sum of exp2(s * log2(e) - max), and
// delta.  Scores are taken in the log2 domain so that each exponential is one
// exp2 (the same function as exp(s - m), rounded differently).
constexpr float kLog2e = 1.4426950408889634f;

template <int MODE, int DH>
__global__ void __launch_bounds__(kAbThreads) attn_bwd_rows_kernel(AttnBwdArgs a) {
  constexpr int TILE = AbTile<DH>::kElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TILE;
  bf16* ring = dos + TILE;  // [2 stages][K, V]

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kAbBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int r0 = warp * 16;
  const int dh = attn_run_dh<DH>(a.dh);

  const bf16* qb = a.q + b * a.q_bs + h * dh;
  const bf16* kb = a.k + b * a.k_bs + h * dh;
  const bf16* vb = a.v + b * a.v_bs + h * dh;
  const bf16* db = a.dout + b * a.do_bs + h * dh;
  const float* mrow = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const float sl2 = a.scale * kLog2e;
  const int T = (a.lk + kAbBQ - 1) / kAbBQ;
  // two passes over the key tiles: the statistics (kBwdBf16: with delta),
  // then dS and dQ.  V is needed in the first pass for delta = rowsum(dP * P)
  // (kBwdBf16) and in the second for dP.
  auto load = [&](int i) {
    bf16* st = ring + (i & 1) * 2 * TILE;
    ab_load_async<DH>(st, kb, a.k_rs, (i % T) * kAbBQ, a.lk, dh);
    if (MODE == kBwdBf16 || i >= T)
      ab_load_async<DH>(st + TILE, vb, a.v_rs, (i % T) * kAbBQ, a.lk, dh);
  };
  ab_load_async<DH>(qs, qb, a.q_rs, q0, a.lq, dh);
  ab_load_async<DH>(dos, db, a.do_rs, q0, a.lq, dh);
  load(0);
  cp_async_commit();

  // per thread: rows r0 + g and r0 + g + 8, columns 2qd.. of each n-tile;
  // running max, sum and (kBwdBf16) sum of dP exp2(s - max)
  float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};
  if (MODE == kBwdF32) {  // delta = rowsum(dO * O): two lanes per row, DH / 2 columns each
    const bf16* ob = a.o + b * a.o_bs + h * dh;
    const int row = q0 + r0 + (lane >> 1);
    float t = 0.0f;
    if (row < a.lq) {
#pragma unroll
      for (int c = 0; c < DH / 2; c += 8) {
        const int col = (lane & 1) * (DH / 2) + c;
        if (col < dh) {
          alignas(16) bf16 x[8], y[8];
          copy8(x, db + (long long)row * a.do_rs + col);
          copy8(y, ob + (long long)row * a.o_rs + col);
#pragma unroll
          for (int e = 0; e < 8; ++e) t += bf2f(x[e]) * bf2f(y[e]);
        }
      }
    }
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    dl[0] = __shfl_sync(0xffffffffu, t, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, t, 2 * g + 16);
  }
  float inv[2] = {0.0f, 0.0f};
  float dq[DH / 8][4];
  ab_zero(dq);

#pragma unroll 1
  for (int i = 0; i < 2 * T; ++i) {
    if (i + 1 < 2 * T) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i (and Q, dO) landed for every thread
    const int kt = (i % T) * kAbBQ;
    const int nv = min(8, (a.lk - kt + 7) / 8);
    const bf16* ks = ring + (i & 1) * 2 * TILE;
    float sc[8][4], dp[8][4];
    ab_zero(sc);
    ab_nt<DH>(sc, qs, r0, ks, nv);
    if (MODE == kBwdBf16 || i >= T) {
      ab_zero(dp);
      ab_nt<DH>(dp, dos, r0, ks + TILE, nv);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + j * 8 + 2 * qd + (e & 1);
        // padded keys below any real score (a masked one is -1e30 * log2(e))
        sc[j][e] = key < a.lk ? sc[j][e] * sl2 + (mrow ? mrow[key] * kLog2e : 0.0f) : -3.0e38f;
      }
    if (i < T) {  // the running statistics over this thread's keys
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) mt = fmaxf(mt, sc[j][2 * r + e]);
        const float corr = exp2f(m[r] - mt);
        float lt = 0.0f, dt = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // padded keys weigh exactly 0
            const float x = kt + j * 8 + 2 * qd + e < a.lk ? exp2f(sc[j][2 * r + e] - mt) : 0.0f;
            lt += x;
            if (MODE == kBwdBf16) dt += x * dp[j][2 * r + e];
          }
        m[r] = mt;
        l[r] = l[r] * corr + lt;
        if (MODE == kBwdBf16) dl[r] = dl[r] * corr + dt;
      }
      if (i == T - 1) {  // the quad's four partial statistics, in a fixed order
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mq = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
          const float f = exp2f(m[r] - mq);
          float lq = l[r] * f;
          lq += __shfl_xor_sync(0xffffffffu, lq, 1);
          lq += __shfl_xor_sync(0xffffffffu, lq, 2);
          m[r] = mq;
          inv[r] = 1.0f / lq;
          if (MODE == kBwdBf16) {  // delta = rowsum(dP * P) = (sum dP exp2(s - m)) / l
            float dq_ = dl[r] * f;
            dq_ += __shfl_xor_sync(0xffffffffu, dq_, 1);
            dq_ += __shfl_xor_sync(0xffffffffu, dq_, 2);
            dl[r] = dq_ * inv[r];
          }
        }
      }
    } else {  // P = exp2(s - m) / l, dS = P (dP - delta) * scale; dQ += dS K
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + j * 8 + 2 * qd + (e & 1);
          const float p = key < a.lk ? exp2f(sc[j][e] - m[e >> 1]) * inv[e >> 1] : 0.0f;
          sc[j][e] = p * (dp[j][e] - dl[e >> 1]) * a.scale;
        }
      ab_nn_all<MODE, DH, DH>(dq, sc, ks, nv);
    }
    __syncthreads();  // every warp is done with stage i & 1 before it refills
  }

  // ---- dQ (bf16) and the row statistics
  ab_store_pairs(dq, a.dq + b * a.dq_bs + h * dh, a.dq_rs, q0 + r0, a.lq, 0, dh);
  const long long n = (long long)gridDim.y * a.lq;
  float* stb = a.stats + (long long)bh * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row < a.lq && qd == 0) {
      stb[row] = m[r];
      stb[n + row] = inv[r];
      stb[2 * n + row] = dl[r];
    }
  }
}

// ------------------------------------------------------------- cols
template <int MODE, int DH>
__global__ void __launch_bounds__(kAbThreads, DH == 64 ? 3 : 2)
    attn_bwd_cols_kernel(AttnBwdArgs a) {
  constexpr int TILE = AbTile<DH>::kElems;
  constexpr int NC = ab_cols_width<DH>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TILE;
  bf16* ring = vs + TILE;  // [2 stages][Q, dO]
  float* sring = reinterpret_cast<float*>(ring + 4 * TILE);  // [2 stages][m, l, delta][64]

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int k0 = blockIdx.x * kAbBQ;
  const int c0 = NC == DH ? 0 : blockIdx.z * NC;  // this CTA's head columns of dK and dV
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int kr = warp * 16;  // this warp's keys k0 + kr..
  const int dh = attn_run_dh<DH>(a.dh);

  const bf16* qb = a.q + b * a.q_bs + h * dh;
  const bf16* kb = a.k + b * a.k_bs + h * dh;
  const bf16* vb = a.v + b * a.v_bs + h * dh;
  const bf16* db = a.dout + b * a.do_bs + h * dh;
  const long long n = (long long)gridDim.y * a.lq;
  const float* stb = a.stats + (long long)bh * a.lq;
  const int T = (a.lq + kAbBQ - 1) / kAbBQ;
  auto load = [&](int it) {  // query tile it: Q, dO and its rows' statistics
    bf16* st = ring + (it & 1) * 2 * TILE;
    ab_load_async<DH>(st, qb, a.q_rs, it * kAbBQ, a.lq, dh);
    ab_load_async<DH>(st + TILE, db, a.do_rs, it * kAbBQ, a.lq, dh);
    float* ss = sring + (it & 1) * 3 * kAbBQ;
    for (int v = threadIdx.x; v < 3 * kAbBQ; v += kAbThreads) {
      const int r = it * kAbBQ + v % kAbBQ;
      const bool ok = r < a.lq;
      cp_async4(smem_u32(ss + v), stb + (v / kAbBQ) * n + (ok ? r : 0), ok ? 4 : 0);
    }
  };
  ab_load_async<DH>(ks, kb, a.k_rs, k0, a.lk, dh);
  ab_load_async<DH>(vs, vb, a.v_rs, k0, a.lk, dh);
  load(0);
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  bool kv[2];   // keys k0 + kr + g (+ 8) exist
  float mk[2];  // their additive mask, times log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    kv[r] = key < a.lk;
    mk[r] = kv[r] && a.mask ? a.mask[(long long)b * a.lk + key] * kLog2e : 0.0f;
  }
  float dk[NC / 8][4], dv[NC / 8][4];
  ab_zero(dk);
  ab_zero(dv);

#pragma unroll 1
  for (int it = 0; it < T; ++it) {
    if (it + 1 < T) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = ring + (it & 1) * 2 * TILE;
    const bf16* dos = qs + TILE;
    const float* ss = sring + (it & 1) * 3 * kAbBQ;
    const int q0 = it * kAbBQ;
    const int nv = min(8, (a.lq - q0 + 7) / 8);
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
    float sc[8][4], dp[8][4];
    ab_zero(sc);
    ab_zero(dp);
    ab_nt<DH>(sc, ks, kr, qs, nv);
    ab_nt<DH>(dp, vs, kr, dos, nv);
    // P^T and dS^T from the rows' statistics
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * qd + (e & 1);  // query within the tile
        const int r = e >> 1;
        float p = 0.0f, ds = 0.0f;
        if (kv[r] && q0 + c < a.lq) {
          p = exp2f(sc[j][e] * sl2 + mk[r] - ss[c]) * ss[kAbBQ + c];
          ds = p * (dp[j][e] - ss[2 * kAbBQ + c]) * a.scale;
        }
        sc[j][e] = p;
        dp[j][e] = ds;
      }
    ab_nn_all<MODE, DH, NC>(dv, sc, dos, nv, c0);  // dV += P^T dO
    ab_nn_all<MODE, DH, NC>(dk, dp, qs, nv, c0);   // dK += dS^T Q
    __syncthreads();  // every warp is done with stage it & 1 before it refills
  }

  ab_store_pairs(dk, a.dk + b * a.dk_bs + h * dh, a.dk_rs, k0 + kr, a.lk, c0, dh);
  ab_store_pairs(dv, a.dv + b * a.dv_bs + h * dh, a.dv_rs, k0 + kr, a.lk, c0, dh);
}

// ------------------------------------------------- head tiles 256 and 512
// At DH 256 and 512 the rows kernel's dQ (DH / 8 fragments) and the whole
// head's tiles (66,560 bytes per 64 rows at DH 512) do not fit, so the wide
// kernels stream the head in 64-column chunks (AbTile<64>), two chunks to a
// ring slot, and split the gradients' columns over grid z:
//   attn_bwd_rows_wide_kernel: 64 query rows, kAbWideRowsCols of dQ's
//     columns a CTA (2 CTAs a query block at DH 256, 4 at 512); its rows of
//     Q and dO sit whole in shared memory.  Per key tile, the slots (K, V)
//     chunk c sum S and dP over the head's chunks; the two passes are the
//     rows kernel's (the statistics, then dS), and the second pass's last
//     slot holds the K chunks of the CTA's columns for dQ += dS K.  CTA z 0
//     writes the row statistics.
//   attn_bwd_cols_wide_kernel: 64 key rows, 64 of dK's and dV's columns a
//     CTA (grid z DH / 64); its rows of K and V sit whole in shared memory.
//     Per query tile the slots (Q, dO) chunk c sum S^T and dP^T, then the
//     slot of the CTA's column chunk gives dV += P^T dO and dK += dS^T Q.
// Every CTA of a block forms the whole head's S and dP.  Shared memory:
// rows 110,592 bytes at DH 256 (two CTAs an SM), 184,320 at 512; cols
// 112,128 and 185,856.
// Sums.  A tensor-core sum truncates each add to its accumulator's f32
// ulp, so a chain's error grows with its adds: over a 512-column head one
// chain put K1b's dQ a bf16 step from float64's rounding in its top
// binade.  So each 64-column chunk of S and dP, and each key or query
// tile's part of dQ, dK and dV, sums in fresh registers joined to the
// running sums by f32 adds; K1b (kBwdF32) multiplies P and dS in three
// bf16 parts (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): 24
// bits of the f32 value), the mid and lo products in a chain of their own;
// and its delta = rowsum(dO * O) sums in eight running sums a lane.  Against
// float64, 0.018-0.026% of K1b's outputs at dh 256 and 512 differ by a bf16
// step (its twin's: 0.031-0.055%); with one chain over the head and two
// bf16 parts, 0.21-0.31%, as the 32- to 128-wide builds read.
constexpr int kAbWideRowsCols = 128;  // dQ's columns a rows CTA owns
constexpr int kAbChunk = AbTile<64>::kElems;

// acc += A B^T over one 64-column chunk of the head (ab_nt), summed in
// fresh registers and joined to acc by f32 adds
__device__ __forceinline__ void ab_nt_chunk(float (&acc)[8][4], const bf16* A, int r0,
                                            const bf16* B, int nv) {
  float t[8][4];
  ab_zero(t);
  ab_nt<64>(t, A, r0, B, nv);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += t[j][e];
}

// acc += P B[:, 0 .. 64) for the k-steps of every live key or query
// n-tile, B a [64, 64] chunk, in fresh registers joined to acc by f32 adds:
// kBwdF32 takes P in three bf16 parts, the hi products in one chain and
// the mid and lo products in another; kBwdBf16 takes bf16(P) alone
template <int MODE>
__device__ __forceinline__ void ab_nn_wide(float (&acc)[8][4], const float (&p)[8][4],
                                           const bf16* B, int nv) {
  float t[8][4], tl[8][4];
  ab_zero(t);
  if (MODE == kBwdF32) ab_zero(tl);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (2 * kk < nv) {
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = p[2 * kk + (u >> 1)][2 * (u & 1)];
        const float x1 = p[2 * kk + (u >> 1)][2 * (u & 1) + 1];
        hi[u] = pack_bf16(x0, x1);
        if (MODE == kBwdF32) {
          const float2 h = unpack_bf16(hi[u]);
          const float r0 = x0 - h.x, r1 = x1 - h.y;
          mid[u] = pack_bf16(r0, r1);
          const float2 m = unpack_bf16(mid[u]);
          lo[u] = pack_bf16(r0 - m.x, r1 - m.y);
        }
      }
      if (MODE == kBwdF32) {
        ab_nn<64, 64>(tl, lo, B, kk * 16, 0);
        ab_nn<64, 64>(tl, mid, B, kk * 16, 0);
      }
      ab_nn<64, 64>(t, hi, B, kk * 16, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += MODE == kBwdF32 ? t[j][e] + tl[j][e] : t[j][e];
}

template <int DH>
__host__ __device__ constexpr size_t ab_rows_wide_smem() {
  return (size_t)(2 * (DH / 64) + 4) * kAbChunk * sizeof(bf16);
}
template <int DH>
__host__ __device__ constexpr size_t ab_cols_wide_smem() {
  return (size_t)(2 * (DH / 64) + 4) * kAbChunk * sizeof(bf16) + 2 * 3 * kAbBQ * sizeof(float);
}

// kBwdF32's delta = rowsum(dO * O) of this warp's rows r0 + g and r0 + g + 8
// (two lanes a row, DH / 2 columns each, in eight running sums joined by a
// tree), into dl
template <int DH>
__device__ __forceinline__ void ab_delta_rows(const bf16* db, long long do_rs, const bf16* ob,
                                              long long o_rs, int row0, int lq, float (&dl)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int row = row0 + (lane >> 1);
  float ts[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row < lq) {
#pragma unroll 4
    for (int c = 0; c < DH / 2; c += 8) {
      const int col = (lane & 1) * (DH / 2) + c;
      alignas(16) bf16 x[8], y[8];
      copy8(x, db + (long long)row * do_rs + col);
      copy8(y, ob + (long long)row * o_rs + col);
#pragma unroll
      for (int e = 0; e < 8; ++e) ts[e] += bf2f(x[e]) * bf2f(y[e]);
    }
  }
  float t = ((ts[0] + ts[1]) + (ts[2] + ts[3])) + ((ts[4] + ts[5]) + (ts[6] + ts[7]));
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  dl[0] = __shfl_sync(0xffffffffu, t, 2 * g);
  dl[1] = __shfl_sync(0xffffffffu, t, 2 * g + 16);
}

template <int MODE, int DH>
__global__ void __launch_bounds__(kAbThreads) attn_bwd_rows_wide_kernel(AttnBwdArgs a) {
  constexpr int NCH = DH / 64;
  constexpr int NQ = kAbWideRowsCols / 64;  // K chunks of this CTA's dQ columns
  static_assert(NQ == 2, "the dQ slot holds two K chunks");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [NCH] chunks of Q's rows
  bf16* dos = qs + NCH * kAbChunk;               // [NCH] chunks of dO's rows
  bf16* ring = dos + NCH * kAbChunk;             // [2 slots][2 chunks]

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * kAbBQ;
  const int c0 = blockIdx.z * kAbWideRowsCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int r0 = warp * 16;
  const bf16* kb = a.k + b * a.k_bs + h * DH;
  const bf16* vb = a.v + b * a.v_bs + h * DH;
  const float* mrow = a.mask ? a.mask + (long long)b * a.lk : nullptr;
  const float sl2 = a.scale * kLog2e;
  const int T = (a.lk + kAbBQ - 1) / kAbBQ;
  // the slots in order: each key tile's NCH (K, V) chunks (first pass; V
  // only for kBwdBf16's delta), then its NCH (K, V) chunks and the K
  // chunks of the CTA's columns (second pass)
  const int n1 = T * NCH, n = n1 + T * (NCH + 1);
  auto load = [&](int i) {
    const int per = i < n1 ? NCH : NCH + 1, u = i < n1 ? i : i - n1;
    const int kt = (u / per) * kAbBQ, j = u % per;
    bf16* st = ring + (i & 1) * 2 * kAbChunk;
    if (j < NCH) {
      ab_load_async<64>(st, kb + j * 64, a.k_rs, kt, a.lk, 64);
      if (MODE == kBwdBf16 || i >= n1) ab_load_async<64>(st + kAbChunk, vb + j * 64, a.v_rs, kt, a.lk, 64);
    } else {
#pragma unroll
      for (int v = 0; v < NQ; ++v)
        ab_load_async<64>(st + v * kAbChunk, kb + c0 + v * 64, a.k_rs, kt, a.lk, 64);
    }
  };
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    ab_load_async<64>(qs + c * kAbChunk, a.q + b * a.q_bs + h * DH + c * 64, a.q_rs, q0, a.lq, 64);
    ab_load_async<64>(dos + c * kAbChunk, a.dout + b * a.do_bs + h * DH + c * 64, a.do_rs, q0,
                      a.lq, 64);
  }
  load(0);
  cp_async_commit();

  float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};
  if (MODE == kBwdF32)
    ab_delta_rows<DH>(a.dout + b * a.do_bs + h * DH, a.do_rs, a.o + b * a.o_bs + h * DH, a.o_rs,
                      q0 + r0, a.lq, dl);
  float inv[2] = {0.0f, 0.0f};
  float dq[NQ][8][4], sc[8][4], dp[8][4];
#pragma unroll
  for (int v = 0; v < NQ; ++v) ab_zero(dq[v]);
  ab_zero(sc);
  ab_zero(dp);

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // slot i landed; every warp is done with slot i - 1
    if (i + 1 < n) load(i + 1);
    cp_async_commit();
    const bool second = i >= n1;
    const int per = second ? NCH + 1 : NCH, u = second ? i - n1 : i;
    const int kt = (u / per) * kAbBQ, j = u % per;
    const int nv = min(8, (a.lk - kt + 7) / 8);
    const bf16* st = ring + (i & 1) * 2 * kAbChunk;
    if (j < NCH) {
      if (j == 0) {
        ab_zero(sc);
        ab_zero(dp);
      }
      ab_nt_chunk(sc, qs + j * kAbChunk, r0, st, nv);
      if (MODE == kBwdBf16 || second) ab_nt_chunk(dp, dos + j * kAbChunk, r0, st + kAbChunk, nv);
      if (j == NCH - 1) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + jj * 8 + 2 * qd + (e & 1);
            sc[jj][e] =
                key < a.lk ? sc[jj][e] * sl2 + (mrow ? mrow[key] * kLog2e : 0.0f) : -3.0e38f;
          }
        if (!second) {  // the running statistics over this thread's keys
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mt = m[r];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) mt = fmaxf(mt, sc[jj][2 * r + e]);
            const float corr = exp2f(m[r] - mt);
            float lt = 0.0f, dt = 0.0f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x =
                    kt + jj * 8 + 2 * qd + e < a.lk ? exp2f(sc[jj][2 * r + e] - mt) : 0.0f;
                lt += x;
                if (MODE == kBwdBf16) dt += x * dp[jj][2 * r + e];
              }
            m[r] = mt;
            l[r] = l[r] * corr + lt;
            if (MODE == kBwdBf16) dl[r] = dl[r] * corr + dt;
          }
          if (kt + kAbBQ >= a.lk) {  // the quad's four partial statistics, in a fixed order
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float mq = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
              mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
              const float f = exp2f(m[r] - mq);
              float lq = l[r] * f;
              lq += __shfl_xor_sync(0xffffffffu, lq, 1);
              lq += __shfl_xor_sync(0xffffffffu, lq, 2);
              m[r] = mq;
              inv[r] = 1.0f / lq;
              if (MODE == kBwdBf16) {
                float dq_ = dl[r] * f;
                dq_ += __shfl_xor_sync(0xffffffffu, dq_, 1);
                dq_ += __shfl_xor_sync(0xffffffffu, dq_, 2);
                dl[r] = dq_ * inv[r];
              }
            }
          }
        } else {  // P = exp2(s - m) / l, dS = P (dP - delta) * scale
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kt + jj * 8 + 2 * qd + (e & 1);
              const float p = key < a.lk ? exp2f(sc[jj][e] - m[e >> 1]) * inv[e >> 1] : 0.0f;
              sc[jj][e] = p * (dp[jj][e] - dl[e >> 1]) * a.scale;
            }
        }
      }
    } else {  // dQ += dS K over the CTA's columns
#pragma unroll
      for (int v = 0; v < NQ; ++v) ab_nn_wide<MODE>(dq[v], sc, st + v * kAbChunk, nv);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int v = 0; v < NQ; ++v)
    ab_store_pairs(dq[v], a.dq + b * a.dq_bs + h * DH, a.dq_rs, q0 + r0, a.lq, c0 + v * 64, DH);
  if (blockIdx.z != 0) return;
  const long long nrow = (long long)gridDim.y * a.lq;
  float* stb = a.stats + (long long)bh * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row < a.lq && qd == 0) {
      stb[row] = m[r];
      stb[nrow + row] = inv[r];
      stb[2 * nrow + row] = dl[r];
    }
  }
}

template <int MODE, int DH>
__global__ void __launch_bounds__(kAbThreads) attn_bwd_cols_wide_kernel(AttnBwdArgs a) {
  constexpr int NCH = DH / 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [NCH] chunks of K's rows
  bf16* vs = ks + NCH * kAbChunk;                // [NCH] chunks of V's rows
  bf16* ring = vs + NCH * kAbChunk;              // [2 slots][Q, dO chunk]
  float* sring = reinterpret_cast<float*>(ring + 4 * kAbChunk);  // [2 tiles][m, l, delta][64]

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int k0 = blockIdx.x * kAbBQ;
  const int cz = blockIdx.z;  // this CTA's 64 columns of dK and dV are chunk cz
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int kr = warp * 16;
  const bf16* qb = a.q + b * a.q_bs + h * DH;
  const bf16* db = a.dout + b * a.do_bs + h * DH;
  const long long nrow = (long long)gridDim.y * a.lq;
  const float* stb = a.stats + (long long)bh * a.lq;
  const int T = (a.lq + kAbBQ - 1) / kAbBQ;
  // the slots in order: per query tile its NCH (Q, dO) chunks, then the
  // (Q, dO) chunk of the CTA's columns; a tile's statistics come with its
  // first slot
  const int per = NCH + 1, n = T * per;
  auto load = [&](int i) {
    const int it = i / per, j = i % per, c = j < NCH ? j : cz;
    bf16* st = ring + (i & 1) * 2 * kAbChunk;
    ab_load_async<64>(st, qb + c * 64, a.q_rs, it * kAbBQ, a.lq, 64);
    ab_load_async<64>(st + kAbChunk, db + c * 64, a.do_rs, it * kAbBQ, a.lq, 64);
    if (j == 0) {
      float* ss = sring + (it & 1) * 3 * kAbBQ;
      for (int v = threadIdx.x; v < 3 * kAbBQ; v += kAbThreads) {
        const int r = it * kAbBQ + v % kAbBQ;
        const bool ok = r < a.lq;
        cp_async4(smem_u32(ss + v), stb + (v / kAbBQ) * nrow + (ok ? r : 0), ok ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    ab_load_async<64>(ks + c * kAbChunk, a.k + b * a.k_bs + h * DH + c * 64, a.k_rs, k0, a.lk, 64);
    ab_load_async<64>(vs + c * kAbChunk, a.v + b * a.v_bs + h * DH + c * 64, a.v_rs, k0, a.lk, 64);
  }
  load(0);
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  bool kv[2];
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + g + 8 * r;
    kv[r] = key < a.lk;
    mk[r] = kv[r] && a.mask ? a.mask[(long long)b * a.lk + key] * kLog2e : 0.0f;
  }
  float dk[8][4], dv[8][4], sc[8][4], dp[8][4];
  ab_zero(dk);
  ab_zero(dv);
  ab_zero(sc);
  ab_zero(dp);

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // slot i landed; every warp is done with slot i - 1
    if (i + 1 < n) load(i + 1);
    cp_async_commit();
    const int it = i / per, j = i % per;
    const int q0 = it * kAbBQ;
    const int nv = min(8, (a.lq - q0 + 7) / 8);
    const bf16* qc = ring + (i & 1) * 2 * kAbChunk;
    const bf16* dc = qc + kAbChunk;
    if (j < NCH) {  // S^T = K Q^T and dP^T = V dO^T over the head's chunks
      if (j == 0) {
        ab_zero(sc);
        ab_zero(dp);
      }
      ab_nt_chunk(sc, ks + j * kAbChunk, kr, qc, nv);
      ab_nt_chunk(dp, vs + j * kAbChunk, kr, dc, nv);
      if (j == NCH - 1) {  // P^T and dS^T from the rows' statistics
        const float* ss = sring + (it & 1) * 3 * kAbBQ;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = jj * 8 + 2 * qd + (e & 1);
            const int r = e >> 1;
            float p = 0.0f, ds = 0.0f;
            if (kv[r] && q0 + c < a.lq) {
              p = exp2f(sc[jj][e] * sl2 + mk[r] - ss[c]) * ss[kAbBQ + c];
              ds = p * (dp[jj][e] - ss[2 * kAbBQ + c]) * a.scale;
            }
            sc[jj][e] = p;
            dp[jj][e] = ds;
          }
      }
    } else {
      ab_nn_wide<MODE>(dv, sc, dc, nv);  // dV += P^T dO
      ab_nn_wide<MODE>(dk, dp, qc, nv);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();

  ab_store_pairs(dk, a.dk + b * a.dk_bs + h * DH, a.dk_rs, k0 + kr, a.lk, cz * 64, DH);
  ab_store_pairs(dv, a.dv + b * a.dv_bs + h * DH, a.dv_rs, k0 + kr, a.lk, cz * 64, DH);
}

template <int MODE, int DH>
static cudaError_t ab_wide_set_smem_once() {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(attn_bwd_rows_wide_kernel<MODE, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)ab_rows_wide_smem<DH>());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attn_bwd_cols_wide_kernel<MODE, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)ab_cols_wide_smem<DH>());
  }();
  return attr;
}

template <int MODE, int DH>
static cudaError_t launch_attention_bwd_wide(const AttnBwdArgs& a, int batch,
                                             cudaStream_t stream) {
  const cudaError_t attr = ab_wide_set_smem_once<MODE, DH>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid_rows((a.lq + kAbBQ - 1) / kAbBQ, batch * a.heads, DH / kAbWideRowsCols);
  attn_bwd_rows_wide_kernel<MODE, DH>
      <<<grid_rows, kAbThreads, ab_rows_wide_smem<DH>(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_cols((a.lk + kAbBQ - 1) / kAbBQ, batch * a.heads, DH / 64);
  attn_bwd_cols_wide_kernel<MODE, DH>
      <<<grid_cols, kAbThreads, ab_cols_wide_smem<DH>(), stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int DH>
static cudaError_t attention_bwd_wide_attrs(int* out) {
  const cudaError_t attr = ab_wide_set_smem_once<MODE, DH>();
  if (attr != cudaSuccess) return attr;
  const void* fns[2] = {reinterpret_cast<const void*>(attn_bwd_rows_wide_kernel<MODE, DH>),
                        reinterpret_cast<const void*>(attn_bwd_cols_wide_kernel<MODE, DH>)};
  const size_t dyn[2] = {ab_rows_wide_smem<DH>(), ab_cols_wide_smem<DH>()};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fns[i]);
    if (err != cudaSuccess) return err;
    out[3 * i] = fa.numRegs;
    out[3 * i + 1] = (int)(fa.sharedSizeBytes + dyn[i]);
    out[3 * i + 2] = (int)fa.localSizeBytes;
  }
  return cudaSuccess;
}

// the kernels' dynamic shared memory limits, set once per library and card.
// Internal linkage: two libraries include this header (attention_bwd,
// decoder_blocks_bwd), and the local static of an inline function would be
// one object across them (a GNU unique symbol), set for one library's
// kernels only.
template <int MODE, int DH>
static cudaError_t ab_set_smem_once() {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(attn_bwd_rows_kernel<MODE, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)ab_rows_smem<DH>());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attn_bwd_cols_kernel<MODE, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)ab_cols_smem<DH>());
  }();
  return attr;
}

template <int MODE, int DH>
static cudaError_t launch_attention_bwd_dh(const AttnBwdArgs& a, int batch,
                                           cudaStream_t stream) {
  const cudaError_t attr = ab_set_smem_once<MODE, DH>();
  if (attr != cudaSuccess) return attr;
  const dim3 grid_rows((a.lq + kAbBQ - 1) / kAbBQ, batch * a.heads);
  attn_bwd_rows_kernel<MODE, DH><<<grid_rows, kAbThreads, ab_rows_smem<DH>(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_cols((a.lk + kAbBQ - 1) / kAbBQ, batch * a.heads, DH / ab_cols_width<DH>());
  attn_bwd_cols_kernel<MODE, DH><<<grid_cols, kAbThreads, ab_cols_smem<DH>(), stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
static cudaError_t launch_attention_bwd(const AttnBwdArgs& a, int batch,
                                        cudaStream_t stream) {
  if (a.lk < 1 || a.lq < 1 || batch < 1) return cudaErrorInvalidValue;
  switch (attn_head_tile(a.dh)) {
    case 32: return launch_attention_bwd_dh<MODE, 32>(a, batch, stream);
    case 64: return launch_attention_bwd_dh<MODE, 64>(a, batch, stream);
    case 128: return launch_attention_bwd_dh<MODE, 128>(a, batch, stream);
    case 256: return launch_attention_bwd_wide<MODE, 256>(a, batch, stream);
    case 512: return launch_attention_bwd_wide<MODE, 512>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// out[6]: registers per thread, shared memory bytes per CTA and spill bytes
// per thread of the rows kernel, then of the cols kernel, at head tile DH
template <int MODE, int DH>
static cudaError_t attention_bwd_attrs_dh(int* out) {
  const void* fns[2] = {reinterpret_cast<const void*>(attn_bwd_rows_kernel<MODE, DH>),
                        reinterpret_cast<const void*>(attn_bwd_cols_kernel<MODE, DH>)};
  const size_t dyn[2] = {ab_rows_smem<DH>(), ab_cols_smem<DH>()};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fns[i]);
    if (err != cudaSuccess) return err;
    out[3 * i] = fa.numRegs;
    out[3 * i + 1] = (int)(fa.sharedSizeBytes + dyn[i]);
    out[3 * i + 2] = (int)fa.localSizeBytes;
  }
  return cudaSuccess;
}

template <int MODE>
static cudaError_t attention_bwd_attrs(int dh, int* out) {
  switch (attn_head_tile(dh)) {
    case 32: return attention_bwd_attrs_dh<MODE, 32>(out);
    case 64: return attention_bwd_attrs_dh<MODE, 64>(out);
    case 128: return attention_bwd_attrs_dh<MODE, 128>(out);
    case 256: return attention_bwd_wide_attrs<MODE, 256>(out);
    case 512: return attention_bwd_wide_attrs<MODE, 512>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace crog
