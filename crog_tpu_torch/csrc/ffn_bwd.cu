// K4b: the CROG decoder FFN backward: a cluster kernel for the hidden, a
// GEMM kernel for dx, and two fixed-order sums.
//
// Replaces crog_tpu/ops/pallas_ffn.py:226 `_fused_ffn_bwd_vjp` (pallas_call
// at :234, kernel `_bwd_kernel` :97): per row tile it regenerates the
// dropout mask and recomputes the hidden from x (FLOPs are cheap, bytes are
// not), then
//   dhn = bf16(dy) W2                                (f32 sums)
//   dh  = LN backward of dhn; dh = drop(dh); dh = dh * (h > 0); dh = bf16(dh)
//   dx  = bf16(dh W1)
// and emits dx, dh and hn = bf16(LN(h)) (both read by the weight-gradient
// products dW1 = dh^T x and dW2 = dy^T hn, which stay library GEMMs outside
// the kernels, bf16 with f32 results, as the JAX package leaves them to XLA),
// plus per-tile partial column sums of db1 (of the rounded dh), dgamma,
// dbeta and db2 (of dy in f32), summed in a fixed order by a second pass:
// the same gradient in every run.  Cast points: h = bf16(x W1^T + b1)
// before ReLU and dropout, LN statistics in f32 over the bf16 hidden with
// the fast variance E[h^2] - E[h]^2, dhn from bf16 dy, dh rounded before
// db1 and dx.
//
// Bound on an H100 at M = 24*676 = 16224: 3 products of 2*M*512*2048 flops
// (the hidden recompute, dhn, dx) = 102 GFLOP, over 2 x 66 MB of dh and hn
// written plus 50 MB in: about 0.10 ms, limited by the tensor cores.
//
// Design.  The LN backward needs two row means over all 2048 columns of dhn
// before any dh, and the LN forward two over h, so a row's whole hidden has
// to be on chip at once; a [128, 2048] bf16 hidden (512 KB) does not fit one
// SM.  So:
//   ffn_bwd_hidden_kernel: a thread-block cluster of 8 CTAs takes 128 rows;
//     CTA r owns hidden columns [256 r, 256 r + 256).  Each CTA runs two
//     [128 x 256 x 512] products on wgmma m64n128k16 (four warpgroups of 64
//     rows x 128 columns, f32 accumulators in registers; A, the x or dy
//     rows, from registers by ldmatrix; B, the W1^T or W2 columns, from
//     shared memory in 128-byte swizzled [32][64] blocks), fed by a 4-stage
//     cp.async ring of 32-deep chunks (one barrier per chunk, loads two
//     chunks ahead, each chunk's products in flight while the next one's
//     fragments load).  The recompute's epilogue (bias, bf16, ReLU, dropout,
//     whose mask bits it keeps for the backward) runs on the accumulators
//     and leaves h in shared memory (66 KB); each CTA's row partials of
//     sum(h), sum(h^2) go to the cluster through distributed shared memory
//     and every CTA adds the 8 in rank order.  dhn stays in the f32
//     accumulators (no second product): its row partials of m1 = mean(dhn
//     g), m2 = mean(dhn g hhat) cross the cluster the same way, then dh is
//     formed from the registers and written over h, and hn and dh leave as
//     16-byte rows.  Column partials (db1, dgamma, dbeta; db2 over 64 of
//     dy's columns per CTA, from the dy chunks as they pass through the
//     ring) are summed over the tile's rows in a fixed order.  Every 128
//     rows stream W1 and W2 once per cluster: 64 FLOP per weight byte from
//     L2, four times the 32-row design's.  One CTA of 16 warps per SM
//     (about 200 KB of shared memory).
//   ffn_dx_kernel: dx = bf16(dh W1), a [128 x 256] tile per CTA over the dh
//     the first kernel wrote (K = 2048), with the same ring and products;
//     the output leaves as 16-byte bf16 rows after a shuffle in each quad.
#include "gemm.cuh"
#include "sm90.cuh"

namespace crog {

constexpr int kBD = 512;             // model width
constexpr int kBF = 2048;            // hidden width
constexpr int kBM = 128;             // rows per cluster tile and per dx tile
constexpr int kBCl = 8;              // CTAs per cluster
constexpr int kBN = kBF / kBCl;      // hidden columns per CTA, and dx tile columns
constexpr int kBK = 32;              // k chunk of the ring
constexpr int kBS = 4;               // ring stages
constexpr int kBThreads = 512;       // 4 warpgroups: 2 (rows) x 2 (columns) of 64 x 128
constexpr int kBNT = 16;             // n-tiles of 8 columns per warp (one wgmma N = 128)
constexpr int kBALd = kBK + 8;       // A chunk [128][40] (conflict-free ldmatrix)
constexpr int kBHLd = kBN + 8;       // h / dh slice [128][264]
constexpr float kBEps = 1e-5f;

// one ring stage: the A chunk, then the B chunk as 128-byte swizzled
// [32 k][64 n] blocks (1024-byte aligned: stage sizes are multiples of 1024)
constexpr int kBAStage = kBM * kBALd * 2;
constexpr int kBBlock = kBK * 128;
constexpr int kBStage = kBAStage + (kBN / 64) * kBBlock;
static_assert(kBAStage % 1024 == 0 && kBStage % 1024 == 0, "swizzled blocks need 1024-byte alignment");
constexpr size_t kBRingBytes = (size_t)kBS * kBStage;
constexpr size_t kHHBytes = (size_t)kBM * kBHLd * sizeof(bf16);
constexpr int kHRedF = 2 * kBM * 2;  // [column warpgroup][row][2] row partials
constexpr int kHXchF = 4 * kBM;      // [exchange][2][row], read by the cluster
constexpr int kHRowF = 4 * kBM;      // mu, rstd, m1, m2 per row
constexpr int kHColF = 8 * 3 * kBN;  // [row warp][db1, dgamma, dbeta][column]
constexpr int kHDb2F = 8 * 64;       // [row group][column] db2 partials
constexpr size_t kFfnHiddenSmem =
    1024 + kBRingBytes + kHHBytes +
    (size_t)(kHRedF + kHXchF + kHRowF + kHColF + kHDb2F) * sizeof(float);
constexpr size_t kFfnDxSmem = 1024 + kBRingBytes;

// the ring at the first 1024-byte boundary of the dynamic shared memory
__device__ __forceinline__ unsigned char* ffn_smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

struct NoChunkHook {
  __device__ void operator()(int, const bf16*) const {}
};

// acc[nt] += A[m0 + rows, :] B[:, n0 + columns] over K for this warp's 16
// rows of its warpgroup's 64 (warpgroup / 2) and the warpgroup's 128 columns
// (warpgroup % 2) of a [128, 256] CTA tile, as mma.m16n8k16 C fragments.
// A [M, K] row-major (lda; rows >= M read as zeros), B [K, N] row-major
// (ldb), K a multiple of 64.  32-deep chunks through a kBS-stage cp.async
// ring: one barrier per chunk, one chunk's products in flight behind the
// next one's fragment loads; hook(c, A chunk) runs once the chunk has
// landed.
template <typename Hook>
__device__ __forceinline__ void ffn_mainloop(float (&acc)[kBNT][4], const bf16* __restrict__ A,
                                             long long lda, int m0, int M,
                                             const bf16* __restrict__ B, long long ldb, int n0,
                                             int K, unsigned char* ring, const Hook& hook) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int arow = (wg >> 1) * 64 + ((tid >> 5) & 3) * 16 + (lane & 15);
  const int nch = K / kBK;
  // this thread's copies: one 16-byte A segment, two B segments
  const int ar = tid >> 2, as8 = (tid & 3) * 8;
  const bool aok = m0 + ar < M;
  const bf16* asrc = A + (aok ? (long long)(m0 + ar) * lda : 0) + as8;
  auto load = [&](int c) {
    unsigned char* st = ring + (c % kBS) * kBStage;
    const int k0 = c * kBK;
    cp_async16(smem_u32(st) + (ar * kBALd + as8) * 2, asrc + k0, aok ? 16 : 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kBThreads;  // 32 rows x 32 segments of 8 columns
      const int k = v >> 5, cs = v & 31;
      const uint32_t dst = smem_u32(st + kBAStage + (cs >> 3) * kBBlock + k * 128 +
                                    (((cs & 7) ^ (k & 7)) << 4));
      cp_async16(dst, B + (long long)(k0 + k) * ldb + n0 + cs * 8, 16);
    }
  };
  // chunk c's products stay in flight while chunk c + 1 loads its A
  // fragments, so the stage refilled at chunk c is chunk c - 2's and the
  // loads run kBS - 2 chunks ahead
  constexpr int kAhead = kBS - 2;
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }
  float(&d)[64] = reinterpret_cast<float(&)[64]>(acc);
  auto step = [&](int c, uint32_t(&a)[2][4]) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 2's products are done
    if (c + kAhead < nch) load(c + kAhead);
    cp_async_commit();
    const unsigned char* st = ring + (c % kBS) * kBStage;
    const bf16* as = reinterpret_cast<const bf16*>(st);
    hook(c, as);
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16)
      ldsm_x4(smem_u32(as + arow * kBALd + k16 * 16 + (lane >> 4) * 8), a[k16]);
    const uint32_t b0 = smem_u32(st + kBAStage) + (wg & 1) * 2 * kBBlock;
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16)
      wgmma_m64n128k16_rs(d, a[k16], wgmma_desc_sw128(b0 + k16 * 16 * 128, kBBlock, 8 * 128));
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1's products are done: its A registers are free
  };
  uint32_t a0[2][4], a1[2][4];  // A fragments of even and odd chunks
#pragma unroll 1
  for (int c = 0; c < nch; c += 2) {
    step(c, a0);
    step(c + 1, a1);
  }
  wgmma_wait_all();
  __syncthreads();  // every warp is done with the ring
}

__device__ __forceinline__ void ffn_zero(float (&acc)[kBNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kBNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
}

// v summed over the quad's four threads (one row's columns), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v summed over the warp's eight row groups (one column's rows)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The cluster's row sums: this CTA's two per-row partials (over its 256
// columns) from the two column warpgroups' partials in `red`, published in
// `xch`; after the cluster barrier every CTA adds the 8 CTAs' in rank order.
// Threads < kBM return the totals of row threadIdx.x.
__device__ __forceinline__ float2 ffn_cluster_rows(const float* red, float* xch) {
  const int t = threadIdx.x;
  if (t < kBM) {
    xch[t] = red[t * 2] + red[(kBM + t) * 2];
    xch[kBM + t] = red[t * 2 + 1] + red[(kBM + t) * 2 + 1];
  }
  cluster_arrive();
  cluster_wait();
  float2 tot = make_float2(0.0f, 0.0f);
  if (t < kBM) {
#pragma unroll
    for (int r = 0; r < kBCl; ++r) {
      tot.x += ld_dsmem_f32(xch + t, r);
      tot.y += ld_dsmem_f32(xch + kBM + t, r);
    }
  }
  return tot;
}

__global__ void __launch_bounds__(kBThreads, 1) ffn_bwd_hidden_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ be, const bf16* __restrict__ w2,
    const bf16* __restrict__ dy, bf16* __restrict__ dh_out, bf16* __restrict__ hn_out,
    float* __restrict__ part, int M, Dropout drop) {
  unsigned char* ring = ffn_smem_base();
  bf16* hs = reinterpret_cast<bf16*>(ring + kBRingBytes);  // h, then dh: [128][kBHLd]
  float* red = reinterpret_cast<float*>(ring + kBRingBytes + kHHBytes);
  float* xch = red + kHRedF;
  float* rowst = xch + kHXchF;  // mu, rstd, m1, m2: [4][128]
  float* colp = rowst + kHRowF;
  float* db2p = colp + kHColF;

  const int rank = (int)cluster_rank();
  const int tile = blockIdx.x / kBCl;
  const int m0 = tile * kBM;
  const int n0 = rank * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int rw = (wg >> 1) * 4 + ((tid >> 5) & 3);  // this warp's 16 rows: 16 rw..
  const int g8 = lane >> 2;
  const int qd = lane & 3;
  float* prow = part + (long long)tile * (3 * kBF + kBD);
  // this thread's rows (16 rw + g8 + 8 hf) and columns (128 (wg % 2) + 8 nt +
  // 2 qd, + 1) of the CTA's [128, 256] slice
  auto row_of = [&](int hf) { return rw * 16 + g8 + 8 * hf; };
  auto col_of = [&](int nt) { return (wg & 1) * 128 + nt * 8 + 2 * qd; };

  float acc[kBNT][4];
  // bit 2 nt + e of keep[hf] is the dropout mask of element (row_of(hf),
  // col_of(nt) + e), drawn once for the recompute and the backward
  uint32_t keep[2] = {0u, 0u};

  // ---- h = drop(relu(bf16(x W1^T + b1))) for this CTA's columns, into hs
  ffn_zero(acc);
  ffn_mainloop(acc, x, kBD, m0, M, w1t, kBF, n0, kBD, ring, NoChunkHook());
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row_of(hf);
    // the row's part of the counter hash, mix(mix(seed) ^ row), once
    const uint32_t rowbits = mix32(mix32(drop.seed) ^ (uint32_t)(m0 + r));
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kBNT; ++nt) {
      const int c = col_of(nt);
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        h[e] = fmaxf(bf2f(f2bf(acc[nt][2 * hf + e] + b1[n0 + c + e])), 0.0f);
        if (drop.thresh) {
          const bool k = mix32(rowbits ^ (uint32_t)(n0 + c + e)) >= drop.thresh;
          keep[hf] |= (uint32_t)k << (2 * nt + e);
          h[e] = k ? bf2f(f2bf(h[e] * drop.scale)) : 0.0f;
        }
        s += h[e];
        ss += h[e] * h[e];
      }
      *reinterpret_cast<uint32_t*>(hs + r * kBHLd + c) = pack_bf16(h[0], h[1]);
    }
    s = quad_sum(s);
    ss = quad_sum(ss);
    if (qd == 0) {
      red[((wg & 1) * kBM + r) * 2] = s;
      red[((wg & 1) * kBM + r) * 2 + 1] = ss;
    }
  }
  __syncthreads();
  {  // LN statistics of the whole rows, from the 8 CTAs' partials
    const float2 tot = ffn_cluster_rows(red, xch);
    if (tid < kBM) {
      const float mu = tot.x / kBF;
      rowst[tid] = mu;
      rowst[kBM + tid] = rsqrtf(fmaxf(0.0f, tot.y / kBF - mu * mu) + kBEps);
    }
  }
  __syncthreads();

  // ---- hn = bf16(LN(h)) out, 16-byte row segments
  {
    const int c = (tid & 31) * 8;  // the same 8 columns in every step
    float gv[8], bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gv[e] = g[n0 + c + e];
      bv[e] = be[n0 + c + e];
    }
    for (int r = tid >> 5; r < kBM; r += kBThreads / 32) {
      if (m0 + r >= M) break;
      alignas(16) bf16 hv[8], out[8];
      copy8(hv, hs + r * kBHLd + c);
      const float mu = rowst[r], rstd = rowst[kBM + r];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = f2bf((bf2f(hv[e]) - mu) * rstd * gv[e] + bv[e]);
      copy8(hn_out + (long long)(m0 + r) * kBF + n0 + c, out);
    }
  }

  // ---- dhn = bf16(dy) W2[:, n0..] stays in the f32 accumulators; the db2
  // partials of dy's columns [64 rank, 64 rank + 64) from the dy chunks 2
  // rank and 2 rank + 1 as they pass (rows >= M are zeros there)
  ffn_zero(acc);
  ffn_mainloop(acc, dy, kBD, m0, M, w2, kBF, n0, kBD, ring, [&](int c, const bf16* as) {
    if ((c >> 1) == rank && tid < 256) {
      const int col = tid & 31, grp = tid >> 5;  // 16 rows each
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) s += bf2f(as[(grp * 16 + r) * kBALd + col]);
      db2p[grp * 64 + (c & 1) * 32 + col] = s;
    }
  });
  if (tid < 64) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += db2p[k * 64 + tid];
    prow[3 * kBF + rank * 64 + tid] = s;
  }
  {  // row partials of m1 = mean(dhn g), m2 = mean(dhn g hhat); column
     // partials of dgamma = sum(dhn hhat), dbeta = sum(dhn) over the rows
    float mu[2], rstd[2], a1[2] = {0.0f, 0.0f}, a2[2] = {0.0f, 0.0f};
    bool valid[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mu[hf] = rowst[row_of(hf)];
      rstd[hf] = rowst[kBM + row_of(hf)];
      valid[hf] = m0 + row_of(hf) < M;
    }
#pragma unroll
    for (int nt = 0; nt < kBNT; ++nt) {
      const int c = col_of(nt);
      const float gg[2] = {g[n0 + c], g[n0 + c + 1]};
      float dg[2] = {0.0f, 0.0f}, db[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 hv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(hs + row_of(hf) * kBHLd + c));
        const float hh[2] = {(hv.x - mu[hf]) * rstd[hf], (hv.y - mu[hf]) * rstd[hf]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dhn = acc[nt][2 * hf + e];
          const float d = dhn * gg[e];
          a1[hf] += d;
          a2[hf] += d * hh[e];
          if (valid[hf]) {
            dg[e] += dhn * hh[e];
            db[e] += dhn;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sg = rows_sum(dg[e]), sb = rows_sum(db[e]);
        if (g8 == 0) {
          colp[(rw * 3 + 1) * kBN + c + e] = sg;
          colp[(rw * 3 + 2) * kBN + c + e] = sb;
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float t1 = quad_sum(a1[hf]), t2 = quad_sum(a2[hf]);
      if (qd == 0) {
        red[((wg & 1) * kBM + row_of(hf)) * 2] = t1;
        red[((wg & 1) * kBM + row_of(hf)) * 2 + 1] = t2;
      }
    }
  }
  __syncthreads();
  {  // the row means over the whole rows, from the 8 CTAs' partials
    const float2 tot = ffn_cluster_rows(red, xch + 2 * kBM);
    if (tid < kBM) {
      rowst[2 * kBM + tid] = tot.x / kBF;
      rowst[3 * kBM + tid] = tot.y / kBF;
    }
  }
  cluster_arrive();  // this CTA is done reading its peers' shared memory
  __syncthreads();

  // ---- dh = bf16(relu'(drop(rstd (dhn g - m1 - hhat m2)))) over h; db1 partials
  {
    float mu[2], rstd[2], m1[2], m2[2];
    bool valid[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row_of(hf);
      mu[hf] = rowst[r];
      rstd[hf] = rowst[kBM + r];
      m1[hf] = rowst[2 * kBM + r];
      m2[hf] = rowst[3 * kBM + r];
      valid[hf] = m0 + r < M;
    }
#pragma unroll
    for (int nt = 0; nt < kBNT; ++nt) {
      const int c = col_of(nt);
      const float gg[2] = {g[n0 + c], g[n0 + c + 1]};
      float s1[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t* hp = reinterpret_cast<uint32_t*>(hs + row_of(hf) * kBHLd + c);
        const float2 hv = unpack_bf16(*hp);
        const float h[2] = {hv.x, hv.y};
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          d[e] = rstd[hf] *
                 (acc[nt][2 * hf + e] * gg[e] - m1[hf] - (h[e] - mu[hf]) * rstd[hf] * m2[hf]);
          if (drop.thresh) d[e] = (keep[hf] >> (2 * nt + e)) & 1u ? d[e] * drop.scale : 0.0f;
          d[e] = h[e] > 0.0f ? d[e] : 0.0f;
        }
        const uint32_t pk = pack_bf16(d[0], d[1]);
        *hp = pk;
        if (valid[hf]) {
          const float2 dv = unpack_bf16(pk);
          s1[0] += dv.x;
          s1[1] += dv.y;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float t = rows_sum(s1[e]);
        if (g8 == 0) colp[(rw * 3) * kBN + c + e] = t;
      }
    }
  }
  __syncthreads();
  {  // column partials out (the eight row warps in order); dh out
    if (tid < kBN) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += colp[(w * 3 + k) * kBN + tid];
        prow[k * kBF + n0 + tid] = s;
      }
    }
    const int c8 = (tid & 31) * 8;
    for (int r = tid >> 5; r < kBM; r += kBThreads / 32) {
      if (m0 + r >= M) break;
      copy8(dh_out + (long long)(m0 + r) * kBF + n0 + c8, hs + r * kBHLd + c8);
    }
  }
  cluster_wait();  // no CTA leaves while a peer may still read its exchange
}

// dx = bf16(dh W1): dh [M, 2048], W1 [2048, 512] (torch layout [F, D]), a
// [128, 256] tile per CTA
__global__ void __launch_bounds__(kBThreads, 1) ffn_dx_kernel(const bf16* __restrict__ dh,
                                                              const bf16* __restrict__ w1,
                                                              bf16* __restrict__ dx, int M) {
  unsigned char* ring = ffn_smem_base();
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int qi = lane & 3;
  float acc[kBNT][4];
  ffn_zero(acc);
  ffn_mainloop(acc, dh, kBF, m0, M, w1, kBD, n0, kBF, ring, NoChunkHook());
  // per pair of 8-column fragments the quad holds four 16-byte row segments
  // (rows g, g + 8 of each); quad_gather16 gives each thread one whole
  const int row = m0 + ((wg >> 1) * 4 + ((threadIdx.x >> 5) & 3)) * 16 + (lane >> 2) +
                  8 * (qi & 1);
#pragma unroll
  for (int j = 0; j < kBNT; j += 2) {
    const uint32_t v[4] = {pack_bf16(acc[j][0], acc[j][1]), pack_bf16(acc[j][2], acc[j][3]),
                           pack_bf16(acc[j + 1][0], acc[j + 1][1]),
                           pack_bf16(acc[j + 1][2], acc[j + 1][3])};
    const uint4 seg = quad_gather16(v);
    if (row < M)
      *reinterpret_cast<uint4*>(dx + (long long)row * kBD + n0 + (wg & 1) * 128 +
                                (j + (qi >> 1)) * 8) = seg;
  }
}

// the kernels' dynamic shared memory limits, set once per library and card
static cudaError_t ffn_bwd_set_smem_once() {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        ffn_bwd_hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kFfnHiddenSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ffn_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kFfnDxSmem);
  }();
  return attr;
}

static cudaLaunchConfig_t hidden_config(int tiles, cudaLaunchAttribute* attr, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kBCl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBCl * tiles);
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = kFfnHiddenSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace crog

// t: table of device pointers, in order
//   0 x [M, 512] bf16, 1 w1 [2048, 512] bf16, 2 b1, 3 gamma, 4 beta [2048]
//   f32, 5 w2 [512, 2048] bf16, 6 dy [M, 512] bf16;
//   outputs 7 dx [M, 512], 8 dh [M, 2048], 9 hn [M, 2048] bf16,
//   10 rows f32 [3, 2048] (db1, dgamma, dbeta), 11 db2 f32 [512];
//   workspace 12 part f32 [ceil(M/128), 3*2048 + 512] (one row per cluster
//   tile, ops/ffn.py:bwd_schedule); 13 w1t [512, 2048] bf16, w1 transposed
//   (the recompute's B, row-major along the hidden like w2).
extern "C" int crog_ffn_bwd(void* const* t, int M, int D, int F, unsigned seed,
                            unsigned thresh, float scale, void* stream) {
  using crog::bf16;
  if (D != crog::kBD || F != crog::kBF || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = crog::ffn_bwd_set_smem_once();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + crog::kBM - 1) / crog::kBM;
  float* part = static_cast<float*>(t[12]);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = crog::hidden_config(tiles, &attr, st);
  err = cudaLaunchKernelEx(&cfg, crog::ffn_bwd_hidden_kernel, static_cast<const bf16*>(t[0]),
                           static_cast<const bf16*>(t[13]), static_cast<const float*>(t[2]),
                           static_cast<const float*>(t[3]), static_cast<const float*>(t[4]),
                           static_cast<const bf16*>(t[5]), static_cast<const bf16*>(t[6]),
                           static_cast<bf16*>(t[8]), static_cast<bf16*>(t[9]), part, M,
                           crog::Dropout{seed, thresh, scale});
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  crog::ffn_dx_kernel<<<dim3(crog::kBD / crog::kBN, tiles), crog::kBThreads, crog::kFfnDxSmem,
                        st>>>(static_cast<const bf16*>(t[8]), static_cast<const bf16*>(t[1]),
                              static_cast<bf16*>(t[7]), M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long stride = 3LL * F + D;
  err = crog::launch_reduce(part, tiles, stride, 3LL * F, static_cast<float*>(t[10]),
                            nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)crog::launch_reduce(part + 3LL * F, tiles, stride, D,
                                  static_cast<float*>(t[11]), nullptr, st);
}

// out[8]: the hidden kernel's registers per thread, shared memory per CTA
// (static + dynamic), spill bytes per thread and clusters resident at once;
// then the dx kernel's registers, shared memory, spills and CTAs per SM
extern "C" int crog_ffn_bwd_attrs(void* out_) {
  int* out = static_cast<int*>(out_);
  cudaError_t err = crog::ffn_bwd_set_smem_once();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, crog::ffn_bwd_hidden_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + crog::kFfnHiddenSmem);
  out[2] = (int)fa.localSizeBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = crog::hidden_config(1, &attr, nullptr);
  err = cudaOccupancyMaxActiveClusters(&out[3], crog::ffn_bwd_hidden_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&fa, crog::ffn_dx_kernel);
  if (err != cudaSuccess) return (int)err;
  out[4] = fa.numRegs;
  out[5] = (int)(fa.sharedSizeBytes + crog::kFfnDxSmem);
  out[6] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[7], crog::ffn_dx_kernel,
                                                            crog::kBThreads, crog::kFfnDxSmem);
}
