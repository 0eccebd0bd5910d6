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
// written plus 50 MB in: about 0.10 ms, limited by the tensor cores (twice
// the products at D 1024).  D is a run-time value, any of
// decoder_width_ok's 256, 512, 768 or 1024.
//
// Design.  The LN backward needs two row means over all 2048 columns of dhn
// before any dh, and the LN forward two over h, so a row's whole hidden has
// to be on chip at once; a [128, 2048] bf16 hidden (512 KB) does not fit one
// SM.  So:
//   ffn_bwd_hidden_kernel: a thread-block cluster of 8 CTAs takes 128 rows;
//     CTA r owns hidden columns [256 r, 256 r + 256).  Each CTA runs two
//     [128 x 256 x D] products on wgmma m64n128k16 (four warpgroups of 64
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
//     16-byte rows.  Column partials (db1, dgamma, dbeta; db2 over D / 8 of
//     dy's columns per CTA, from its D / 256 dy chunks of 32 columns as
//     they pass through the ring; ops/ffn.py:bwd_db2_cols) are summed over
//     the tile's rows in a fixed order.  Every 128
//     rows stream W1 and W2 once per cluster: 64 FLOP per weight byte from
//     L2, four times the 32-row design's.  One CTA of 16 warps per SM
//     (about 200 KB of shared memory).
//   ffn_out_kernel (ffn.cuh, also K4's y GEMM): dx = bf16(dh W1), a
//     [128 x 256] tile per CTA over the dh the first kernel wrote (K =
//     2048), with the same ring and products; the output leaves as 16-byte
//     bf16 rows after a shuffle in each quad.
// The recompute (product, epilogue, the LN statistics' cluster exchange)
// and hn out are ffn.cuh's, the code K4 runs, and the ring and products
// gemm.cuh's mainloop: K4 and K4b hold the same hidden by construction.
#include "ffn.cuh"

namespace crog {

constexpr int kHColF = 8 * 3 * kBN;  // [row warp][db1, dgamma, dbeta][column]
constexpr int kHDb2F = kDecoderDMax;  // [row group][D / 8 columns] db2 partials
constexpr size_t kFfnHiddenSmem =
    1024 + kBRingBytes + kHHBytes +
    (size_t)(kHRedF + kHXchF + kHRowF + kHColF + kHDb2F) * sizeof(float);

__global__ void __launch_bounds__(kGThreads, 1) ffn_bwd_hidden_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ be, const bf16* __restrict__ w2,
    const bf16* __restrict__ dy, bf16* __restrict__ dh_out, bf16* __restrict__ hn_out,
    float* __restrict__ part, int M, int D, Dropout drop) {
  unsigned char* ring = gemm_smem_base();
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
  float* prow = part + (long long)tile * (3 * kBF + D);
  const int cpr = D / 256;  // dy chunks (and 32-column db2 groups) per CTA
  const int dcols = D / kBCl;  // db2 columns per CTA

  float acc[kBNT][4];
  // bit 2 nt + e of keep[hf] is the dropout mask of element (ffn_row(hf),
  // ffn_col(nt) + e), drawn once for the recompute and the backward
  uint32_t keep[2] = {0u, 0u};

  // ---- h = drop(relu(bf16(x W1^T + b1))) for this CTA's columns, into hs,
  // and the LN statistics of the whole rows (ffn.cuh, as K4 computes them)
  ffn_hidden<true>(acc, keep, x, w1t, b1, m0, M, D, n0, drop, ring, hs, red, xch, rowst);

  // ---- hn = bf16(LN(h)) out, 16-byte row segments
  ffn_write_hn(hs, rowst, g, be, hn_out, m0, M, n0);

  // ---- dhn = bf16(dy) W2[:, n0..] stays in the f32 accumulators; the db2
  // partials of dy's columns [dcols rank, dcols (rank + 1)) from the dy
  // chunks cpr rank .. cpr (rank + 1) - 1 as they pass (rows >= M are zeros
  // there)
  gemm_zero(acc);
  gemm_mainloop<128, false, kGK>(acc, dy, D, m0, M, w2, kBF, n0, 0, D, ring,
                            [&](int c, const bf16* as, const uint32_t (&)[2][4]) {
    if (c / cpr == rank && tid < 256) {
      const int col = tid & 31, grp = tid >> 5;  // 16 rows each
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) s += bf2f(as[(grp * 16 + r) * FfnRing::kALd + col]);
      db2p[grp * dcols + (c % cpr) * 32 + col] = s;
    }
  });
  if (tid < dcols) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += db2p[k * dcols + tid];
    prow[3 * kBF + rank * dcols + tid] = s;
  }
  {  // row partials of m1 = mean(dhn g), m2 = mean(dhn g hhat); column
     // partials of dgamma = sum(dhn hhat), dbeta = sum(dhn) over the rows
    float mu[2], rstd[2], a1[2] = {0.0f, 0.0f}, a2[2] = {0.0f, 0.0f};
    bool valid[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mu[hf] = rowst[ffn_row(hf)];
      rstd[hf] = rowst[kBM + ffn_row(hf)];
      valid[hf] = m0 + ffn_row(hf) < M;
    }
#pragma unroll
    for (int nt = 0; nt < kBNT; ++nt) {
      const int c = ffn_col(nt);
      const float gg[2] = {g[n0 + c], g[n0 + c + 1]};
      float dg[2] = {0.0f, 0.0f}, db[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 hv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(hs + ffn_row(hf) * kBHLd + c));
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
        red[((wg & 1) * kBM + ffn_row(hf)) * 2] = t1;
        red[((wg & 1) * kBM + ffn_row(hf)) * 2 + 1] = t2;
      }
    }
  }
  __syncthreads();
  {  // the row means over the whole rows, from the 8 CTAs' partials
    const float2 tot = cluster_row_sums(red, xch + 2 * kBM, kBCl);
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
      const int r = ffn_row(hf);
      mu[hf] = rowst[r];
      rstd[hf] = rowst[kBM + r];
      m1[hf] = rowst[2 * kBM + r];
      m2[hf] = rowst[3 * kBM + r];
      valid[hf] = m0 + r < M;
    }
#pragma unroll
    for (int nt = 0; nt < kBNT; ++nt) {
      const int c = ffn_col(nt);
      const float gg[2] = {g[n0 + c], g[n0 + c + 1]};
      float s1[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t* hp = reinterpret_cast<uint32_t*>(hs + ffn_row(hf) * kBHLd + c);
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
    for (int r = tid >> 5; r < kBM; r += kGThreads / 32) {
      if (m0 + r >= M) break;
      copy8(dh_out + (long long)(m0 + r) * kBF + n0 + c8, hs + r * kBHLd + c8);
    }
  }
  cluster_wait();  // no CTA leaves while a peer may still read its exchange
}

// the cluster kernel's dynamic shared memory limit, set once per library
// and card
static cudaError_t ffn_bwd_set_smem_once() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ffn_bwd_hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFfnHiddenSmem);
  return attr;
}

}  // namespace crog

// t: table of device pointers, in order
//   0 x [M, D] bf16, 1 w1 [2048, D] bf16, 2 b1, 3 gamma, 4 beta [2048]
//   f32, 5 w2 [D, 2048] bf16, 6 dy [M, D] bf16;
//   outputs 7 dx [M, D], 8 dh [M, 2048], 9 hn [M, 2048] bf16,
//   10 rows f32 [3, 2048] (db1, dgamma, dbeta), 11 db2 f32 [D];
//   workspace 12 part f32 [ceil(M/128), 3*2048 + D] (one row per cluster
//   tile, ops/ffn.py:bwd_schedule); 13 w1t [D, 2048] bf16, w1 transposed
//   (the recompute's B, row-major along the hidden like w2).
extern "C" int crog_ffn_bwd(void* const* t, int M, int D, int F, unsigned seed,
                            unsigned thresh, float scale, void* stream) {
  using crog::bf16;
  if (!crog::decoder_width_ok(D) || F != crog::kBF || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = crog::ffn_bwd_set_smem_once();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + crog::kBM - 1) / crog::kBM;
  float* part = static_cast<float*>(t[12]);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = crog::ffn_cluster_config(tiles, crog::kFfnHiddenSmem, &attr, st);
  err = cudaLaunchKernelEx(&cfg, crog::ffn_bwd_hidden_kernel, static_cast<const bf16*>(t[0]),
                           static_cast<const bf16*>(t[13]), static_cast<const float*>(t[2]),
                           static_cast<const float*>(t[3]), static_cast<const float*>(t[4]),
                           static_cast<const bf16*>(t[5]), static_cast<const bf16*>(t[6]),
                           static_cast<bf16*>(t[8]), static_cast<bf16*>(t[9]), part, M, D,
                           crog::Dropout{seed, thresh, scale});
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = crog::launch_ffn_out(static_cast<const bf16*>(t[8]), static_cast<const bf16*>(t[1]),
                             nullptr, static_cast<bf16*>(t[7]), M, D, tiles, st);
  if (err != cudaSuccess) return (int)err;
  const long long stride = 3LL * F + D;
  err = crog::launch_reduce(part, tiles, stride, 3LL * F, static_cast<float*>(t[10]),
                            nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)crog::launch_reduce(part + 3LL * F, tiles, stride, D,
                                  static_cast<float*>(t[11]), nullptr, st);
}

// out[8]: the cluster kernel's registers per thread, shared memory per CTA
// (static + dynamic), spill bytes per thread and clusters resident at once;
// then the dx kernel's (ffn_out_kernel) registers, shared memory, spills
// and CTAs per SM
extern "C" int crog_ffn_bwd_attrs(void* out_) {
  int* out = static_cast<int*>(out_);
  cudaError_t err = crog::ffn_bwd_set_smem_once();
  if (err != cudaSuccess) return (int)err;
  err = crog::ffn_cluster_attrs(crog::ffn_bwd_hidden_kernel, crog::kFfnHiddenSmem, out);
  if (err != cudaSuccess) return (int)err;
  return (int)crog::ffn_out_attrs(out + 4);
}
