// K2b and K3b: backward of the CROG decoder's self- and cross-attention
// blocks, as a sequence of hand-written kernels behind one C call each.
//
// Replaces crog_tpu/ops/pallas_decoder.py:450 `_self_bwd_vjp` (pallas_call
// at :457, kernel `_self_bwd_kernel` :233) and :542 `_cross_bwd_vjp`
// (pallas_call at :550, kernel `_cross_bwd_kernel` :320), with their cast
// points: dropout applied to dy before the post-LN backward, the LN
// backward on f32 x-hat and rstd, dOP rounded to bf16 for the products
// (its f32 column sum is dB_out), attention backward with P and dS rounded
// (attention_bwd.cuh, kBwdBf16), each input-gradient product rounded to
// bf16 before the f32 sum, dW summed over all B*L rows in f32 and rounded
// once to bf16.
//
// Bound on an H100 at B=24, L=676, D=512 (self block): about 2x the
// forward's products (dX and dW for each of the four projections, 2.5x
// for the attention): ~130 GFLOP over ~170 MB of inputs, saved
// intermediates and outputs, about 0.13 ms, limited by the tensor cores.
// At D=1024 (8 heads of 128) about 2.2x K2's 181 GFLOP.
//
// D is a run-time value of the GEMMs (K and N are D) and a template
// argument of the two LayerNorm row kernels (a lane holds D / 32 values),
// built for each of decoder_width_ok's 256, 512, 768 and 1024.
//
// Design: the forward (decoder_blocks.cu) saves its intermediates (xl,
// qin, q/k/v, o and the pre-LN projection), which the TPU kernel recomputes
// per sample; a card with 80 GB can hold them.  The backward is then
//   1. ln_post_bwd: one warp per row: regenerate the dropout mask, post-LN
//      backward -> dOP (bf16); per-block partial column sums of dG_post,
//      dB_post, dB_out;
//   2. gemm_nn: dO = dOP W_out;
//   3. attention backward (two kernels, attention_bwd.cuh) -> dQ, dK, dV;
//   4. gemm_nn, one launch: dXL = bf16(dQ Wq) + bf16(dK Wk) + bf16(dV Wv),
//      the three products into one accumulator set in turn, each rounded
//      to bf16 and added into an f32 register sum, dXL written once in f32
//      (cross block: dXL from dQ; d(txt) = bf16(bf16(dK Wk) + bf16(dV Wv))
//      over the B*T text rows, the same way);
//   5. ln_pre_bwd: one warp per row: pre-LN backward plus the residual dy
//      -> dX; partial column sums of dG_pre, dB_pre;
//   6. wgrad x4: dW = dY^T X for q, k, v, out (and the q/k/v bias sums in
//      the same pass), split over row chunks, then summed in a fixed order.
// The GEMMs (gemm.cuh) run wgmma fed by a 4-stage cp.async ring: gemm_nn
// a [128, 128] tile per CTA, wgrad a [128, 256] tile of one row chunk with
// dY^T from ldmatrix.trans.  Every reduction over rows is a first pass of
// partials and a second pass in index order, so two runs give the same
// gradient.
#include "attention_bwd.cuh"
#include "gemm.cuh"

namespace crog {

constexpr int kLRows = 64;         // rows per block of the LN kernels
constexpr float kLnEpsB = 1e-5f;

// lane's D / 32 columns of a D-wide row, in D / 256 passes of 256 columns:
// c(p, e) = p * 256 + lane * 8 + e
__device__ __forceinline__ int ln_col(int i, int lane) {
  return (i / 8) * 256 + lane * 8 + (i % 8);
}

template <int D>
__device__ __forceinline__ void ln_load_bf16(float* v, const bf16* row, int lane) {
#pragma unroll
  for (int p = 0; p < D / 256; ++p) {
    alignas(16) bf16 t[8];
    copy8(t, row + p * 256 + lane * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[p * 8 + e] = bf2f(t[e]);
  }
}

template <int D>
__device__ __forceinline__ void ln_store_bf16(bf16* row, const float* v, int lane) {
#pragma unroll
  for (int p = 0; p < D / 256; ++p) {
    alignas(16) bf16 t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = f2bf(v[p * 8 + e]);
    copy8(row + p * 256 + lane * 8, t);
  }
}

// x-hat and rstd of a row, f32 statistics with the fast variance
template <int D>
__device__ __forceinline__ float ln_xhat(float* v) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    s += v[i];
    ss += v[i] * v[i];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / D;
  const float rstd = rsqrtf(fmaxf(0.f, ss / D - mu * mu) + kLnEpsB);
#pragma unroll
  for (int i = 0; i < D / 32; ++i) v[i] = (v[i] - mu) * rstd;
  return rstd;
}

// dx of a LayerNorm given its output gradient dy (f32) and x-hat, rstd
template <int D>
__device__ __forceinline__ void ln_dx(float* dx, const float* dy, const float* xhat,
                                      const float* g, float rstd, int lane) {
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    dx[i] = dy[i] * g[ln_col(i, lane)];
    m1 += dx[i];
    m2 += dx[i] * xhat[i];
  }
  m1 = warp_sum(m1) / D;
  m2 = warp_sum(m2) / D;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) dx[i] = rstd * (dx[i] - m1 - xhat[i] * m2);
}

// per-block column sums of `nq` per-lane accumulators into part[blk][3][D]
template <int D>
__device__ __forceinline__ void block_colsums(float (*acc)[D / 32], int nq, float* part,
                                              float* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int q = 0; q < nq; ++q) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i) red[warp * D + ln_col(i, lane)] = acc[q][i];
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < 8; ++w) s += red[w * D + c];
      part[((long long)blockIdx.x * 3 + q) * D + c] = s;
    }
    __syncthreads();
  }
}

// 1. dOP = post-LN backward of drop^T(dy); partials (dG_post, dB_post, dB_out)
template <int D>
__global__ void __launch_bounds__(256) ln_post_bwd_kernel(
    const bf16* __restrict__ op, const bf16* __restrict__ dy, const float* __restrict__ g,
    bf16* __restrict__ dop, float* __restrict__ part, int M, Dropout drop) {
  constexpr int kLPer = D / 32;  // values per lane
  __shared__ float red[8 * D];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[3][kLPer];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < kLPer; ++i) acc[q][i] = 0.f;
  for (int rr = 0; rr < kLRows / 8; ++rr) {
    const int row = blockIdx.x * kLRows + warp * (kLRows / 8) + rr;
    if (row >= M) break;
    float xh[kLPer], dn[kLPer], dx[kLPer];
    ln_load_bf16<D>(xh, op + (long long)row * D, lane);
    const float rstd = ln_xhat<D>(xh);
    ln_load_bf16<D>(dn, dy + (long long)row * D, lane);
    if (drop.thresh) {
#pragma unroll
      for (int i = 0; i < kLPer; ++i)
        dn[i] = dropout_keep(drop, row, ln_col(i, lane)) ? dn[i] * drop.scale : 0.f;
    }
    ln_dx<D>(dx, dn, xh, g, rstd, lane);
    ln_store_bf16<D>(dop + (long long)row * D, dx, lane);
#pragma unroll
    for (int i = 0; i < kLPer; ++i) {
      acc[0][i] += dn[i] * xh[i];
      acc[1][i] += dn[i];
      acc[2][i] += dx[i];
    }
  }
  block_colsums<D>(acc, 3, part, red);
}

// 5. dX = dy + pre-LN backward of dXL; partials (dG_pre, dB_pre)
template <int D>
__global__ void __launch_bounds__(256) ln_pre_bwd_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dxl, const bf16* __restrict__ dy,
    const float* __restrict__ g, bf16* __restrict__ dx_out, float* __restrict__ part,
    int M) {
  constexpr int kLPer = D / 32;  // values per lane
  __shared__ float red[8 * D];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[2][kLPer];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < kLPer; ++i) acc[q][i] = 0.f;
  for (int rr = 0; rr < kLRows / 8; ++rr) {
    const int row = blockIdx.x * kLRows + warp * (kLRows / 8) + rr;
    if (row >= M) break;
    float xh[kLPer], dl[kLPer], dx[kLPer], r[kLPer];
    ln_load_bf16<D>(xh, x + (long long)row * D, lane);
    const float rstd = ln_xhat<D>(xh);
#pragma unroll
    for (int p = 0; p < D / 256; ++p) {
      const float4* src =
          reinterpret_cast<const float4*>(dxl + (long long)row * D + p * 256 + lane * 8);
      const float4 a = src[0], b = src[1];
      dl[p * 8 + 0] = a.x; dl[p * 8 + 1] = a.y; dl[p * 8 + 2] = a.z; dl[p * 8 + 3] = a.w;
      dl[p * 8 + 4] = b.x; dl[p * 8 + 5] = b.y; dl[p * 8 + 6] = b.z; dl[p * 8 + 7] = b.w;
    }
    ln_dx<D>(dx, dl, xh, g, rstd, lane);
    ln_load_bf16<D>(r, dy + (long long)row * D, lane);
#pragma unroll
    for (int i = 0; i < kLPer; ++i) {
      r[i] += dx[i];
      acc[0][i] += dl[i] * xh[i];
      acc[1][i] += dl[i];
    }
    ln_store_bf16<D>(dx_out + (long long)row * D, r, lane);
  }
  block_colsums<D>(acc, 2, part, red);
}

static cudaError_t launch_ln_post_bwd(const bf16* op, const bf16* dy, const float* g,
                                      bf16* dop, float* part, float* dvec, int M, int D,
                                      Dropout drop, cudaStream_t st) {
  const int nblk = (M + kLRows - 1) / kLRows;
  cudaError_t err = with_decoder_width(D, [&](auto w) {
    ln_post_bwd_kernel<decltype(w)::value><<<nblk, 256, 0, st>>>(op, dy, g, dop, part, M, drop);
  });
  if (err != cudaSuccess) return err;
  // rows 6, 7 (dG_post, dB_post) and 3 (dB_out) of dvec
  err = launch_reduce(part, nblk, 3 * D, 2 * D, dvec + 6 * D, nullptr, st);
  if (err != cudaSuccess) return err;
  return launch_reduce(part + 2 * D, nblk, 3 * D, D, dvec + 3 * D, nullptr, st);
}

static cudaError_t launch_ln_pre_bwd(const bf16* x, const float* dxl, const bf16* dy,
                                     const float* g, bf16* dx, float* part, float* dvec,
                                     int M, int D, cudaStream_t st) {
  const int nblk = (M + kLRows - 1) / kLRows;
  cudaError_t err = with_decoder_width(D, [&](auto w) {
    ln_pre_bwd_kernel<decltype(w)::value><<<nblk, 256, 0, st>>>(x, dxl, dy, g, dx, part, M);
  });
  if (err != cudaSuccess) return err;
  // rows 4, 5 (dG_pre, dB_pre) of dvec
  return launch_reduce(part, nblk, 3 * D, 2 * D, dvec + 4 * D, nullptr, st);
}

}  // namespace crog

#define CROG_TRY(...)                       \
  do {                                      \
    cudaError_t e_ = (__VA_ARGS__);         \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

using crog::bf16;

namespace {
template <typename T>
T* P(void* const* t, int i) {
  return static_cast<T*>(t[i]);
}

// bf16(dy W) for dy [M, D] and a torch-layout weight W [out D, in D] (the
// TPU kernels' `_dense_t`, pallas_decoder.py:92), to the bf16 output `out`
crog::GemmArgs dense_t(const bf16* dy, const bf16* w, int M, int D, bf16* out = nullptr) {
  crog::GemmArgs g = {};
  g.a[0] = dy;
  g.b[0] = w;
  g.cb = out;
  g.lda = g.ldb = g.ldc = D;
  g.M = M;
  g.K = D;
  return g;
}
}  // namespace

// Self block backward.  t: table of device pointers, in order
//   0 x, 1 w_in [3D, D], 2 w_out [D, D], 3 g_pre, 4 g_post, 5 xl, 6 qin,
//   7 qk [B*L, 2D], 8 v, 9 o, 10 op (forward intermediates, bf16 [B*L, D]
//   unless noted; LN scales f32 [D]), 11 dy;
//   outputs 12 dx, 13 dw_in [3D, D] bf16, 14 dw_out bf16, 15 dvec [8, D] f32
//   (d b_q, b_k, b_v, b_out, g_pre, b_pre, g_post, b_post);
//   workspace 16 dop, 17 do, 18 dq, 19 dk, 20 dv (bf16 [B*L, D]), 21 dxl f32
//   [B*L, D], 22 stats f32 [3, B*H, L], 23 wpart f32 [splits, D, D],
//   24 cpart f32 [splits, D], 25 lnpart f32 [ceil(B*L/64), 3, D].
extern "C" int crog_self_block_bwd(void* const* t, int B, int L, int D, int heads,
                                   int splits, unsigned seed, unsigned thresh,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dh = crog::attn_head_dim(D, heads);
  if (!crog::decoder_width_ok(D) || dh == 0) return (int)cudaErrorInvalidValue;
  const int M = B * L;
  const long long DD = (long long)D * D;
  const bf16* wi = P<const bf16>(t, 1);
  float* dvec = P<float>(t, 15);
  float* lnpart = P<float>(t, 25);
  CROG_TRY(crog::launch_ln_post_bwd(P<bf16>(t, 10), P<bf16>(t, 11), P<float>(t, 4),
                                    P<bf16>(t, 16), lnpart, dvec, M, D,
                                    crog::Dropout{seed, thresh, scale}, st));
  CROG_TRY(crog::launch_gemm_nn<1, false>(  // dO
      dense_t(P<bf16>(t, 16), P<bf16>(t, 2), M, D, P<bf16>(t, 17)), D, st));
  crog::AttnBwdArgs a;
  a.q = P<bf16>(t, 7);
  a.k = P<bf16>(t, 7) + D;
  a.v = P<bf16>(t, 8);
  a.o = nullptr;
  a.dout = P<bf16>(t, 17);
  a.mask = nullptr;
  a.dq = P<bf16>(t, 18);
  a.dk = P<bf16>(t, 19);
  a.dv = P<bf16>(t, 20);
  a.stats = P<float>(t, 22);
  a.heads = heads;
  a.lq = a.lk = L;
  a.q_bs = a.k_bs = (long long)L * 2 * D;
  a.q_rs = a.k_rs = 2 * D;
  a.v_bs = a.o_bs = a.do_bs = a.dq_bs = a.dk_bs = a.dv_bs = (long long)L * D;
  a.v_rs = a.o_rs = a.do_rs = a.dq_rs = a.dk_rs = a.dv_rs = D;
  a.dh = dh;
  a.scale = crog::attn_scale(dh);
  CROG_TRY(crog::launch_attention_bwd<crog::kBwdBf16>(a, B, st));
  float* dxl = P<float>(t, 21);
  crog::GemmArgs g = dense_t(a.dq, wi, M, D);
  g.a[1] = a.dk;
  g.b[1] = wi + DD;
  g.a[2] = a.dv;
  g.b[2] = wi + 2 * DD;
  g.cf = dxl;
  CROG_TRY(crog::launch_gemm_nn<3, true>(g, D, st));
  CROG_TRY(crog::launch_ln_pre_bwd(P<bf16>(t, 0), dxl, P<bf16>(t, 11), P<float>(t, 3),
                                   P<bf16>(t, 12), lnpart, dvec, M, D, st));
  bf16* dwi = P<bf16>(t, 13);
  float* wpart = P<float>(t, 23);
  float* cpart = P<float>(t, 24);
  const bf16* qin = P<bf16>(t, 6);
  CROG_TRY(crog::launch_wgrad(a.dq, D, qin, D, dwi, dvec, wpart, cpart, M, D, D, splits, st));
  CROG_TRY(crog::launch_wgrad(a.dk, D, qin, D, dwi + DD, dvec + D, wpart, cpart, M, D, D,
                              splits, st));
  CROG_TRY(crog::launch_wgrad(a.dv, D, P<bf16>(t, 5), D, dwi + 2 * DD, dvec + 2 * D, wpart,
                              cpart, M, D, D, splits, st));
  CROG_TRY(crog::launch_wgrad(P<bf16>(t, 16), D, P<bf16>(t, 9), D, P<bf16>(t, 14), nullptr,
                              wpart, cpart, M, D, D, splits, st));
  return 0;
}

// Cross block backward.  t: table of device pointers, in order
//   0 x, 1 kv [B*T, D], 2 mask f32 [B, T], 3 w_in, 4 w_out, 5 g_pre,
//   6 g_post, 7 qin, 8 q, 9 o, 10 kin [B*T, D], 11 k [B*T, D],
//   12 v [B*T, D], 13 op, 14 dy;
//   outputs 15 dx, 16 dkv bf16 [B*T, D], 17 dw_in, 18 dw_out, 19 dvec;
//   workspace 20 dop, 21 do, 22 dq (bf16 [B*L, D]), 23 dk, 24 dv (bf16
//   [B*T, D]), 25 dxl f32 [B*L, D], 26 stats f32 [3, B*H, L], 27 wpart,
//   28 cpart, 29 lnpart as for the self block.
extern "C" int crog_cross_block_bwd(void* const* t, int B, int L, int T, int D,
                                    int heads, int splits, unsigned seed,
                                    unsigned thresh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dh = crog::attn_head_dim(D, heads);
  if (!crog::decoder_width_ok(D) || dh == 0) return (int)cudaErrorInvalidValue;
  const int M = B * L;
  const int MT = B * T;
  const long long DD = (long long)D * D;
  const bf16* wi = P<const bf16>(t, 3);
  float* dvec = P<float>(t, 19);
  float* lnpart = P<float>(t, 29);
  CROG_TRY(crog::launch_ln_post_bwd(P<bf16>(t, 13), P<bf16>(t, 14), P<float>(t, 6),
                                    P<bf16>(t, 20), lnpart, dvec, M, D,
                                    crog::Dropout{seed, thresh, scale}, st));
  CROG_TRY(crog::launch_gemm_nn<1, false>(  // dO
      dense_t(P<bf16>(t, 20), P<bf16>(t, 4), M, D, P<bf16>(t, 21)), D, st));
  crog::AttnBwdArgs a;
  a.q = P<bf16>(t, 8);
  a.k = P<bf16>(t, 11);
  a.v = P<bf16>(t, 12);
  a.o = nullptr;
  a.dout = P<bf16>(t, 21);
  a.mask = P<float>(t, 2);
  a.dq = P<bf16>(t, 22);
  a.dk = P<bf16>(t, 23);
  a.dv = P<bf16>(t, 24);
  a.stats = P<float>(t, 26);
  a.heads = heads;
  a.lq = L;
  a.lk = T;
  a.q_bs = a.o_bs = a.do_bs = a.dq_bs = (long long)L * D;
  a.k_bs = a.v_bs = a.dk_bs = a.dv_bs = (long long)T * D;
  a.q_rs = a.k_rs = a.v_rs = a.o_rs = a.do_rs = a.dq_rs = a.dk_rs = a.dv_rs = D;
  a.dh = dh;
  a.scale = crog::attn_scale(dh);
  CROG_TRY(crog::launch_attention_bwd<crog::kBwdBf16>(a, B, st));
  float* dxl = P<float>(t, 25);
  crog::GemmArgs g = dense_t(a.dq, wi, M, D);
  g.cf = dxl;
  CROG_TRY(crog::launch_gemm_nn<1, true>(g, D, st));
  g = dense_t(a.dk, wi + DD, MT, D);
  g.a[1] = a.dv;
  g.b[1] = wi + 2 * DD;
  g.cb = P<bf16>(t, 16);
  CROG_TRY(crog::launch_gemm_nn<2, false>(g, D, st));
  CROG_TRY(crog::launch_ln_pre_bwd(P<bf16>(t, 0), dxl, P<bf16>(t, 14), P<float>(t, 5),
                                   P<bf16>(t, 15), lnpart, dvec, M, D, st));
  bf16* dwi = P<bf16>(t, 17);
  float* wpart = P<float>(t, 27);
  float* cpart = P<float>(t, 28);
  CROG_TRY(crog::launch_wgrad(a.dq, D, P<bf16>(t, 7), D, dwi, dvec, wpart, cpart, M, D, D,
                              splits, st));
  CROG_TRY(crog::launch_wgrad(a.dk, D, P<bf16>(t, 10), D, dwi + DD, dvec + D, wpart, cpart,
                              MT, D, D, splits, st));
  CROG_TRY(crog::launch_wgrad(a.dv, D, P<bf16>(t, 1), D, dwi + 2 * DD, dvec + 2 * D, wpart,
                              cpart, MT, D, D, splits, st));
  CROG_TRY(crog::launch_wgrad(P<bf16>(t, 20), D, P<bf16>(t, 9), D, P<bf16>(t, 18), nullptr,
                              wpart, cpart, M, D, D, splits, st));
  return 0;
}

// out[8]: the fused dX GEMM's (gemm_nn_kernel, three products, f32 out)
// registers per thread, shared memory per CTA (static + dynamic), spill
// bytes per thread and CTAs per SM; then the same of wgrad_kernel
extern "C" int crog_decoder_bwd_attrs(void* out_) {
  using Ring = crog::GemmRing<64, false, crog::kGKDeep>;
  int* out = static_cast<int*>(out_);
  CROG_TRY(crog::gemm_nn_smem_once<3, true>());
  CROG_TRY(crog::wgrad_smem_once());
  cudaFuncAttributes fa;
  CROG_TRY(cudaFuncGetAttributes(&fa, crog::gemm_nn_kernel<3, true>));
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + Ring::kSmem);
  out[2] = (int)fa.localSizeBytes;
  CROG_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], crog::gemm_nn_kernel<3, true>, crog::kGThreads, Ring::kSmem));
  CROG_TRY(cudaFuncGetAttributes(&fa, crog::wgrad_kernel));
  out[4] = fa.numRegs;
  out[5] = (int)(fa.sharedSizeBytes + crog::WgradRing::kSmem);
  out[6] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[7], crog::wgrad_kernel, crog::kGThreads, crog::WgradRing::kSmem);
}
