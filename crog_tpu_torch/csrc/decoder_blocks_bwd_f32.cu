// K2b-f32 / K3b-f32: backward of the decoder's pre-LN self- and
// cross-attention blocks on fp32 operands, C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_decoder.py:450 `_self_bwd_vjp` (pallas_call
// at :457, kernel `_self_bwd_kernel` :233) and :542 `_cross_bwd_vjp`
// (pallas_call at :550, kernel `_cross_bwd_kernel` :320) where the model
// computes in fp32: every cast there (pallas_decoder.py:69, 89, 96, 123,
// 174) goes to x's dtype, which is then f32, so nothing is rounded.  The
// twins are ops/decoder_blocks.py:self_block_bwd_plain /
// cross_block_bwd_plain, whose bf16 cast points do nothing at fp32.  The
// weight gradients, the bias sums and the LayerNorm affines' gradients
// come out of the Pallas kernel itself (pallas_decoder.py:476), so they are
// hand-written here too, summed over the B*L rows in a fixed order.
//
// Bound on an H100 at the main path (B=24, 676 tokens, D 512, 8 heads of
// 64, 17 text tokens; ops/work.py, 3xTF32 at a third of TF32's 495
// TFLOP/s): K2b 124 GFLOP, about 0.75 ms; K3b 36 GFLOP, about 0.22 ms;
// both bound by the products.  At D 1024 about 2.2x K2-f32's 181 GFLOP.
//
// Design: a sequence of launches per block over the intermediates the
// fp32 forward (decoder_blocks_f32.cu) saved (xl, qin, q/k/v, o and the
// pre-LN projection op), every intermediate in device memory:
//   1. ln_post_bwd: dOP = post-LN backward of drop(dy), the dropout mask
//      regenerated from (row, column) and the seed (common.cuh); column
//      partials of dG_post, dB_post, dB_out = sum(dOP), summed in order
//   2. dO = dOP W_out
//   3. the attention backward -> dQ, dK, dV         attention_bwd_f32.cuh
//      (delta = rowsum(dP * P), as pallas_decoder.py's `_mha_bwd`): a
//      pre-pass forms QK^T and dO V^T once for each row's max, sum and
//      delta; the main pass, a CTA per 64 keys streaming 32-query tiles,
//      forms QK^T, dO V^T, P^T dO, dS^T Q and dS K once each (wgmma .tf32,
//      3xTF32: 7 products per pair in all, 10 before; 115,456 bytes of
//      shared memory, two CTAs per SM) and writes one dQ partial per key
//      block, which a third kernel adds in order; bound by the products
//      (56 GFLOP, 0.34 ms at K2b's 676 tokens), the 11 partials add 0.22
//      ms of bytes
//      (self: into one [M, 3D] buffer; cross: dQ [M, D], dK | dV [B*T, 2D])
//   4. dXL = [dQ dK dV] W_in, one product over K = 3D (in_w's rows are Wq,
//      Wk, Wv in order); cross: dXL = dQ Wq, d(txt) = [dK dV] [Wk; Wv]
//   5. ln_pre_bwd: dX = dy + pre-LN backward of dXL; partials of dG_pre,
//      dB_pre
//   6. dW = dY^T X: self [q | k] (one product, 2D rows of in_w), v and
//      out; cross q, k, v and out; and the q/k/v bias sums as fixed-order
//      column sums of dQ, dK, dV
// Every product of 2, 4 and 6 runs on gemm_wgmma_f32.cuh (wgmma
// m64n128k8 .tf32, 3xTF32, A split in registers; B, the weight or the D
// wide activation X of a dW, split once into its TF32 hi and lo planes,
// one `planes` workspace reused in stream order; dW reads dY transposed,
// GwAMatrix<true>).  A product whose output tiles leave most of the card
// idle is split over K (`bwd_chunk`: the dW over the B*L rows, d(txt) and
// the dW over the B*T text rows), one partial per chunk summed in chunk
// order into the output (grad_f32.cuh reduce_parts): no atomics, two
// calls give the same bits.
// The LayerNorm kernels take a D-wide row at a time with D / 8 threads of
// 8 columns each (grad_f32.cuh RowBlock: 32 to 128 threads at D 256 to
// 1024, one build per width), over 32 rows per CTA.  D is a run-time value
// of every product.
#include "attention_bwd_f32.cuh"
#include "gemm_wgmma_f32.cuh"
#include "grad_f32.cuh"

namespace crog {

constexpr int kLnBwdRows = 32;  // rows per CTA of the LayerNorm kernels

inline int ln_bwd_blocks(int rows) { return (rows + kLnBwdRows - 1) / kLnBwdRows; }

// 1. dop = LN backward of drop(dy) at op's x-hat; part [blocks][3][D] of
// (dG_post, dB_post, dB_out) = (sum drop(dy) xhat, sum drop(dy), sum dop)
template <int D>
__global__ void __launch_bounds__(RowBlock<D>::kThreads) ln_post_bwd_f32_kernel(
    const float* __restrict__ op, const float* __restrict__ dy, const float* __restrict__ g,
    Dropout drop, float* __restrict__ dop, float* __restrict__ part, int rows) {
  __shared__ float red[2 * RowBlock<D>::kWarps];
  float acc[3][8];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.0f;
  const int r0 = blockIdx.x * kLnBwdRows, r1 = min(rows, r0 + kLnBwdRows);
  for (int r = r0; r < r1; ++r) {
    float xh[8], d[8], dx[8];
    rb_load<D>(op + (long long)r * D, xh);
    const float rstd = rb_xhat<D>(xh, red);
    rb_load<D>(dy + (long long)r * D, d);
    if (drop.thresh != 0u) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = dropout_keep(drop, r, rb_col<D>(e)) ? d[e] * drop.scale : 0.0f;
    }
    rb_ln_dx<D>(dx, d, xh, g, rstd, red);
    rb_store<D>(dop + (long long)r * D, dx);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[0][e] += d[e] * xh[e];
      acc[1][e] += d[e];
      acc[2][e] += dx[e];
    }
  }
  rb_store_parts<D, 3>(acc, part);
}

// 5. dx = dy + LN backward of dxl at x's x-hat; part [blocks][2][D] of
// (dG_pre, dB_pre) = (sum dxl xhat, sum dxl)
template <int D>
__global__ void __launch_bounds__(RowBlock<D>::kThreads) ln_pre_bwd_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dxl, const float* __restrict__ dy,
    const float* __restrict__ g, float* __restrict__ dx_out, float* __restrict__ part,
    int rows) {
  __shared__ float red[2 * RowBlock<D>::kWarps];
  float acc[2][8];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.0f;
  const int r0 = blockIdx.x * kLnBwdRows, r1 = min(rows, r0 + kLnBwdRows);
  for (int r = r0; r < r1; ++r) {
    float xh[8], dl[8], dx[8], res[8];
    rb_load<D>(x + (long long)r * D, xh);
    const float rstd = rb_xhat<D>(xh, red);
    rb_load<D>(dxl + (long long)r * D, dl);
    rb_ln_dx<D>(dx, dl, xh, g, rstd, red);
    rb_load<D>(dy + (long long)r * D, res);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      res[e] += dx[e];
      acc[0][e] += dl[e] * xh[e];
      acc[1][e] += dl[e];
    }
    rb_store<D>(dx_out + (long long)r * D, res);
  }
  rb_store_parts<D, 2>(acc, part);
}

// dvec rows: 0-2 d b_q, b_k, b_v; 3 d b_out; 4, 5 d g_pre, b_pre; 6, 7 d
// g_post, b_post
static cudaError_t ln_post_bwd(const float* op, const float* dy, const float* g, Dropout drop,
                               float* dop, float* lnpart, float* dvec, int m, int d,
                               cudaStream_t s) {
  const int nb = ln_bwd_blocks(m);
  cudaError_t err = with_decoder_width(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    ln_post_bwd_f32_kernel<D><<<nb, RowBlock<D>::kThreads, 0, s>>>(op, dy, g, drop, dop, lnpart,
                                                                   m);
  });
  if (err == cudaSuccess) err = reduce_parts(lnpart, nb, 3 * d, 2 * d, dvec + 6 * d, s);
  if (err == cudaSuccess) err = reduce_parts(lnpart + 2 * d, nb, 3 * d, d, dvec + 3 * d, s);
  return err;
}

static cudaError_t ln_pre_bwd(const float* x, const float* dxl, const float* dy, const float* g,
                              float* dx, float* lnpart, float* dvec, int m, int d,
                              cudaStream_t s) {
  const int nb = ln_bwd_blocks(m);
  cudaError_t err = with_decoder_width(d, [&](auto w) {
    constexpr int D = decltype(w)::value;
    ln_pre_bwd_f32_kernel<D><<<nb, RowBlock<D>::kThreads, 0, s>>>(x, dxl, dy, g, dx, lnpart, m);
  });
  if (err == cudaSuccess) err = reduce_parts(lnpart, nb, 2 * d, 2 * d, dvec + 4 * d, s);
  return err;
}

// CTAs of one wave: an H100 SXM's SMs, one CTA each
// (ops/decoder_blocks.py F32_BWD_WAVE)
constexpr int kBwdWave = 132;

// K per chunk of a product over depth k whose output has `tiles` tiles: as
// many equal chunks, a multiple of kGwK each (the last one shorter), as
// fill one wave with the tiles, and at least one
// (ops/decoder_blocks.py f32_bwd_chunks)
inline int bwd_chunk(int k, int tiles) {
  const int slices = (k + kGwK - 1) / kGwK;
  int n = kBwdWave / tiles < slices ? kBwdWave / tiles : slices;
  if (n < 1) n = 1;
  return round_up((k + n - 1) / n, kGwK);
}

// C [m, n] (row stride ldc) = A B over depth k, A [m, k] as stored (AT
// false) or read transposed from [k, m] (AT true; lda its row stride), B's
// planes split into `planes`: one chunk of bwd_chunk(k, tiles) writes C,
// more write their partials into part [chunks, m, n] and reduce_parts adds
// them in chunk order into C (then ldc == n)
template <bool AT, int PRODUCT>
static cudaError_t bwd_product(const float* a, long long lda, const float* planes, float* c,
                               long long ldc, float* part, int m, int n, int k,
                               cudaStream_t s) {
  const int kc = bwd_chunk(k, (n / kGwN) * ((m + kGwM - 1) / kGwM));
  const int chunks = (k + kc - 1) / kc;
  if (chunks > 1 && ldc != n) return cudaErrorInvalidValue;
  const long long mn = (long long)m * n;
  const GemmWgF32 p{a, planes, chunks > 1 ? part : c, nullptr, lda, gw_planes_ld(k),
                    chunks > 1 ? n : ldc, mn, m, n, k, kc, Dropout{0u, 0u, 1.0f}};
  cudaError_t err = gemm_wgmma_f32<AT, kGwStore, PRODUCT>(p, s);
  if (err != cudaSuccess || chunks == 1) return err;
  return reduce_parts(part, chunks, mn, mn, c, s);
}

// c [m, d] = a w over k: a [m, k] (row stride lda), w [k, d] read with its
// rows as K (a torch Linear weight's input gradient); dO, dX, d(txt)
template <int PRODUCT>
static cudaError_t bwd_weight(const float* a, long long lda, const float* w, float* planes,
                              float* c, float* part, int m, int k, int d, cudaStream_t s) {
  cudaError_t err = gw_split_b_planes<true, PRODUCT>(w, planes, d, k, s);
  if (err != cudaSuccess) return err;
  return bwd_product<false, PRODUCT>(a, lda, planes, c, d, part, m, d, k, s);
}

// dw [n, d] = dy^T x over `rows` batch rows: dy [rows, n] (row stride
// ldy), x [rows, d] (an activation, d wide)
static cudaError_t bwd_dw(const float* dy, long long ldy, const float* x, float* planes,
                          float* dw, float* part, int n, int rows, int d, cudaStream_t s) {
  cudaError_t err = gw_split_b_planes<true, kProdDW>(x, planes, d, rows, s);
  if (err != cudaSuccess) return err;
  return bwd_product<true, kProdDW>(dy, ldy, planes, dw, d, part, n, d, rows, s);
}

static AttnBwdF32Args attn_args(int heads, int dh, int lq, int lk) {
  AttnBwdF32Args a = {};
  a.heads = heads;
  a.dh = dh;
  a.lq = lq;
  a.lk = lk;
  a.scale = attn_scale(dh);  // dh^-0.5, as ops/attention.py passes it
  return a;
}

}  // namespace crog

#define CROG_TRY(...)                       \
  do {                                      \
    cudaError_t e_ = (__VA_ARGS__);         \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

namespace {
float* P(void* const* t, int i) { return static_cast<float*>(t[i]); }
}  // namespace

// Self block backward.  t: table of device pointers (f32), in order
//   0 x [B*L, D], 1 w_in [3D, D], 2 w_out [D, D], 3 g_pre, 4 g_post [D],
//   5 xl, 6 qin, 7 qk [B*L, 2D], 8 v, 9 o, 10 op (the forward's
//   intermediates, [B*L, D] unless noted), 11 dy;
//   outputs 12 dx, 13 dw_in [3D, D], 14 dw_out [D, D], 15 dvec [8, D]
//   (d b_q, b_k, b_v, b_out, g_pre, b_pre, g_post, b_post);
//   workspace 16 dop, 17 do [B*L, D], 18 dqkv [B*L, 3D], 19 dxl [B*L, D],
//   20 stats [B*H, 3, L], 21 part (the chunk partials of the products,
//   ops/decoder_blocks.py f32_bwd_work), 22 lnpart [ceil(B*L/32), 3, D],
//   23 cpart [ceil(B*L/256), 3D], 24 dqpart [ab_f32_parts(L), B*H, L, D / H],
//   25 planes (the TF32 planes of each product's B, f32_bwd_work).
extern "C" int crog_self_block_f32_bwd(void* const* t, int b, int l, int d, int heads,
                                       unsigned seed, unsigned thresh, float scale,
                                       void* stream) {
  using namespace crog;
  const int dh = attn_head_dim(d, heads);
  if (!decoder_width_ok(d) || dh == 0 || l < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * l;
  const long long dd = (long long)d * d;
  float *x = P(t, 0), *wi = P(t, 1), *wo = P(t, 2), *g_pre = P(t, 3), *g_post = P(t, 4),
        *xl = P(t, 5), *qin = P(t, 6), *qk = P(t, 7), *v = P(t, 8), *o = P(t, 9),
        *op = P(t, 10), *dy = P(t, 11);
  float *dx = P(t, 12), *dwi = P(t, 13), *dwo = P(t, 14), *dvec = P(t, 15);
  float *dop = P(t, 16), *dO = P(t, 17), *dqkv = P(t, 18), *dxl = P(t, 19), *stats = P(t, 20),
        *part = P(t, 21), *lnpart = P(t, 22), *cpart = P(t, 23), *dqpart = P(t, 24),
        *planes = P(t, 25);

  CROG_TRY(ln_post_bwd(op, dy, g_post, Dropout{seed, thresh, scale}, dop, lnpart, dvec, m, d,
                       s));
  CROG_TRY(bwd_weight<kProdDO>(dop, d, wo, planes, dO, part, m, d, d, s));
  AttnBwdF32Args a = attn_args(heads, dh, l, l);
  a.q = qk;
  a.k = qk + d;
  a.v = v;
  a.o = nullptr;  // delta = rowsum(dP * P), as `_mha_bwd`
  a.dout = dO;
  a.mask = nullptr;
  a.dq = dqkv;
  a.dk = dqkv + d;
  a.dv = dqkv + 2 * d;
  a.stats = stats;
  a.dqpart = dqpart;
  a.q_bs = a.k_bs = (long long)l * 2 * d;
  a.q_rs = a.k_rs = 2 * d;
  a.v_bs = a.o_bs = a.do_bs = (long long)l * d;
  a.v_rs = a.o_rs = a.do_rs = d;
  a.dq_bs = a.dk_bs = a.dv_bs = (long long)l * 3 * d;
  a.dq_rs = a.dk_rs = a.dv_rs = 3 * d;
  CROG_TRY(launch_attention_bwd_f32(a, b, s));
  CROG_TRY(bwd_weight<kProdDX>(dqkv, 3 * d, wi, planes, dxl, part, m, 3 * d, d, s));
  CROG_TRY(ln_pre_bwd(x, dxl, dy, g_pre, dx, lnpart, dvec, m, d, s));
  // d in_w: rows [0, 2D) = [dq dk]^T qin, rows [2D, 3D) = dv^T xl
  CROG_TRY(bwd_dw(dqkv, 3 * d, qin, planes, dwi, part, 2 * d, m, d, s));
  CROG_TRY(bwd_dw(dqkv + 2 * d, 3 * d, xl, planes, dwi + 2 * dd, part, d, m, d, s));
  CROG_TRY(bwd_dw(dop, d, o, planes, dwo, part, d, m, d, s));
  CROG_TRY(colsum_f32(dqkv, 3 * d, m, 3 * d, cpart, dvec, s));
  return 0;
}

// Cross block backward.  t: table of device pointers (f32), in order
//   0 x [B*L, D], 1 kv [B*T, D] (the text), 2 mask [B, T] additive,
//   3 w_in, 4 w_out, 5 g_pre, 6 g_post, 7 qin, 8 q, 9 o [B*L, D],
//   10 kin, 11 k, 12 v [B*T, D], 13 op [B*L, D], 14 dy;
//   outputs 15 dx, 16 dkv [B*T, D] (d txt), 17 dw_in, 18 dw_out, 19 dvec;
//   workspace 20 dop, 21 do, 22 dq [B*L, D], 23 dkv2 [B*T, 2D] (dk | dv),
//   24 dxl [B*L, D], 25 stats [B*H, 3, L], 26 part (as for the self
//   block), 27 lnpart, 28 cpart [ceil(B*L/256), D] as for the self block,
//   29 dqpart [ab_f32_parts(T), B*H, L, D / H], 30 planes.
extern "C" int crog_cross_block_f32_bwd(void* const* t, int b, int l, int tt, int d, int heads,
                                        unsigned seed, unsigned thresh, float scale,
                                        void* stream) {
  using namespace crog;
  const int dh = attn_head_dim(d, heads);
  if (!decoder_width_ok(d) || dh == 0 || l < 1 || tt < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * l, mt = b * tt;
  const long long dd = (long long)d * d;
  float *x = P(t, 0), *kv = P(t, 1), *mask = P(t, 2), *wi = P(t, 3), *wo = P(t, 4),
        *g_pre = P(t, 5), *g_post = P(t, 6), *qin = P(t, 7), *q = P(t, 8), *o = P(t, 9),
        *kin = P(t, 10), *k = P(t, 11), *v = P(t, 12), *op = P(t, 13), *dy = P(t, 14);
  float *dx = P(t, 15), *dkv = P(t, 16), *dwi = P(t, 17), *dwo = P(t, 18), *dvec = P(t, 19);
  float *dop = P(t, 20), *dO = P(t, 21), *dq = P(t, 22), *dkv2 = P(t, 23), *dxl = P(t, 24),
        *stats = P(t, 25), *part = P(t, 26), *lnpart = P(t, 27), *cpart = P(t, 28),
        *dqpart = P(t, 29), *planes = P(t, 30);

  CROG_TRY(ln_post_bwd(op, dy, g_post, Dropout{seed, thresh, scale}, dop, lnpart, dvec, m, d,
                       s));
  CROG_TRY(bwd_weight<kProdDO>(dop, d, wo, planes, dO, part, m, d, d, s));
  AttnBwdF32Args a = attn_args(heads, dh, l, tt);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = nullptr;  // delta = rowsum(dP * P), as `_mha_bwd`
  a.dout = dO;
  a.mask = mask;
  a.dq = dq;
  a.dk = dkv2;
  a.dv = dkv2 + d;
  a.stats = stats;
  a.dqpart = dqpart;
  a.q_bs = a.o_bs = a.do_bs = a.dq_bs = (long long)l * d;
  a.k_bs = a.v_bs = (long long)tt * d;
  a.dk_bs = a.dv_bs = (long long)tt * 2 * d;
  a.q_rs = a.k_rs = a.v_rs = a.o_rs = a.do_rs = a.dq_rs = d;
  a.dk_rs = a.dv_rs = 2 * d;
  CROG_TRY(launch_attention_bwd_f32(a, b, s));
  CROG_TRY(bwd_weight<kProdDX>(dq, d, wi, planes, dxl, part, m, d, d, s));
  CROG_TRY(bwd_weight<kProdDX>(dkv2, 2 * d, wi + dd, planes, dkv, part, mt, 2 * d, d, s));
  CROG_TRY(ln_pre_bwd(x, dxl, dy, g_pre, dx, lnpart, dvec, m, d, s));
  CROG_TRY(bwd_dw(dq, d, qin, planes, dwi, part, d, m, d, s));
  CROG_TRY(bwd_dw(dkv2, 2 * d, kin, planes, dwi + dd, part, d, mt, d, s));
  CROG_TRY(bwd_dw(dkv2 + d, 2 * d, kv, planes, dwi + 2 * dd, part, d, mt, d, s));
  CROG_TRY(bwd_dw(dop, d, o, planes, dwo, part, d, m, d, s));
  CROG_TRY(colsum_f32(dq, d, m, d, cpart, dvec, s));
  CROG_TRY(colsum_f32(dkv2, 2 * d, mt, 2 * d, cpart, dvec + d, s));
  return 0;
}
