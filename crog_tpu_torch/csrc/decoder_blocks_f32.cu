// K2-f32 / K3-f32: the decoder's pre-LN self- and cross-attention blocks'
// forward on fp32 operands, C interface for ctypes:
//
//   self : y = x + drop(LN_post(OutProj(MHA(LN_pre(x)+pos, LN_pre(x)+pos, LN_pre(x)))))
//   cross: y = x + drop(LN_post(OutProj(MHA(LN_pre(x)+pos, txt+tpos, txt))))
//
// Replaces crog_tpu/ops/pallas_decoder.py `_self_fwd` (pallas_call at
// :422) and `_cross_fwd` (pallas_call at :511) where the model computes in
// fp32: the Pallas kernels cast every Dense and LN result to x's dtype,
// which is then f32, so nothing is rounded to bf16.  The twins are
// ops/decoder_blocks.py:self_block_plain / cross_block_plain.
//
// Bound on an H100 at the main path (B=24, 676 tokens, D 512, 8 heads of
// 64, 17 text tokens): K2 is 56.5 GFLOP (the four projections 34, the
// attention 22.5), about 0.34 ms at 3xTF32's third of TF32's 495
// TFLOP/s; K3 18 GFLOP, about 0.11 ms; x and y are 66 MB (20 us), so
// operations bound both.  At D 1024 (8 heads of 128): 181 and 71 GFLOP.
//
// D is a run-time value of the products (any of decoder_width_ok's 256,
// 512, 768 and 1024) and a template argument of the two row kernels (a
// lane holds D / 32 floats), built for each width.
//
// Design: a few launches per block, every intermediate [M, D] in device
// memory (K2b-f32 / K3b-f32 read xl, qin, the q/k/v products, o and op):
//   ln_pos     xl = LN_pre(x), qin = xl + pos      (ln_f32.cuh helpers)
//              (cross: kin = txt + tpos, the same kernel without the LN)
//   projections, each on gemm_wgmma_f32.cuh (wgmma .tf32, A split in
//              registers, TMA-fed) with the bias in its epilogue, the
//              weight's rows split once per call into TF32 hi and lo planes
//              in the `planes` workspace (ops/decoder_blocks.py
//              f32_planes): self: [q | k] = qin W[0:2D]^T (one product,
//              N = 2D), v = xl W[2D:3D]^T;  cross: q = qin W_q^T, k = kin
//              W_k^T, v = txt W_v^T over the B*T text rows
//   attention  attention_f32.cuh's wgmma kernel (q and k as column slices
//              of the packed [M, 2D] product; cross: the 17 keys with the
//              key mask)
//   op = o W_out^T + b_out                          gemm_wgmma_f32.cuh
//   ln_res     y = x + drop(LN_post(op))            dropout over (b*L + l,
//              column), ops/dropout.py's mask, x * keep / (1 - rate) in f32
// No product falls back to mma.sync.
#include "attention_f32.cuh"
#include "gemm_wgmma_f32.cuh"
#include "ln_f32.cuh"

namespace crog {

// xl = LN(x) * g + b when LN (else xl = x); qin = xl + pos[row % period];
// xl is stored only where xl_out is not null
template <int D, bool LN>
__global__ void __launch_bounds__(kLnF32Warps * 32)
    ln_pos_f32_kernel(const float* x, const float* g, const float* bt, const float* pos,
                      int period, float* xl_out, float* qin, int rows) {
  const int r = blockIdx.x * kLnF32Warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float4 v[D / 128];
  ln_load<D>(x + (long long)r * D, v, lane);
  if (LN) {
    float mu, rstd;
    ln_stats<D>(v, mu, rstd);
    ln_apply<D>(v, mu, rstd, g, bt, lane);
    if (xl_out != nullptr) ln_store<D>(xl_out + (long long)r * D, v, lane);
  }
  float4 p[D / 128];
  ln_load<D>(pos + (long long)(r % period) * D, p, lane);
#pragma unroll
  for (int i = 0; i < D / 128; ++i) {
    v[i].x += p[i].x;
    v[i].y += p[i].y;
    v[i].z += p[i].z;
    v[i].w += p[i].w;
  }
  ln_store<D>(qin + (long long)r * D, v, lane);
}

// y = x + drop(LN(op) * g + b)
template <int D>
__global__ void __launch_bounds__(kLnF32Warps * 32)
    ln_residual_f32_kernel(const float* op, const float* x, const float* g, const float* bt,
                           Dropout drop, float* y, int rows) {
  const int r = blockIdx.x * kLnF32Warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  float4 v[D / 128], xr[D / 128];
  ln_load<D>(op + (long long)r * D, v, lane);
  ln_load<D>(x + (long long)r * D, xr, lane);
  float mu, rstd;
  ln_stats<D>(v, mu, rstd);
  ln_apply<D>(v, mu, rstd, g, bt, lane);
#pragma unroll
  for (int i = 0; i < D / 128; ++i) {
    float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    const float xs[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
    const int c0 = 4 * (lane + 32 * i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (drop.thresh != 0u) e[j] = dropout_keep(drop, r, c0 + j) ? e[j] * drop.scale : 0.0f;
      e[j] = xs[j] + e[j];
    }
    v[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  ln_store<D>(y + (long long)r * D, v, lane);
}

static int row_blocks(int rows) { return (rows + kLnF32Warps - 1) / kLnF32Warps; }

// xl = LN_pre(x) (stored where xl is not null), qin = xl + pos[row % l] over
// m rows of width d; without LN (the cross block's kin = txt + tpos) x as is
template <bool LN>
static cudaError_t ln_pos(const float* x, const float* g, const float* bt, const float* pos,
                          int l, float* xl, float* qin, int m, int d, cudaStream_t s) {
  return with_decoder_width(d, [&](auto w) {
    ln_pos_f32_kernel<decltype(w)::value, LN><<<row_blocks(m), kLnF32Warps * 32, 0, s>>>(
        x, g, bt, pos, l, xl, qin, m);
  });
}

// y = x + drop(LN_post(op)) over m rows of width d
static cudaError_t ln_residual(const float* op, const float* x, const float* g, const float* bt,
                               Dropout drop, float* y, int m, int d, cudaStream_t s) {
  return with_decoder_width(d, [&](auto w) {
    ln_residual_f32_kernel<decltype(w)::value><<<row_blocks(m), kLnF32Warps * 32, 0, s>>>(
        op, x, g, bt, drop, y, m);
  });
}

// c = a W^T + bias over m rows, a [m, d] and W [n, d] as stored (rows of
// in_w or out_w), W split first into its planes at `planes` (2 n d floats)
template <int PRODUCT>
static cudaError_t gemm(const float* a, const float* w, float* planes, const float* bias,
                        float* c, int m, int n, long long ldc, int d, cudaStream_t s) {
  return gw_weight_gemm<false, kGwBias, PRODUCT>(a, d, w, planes, c, ldc, bias, m, n, d,
                                                 Dropout{0u, 0u, 1.0f}, s);
}

}  // namespace crog

// table: x [B, L, D], pos [L, D], in_w [3D, D], in_b [3D], out_w [D, D],
// out_b [D], g_pre, b_pre, g_post, b_post [D], y [B, L, D]; work: xl, qin
// [M, D], qk [M, 2D], v, o, op [M, D] (M = B*L), planes [8 D D] (the TF32
// planes of in_w's first 2D rows, its last D rows and out_w, in order)
extern "C" int crog_self_block_f32_fwd(const void* const* table, int b, int l, int d, int heads,
                                       unsigned seed, unsigned thresh, float scale,
                                       void* stream) {
  using namespace crog;
  const int dh = attn_head_dim(d, heads);
  if (!decoder_width_ok(d) || dh == 0 || l < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(table[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(table[i])); };
  const float *x = in(0), *pos = in(1), *in_w = in(2), *in_b = in(3), *out_w = in(4),
              *out_b = in(5), *g_pre = in(6), *b_pre = in(7), *g_post = in(8), *b_post = in(9);
  float *y = out(10), *xl = out(11), *qin = out(12), *qk = out(13), *v = out(14), *o = out(15),
        *op = out(16), *planes = out(17);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * l;
  const long long dd = (long long)d * d;

  cudaError_t err = ln_pos<true>(x, g_pre, b_pre, pos, l, xl, qin, m, d, s);
  if (err == cudaSuccess)
    err = gemm<kProdProj>(qin, in_w, planes, in_b, qk, m, 2 * d, 2 * d, d, s);
  if (err == cudaSuccess)
    err = gemm<kProdProj>(xl, in_w + 2 * dd, planes + 4 * dd, in_b + 2 * d, v, m, d, d, d, s);
  if (err != cudaSuccess) return (int)err;
  AttnF32Args a;
  a.q = qk;
  a.k = qk + d;
  a.v = v;
  a.mask = nullptr;
  a.o = o;
  a.heads = heads;
  a.lq = l;
  a.lk = l;
  a.q_bs = a.k_bs = (long long)l * 2 * d;
  a.q_rs = a.k_rs = 2 * d;
  a.v_bs = a.o_bs = (long long)l * d;
  a.v_rs = a.o_rs = d;
  a.dh = dh;
  a.scale = attn_scale(dh);
  err = launch_attention_f32(a, b, s);
  if (err == cudaSuccess)
    err = gemm<kProdOut>(o, out_w, planes + 6 * dd, out_b, op, m, d, d, d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)ln_residual(op, x, g_post, b_post, Dropout{seed, thresh, scale}, y, m, d, s);
}

// table: x [B, L, D], txt [B, T, D], pos [L, D], tpos [T, D], mask [B, T]
// (additive f32), in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post,
// y [B, L, D]; work: qin, q [M, D], kin, k, v [B*T, D], o, op [M, D],
// planes [8 D D] (the TF32 planes of W_q, W_k, W_v and out_w, in order)
extern "C" int crog_cross_block_f32_fwd(const void* const* table, int b, int l, int t, int d,
                                        int heads, unsigned seed, unsigned thresh, float scale,
                                        void* stream) {
  using namespace crog;
  const int dh = attn_head_dim(d, heads);
  if (!decoder_width_ok(d) || dh == 0 || l < 1 || t < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(table[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(table[i])); };
  const float *x = in(0), *txt = in(1), *pos = in(2), *tpos = in(3), *mask = in(4),
              *in_w = in(5), *in_b = in(6), *out_w = in(7), *out_b = in(8), *g_pre = in(9),
              *b_pre = in(10), *g_post = in(11), *b_post = in(12);
  float *y = out(13), *qin = out(14), *q = out(15), *kin = out(16), *k = out(17), *v = out(18),
        *o = out(19), *op = out(20), *planes = out(21);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * l, mt = b * t;
  const long long dd = (long long)d * d;

  cudaError_t err = ln_pos<true>(x, g_pre, b_pre, pos, l, nullptr, qin, m, d, s);
  if (err == cudaSuccess)
    err = ln_pos<false>(txt, nullptr, nullptr, tpos, t, nullptr, kin, mt, d, s);
  if (err == cudaSuccess) err = gemm<kProdProj>(qin, in_w, planes, in_b, q, m, d, d, d, s);
  if (err == cudaSuccess)
    err = gemm<kProdProj>(kin, in_w + dd, planes + 2 * dd, in_b + d, k, mt, d, d, d, s);
  if (err == cudaSuccess)
    err = gemm<kProdProj>(txt, in_w + 2 * dd, planes + 4 * dd, in_b + 2 * d, v, mt, d, d, d, s);
  if (err != cudaSuccess) return (int)err;
  AttnF32Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o = o;
  a.heads = heads;
  a.lq = l;
  a.lk = t;
  a.q_bs = a.o_bs = (long long)l * d;
  a.k_bs = a.v_bs = (long long)t * d;
  a.q_rs = a.k_rs = a.v_rs = a.o_rs = d;
  a.dh = dh;
  a.scale = attn_scale(dh);
  err = launch_attention_f32(a, b, s);
  if (err == cudaSuccess)
    err = gemm<kProdOut>(o, out_w, planes + 6 * dd, out_b, op, m, d, d, d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)ln_residual(op, x, g_post, b_post, Dropout{seed, thresh, scale}, y, m, d, s);
}
