// K2 and K3: the CROG decoder's pre-LN self- and cross-attention blocks,
// forward, as a short sequence of hand-written kernels behind one C call.
//
// Replaces crog_tpu/ops/pallas_decoder.py:416 `_self_fwd` (pallas_call at
// :422, under `fused_self_block` :404 / `decoder_self_block` :590) and
// :503 `_cross_fwd` (pallas_call at :511, under `fused_cross_block` :492 /
// `decoder_cross_block` :613):
//
//   self : y = x + LN_post(OutProj(MHA(LN_pre(x)+pos, LN_pre(x)+pos, LN_pre(x))))
//   cross: y = x + LN_post(OutProj(MHA(LN_pre(x)+pos, kv+kpos, kv)))  (+key mask)
//
// with the TPU kernel's cast points: bf16 after every Dense and after each
// LN, LN statistics in f32 with flax's fast variance E[x^2] - E[x]^2, bias
// added to the f32 sum before the bf16 rounding, softmax in f32.
//
// Bound on an H100 at B=24, L=676, D=512: the self block is 56.5 GFLOP over
// 37 MB (about 57 us, limited by the tensor cores); the cross block 18.0
// GFLOP over 36 MB (about 18 us, compute).
//
// Design: the block runs as four launches instead of the TPU's one program
// per sample, because a Hopper SM cannot hold a sample's [688, 512]
// activations and all weights the way a TPU core's VMEM does.
//   1. ln_pos: one warp per token row: LN_pre and the positional add.
//   2. gemm_bias: 64x64 output tiles, bf16 WMMA with f32 accumulation, bias
//      in the epilogue (the q/k/v projections; q and k come out of one
//      launch as a packed [M, 2D] for the self block).
//   3. attention (attention.cuh): q, k, v read in place from the projection
//      outputs by stride, the score block kept in shared memory.
//   4. outproj_ln_residual: a block owns 32 whole rows, so the post-LN
//      statistics and the residual add fuse into the projection's epilogue
//      and the out-projection never reaches device memory unnormalized.
// The activations between the launches (about 5 bf16 [M, D] tensors) do
// round-trip device memory; fusing them away is later work.
#include "attention.cuh"

namespace crog {

constexpr float kLnEps = 1e-5f;

// ---------------------------------------------------------------- ln_pos
// xl = bf16(LN(x)) (when do_ln), qin = bf16(src + bf16 pos[row % L]) where
// src = xl or x.  One warp per row; a lane holds D/32 values.
template <int D>
__global__ void __launch_bounds__(256) ln_pos_kernel(
    const bf16* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ b, const bf16* __restrict__ pos, bf16* xl,
    bf16* qin, int M, int L, int do_ln) {
  constexpr int kPer = D / 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  float v[kPer];
  const bf16* xr = x + (long long)row * D;
#pragma unroll
  for (int p = 0; p < D / 256; ++p) {
    alignas(16) bf16 t[8];
    copy8(t, xr + p * 256 + lane * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[p * 8 + e] = bf2f(t[e]);
  }
  if (do_ln) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / D;
    const float var = fmaxf(0.f, ss / D - mu * mu);
    const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
    for (int p = 0; p < D / 256; ++p) {
      alignas(16) bf16 t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = p * 256 + lane * 8 + e;
        t[e] = f2bf((v[p * 8 + e] - mu) * rstd * g[c] + b[c]);
        v[p * 8 + e] = bf2f(t[e]);
      }
      if (xl) copy8(xl + (long long)row * D + p * 256 + lane * 8, t);
    }
  }
  const bf16* pr = pos + (long long)(row % L) * D;
#pragma unroll
  for (int p = 0; p < D / 256; ++p) {
    alignas(16) bf16 pt[8];
    alignas(16) bf16 t[8];
    copy8(pt, pr + p * 256 + lane * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = f2bf(v[p * 8 + e] + bf2f(pt[e]));
    copy8(qin + (long long)row * D + p * 256 + lane * 8, t);
  }
}

// ------------------------------------------------------------- gemm_bias
// C[m, n] = bf16(sum_k A[m, k] W[n, k] + bias[n]); W is a torch Linear
// weight [N, K].  N % 64 == 0, K % 32 == 0, lda/ldc % 8 == 0.
constexpr int kGM = 64, kGN = 64, kGK = 32, kGLd = kGK + 8, kGCs = 36;

__global__ void __launch_bounds__(128) gemm_bias_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ W,
    const float* __restrict__ bias, bf16* __restrict__ C, int ldc, int M,
    int N, int K) {
  __shared__ __align__(128) bf16 as[kGM * kGLd];
  __shared__ __align__(128) bf16 ws[kGN * kGLd];
  __shared__ __align__(128) float cs[4][32 * kGCs];
  const int m0 = blockIdx.y * kGM;
  const int n0 = blockIdx.x * kGN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kGK) {
    for (int v = threadIdx.x; v < kGM * (kGK / 8); v += 128) {
      const int r = v / (kGK / 8);
      const int c = (v % (kGK / 8)) * 8;
      if (m0 + r < M) {
        copy8(as + r * kGLd + c, A + (long long)(m0 + r) * lda + k0 + c);
      } else {
        zero8(as + r * kGLd + c);
      }
      copy8(ws + r * kGLd + c, W + (long long)(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      FragA fa[2];
      FragBCol fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * kGLd + kk, kGLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + (wn + j * 16) * kGLd + kk, kGLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* c = cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c + i * 16 * kGCs + j * 16, acc[i][j], kGCs,
                              wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 32 * 32; e += 32) {
    const int r = e / 32;
    const int cc = e % 32;
    const int gm = m0 + wm + r;
    const int gn = n0 + wn + cc;
    if (gm < M) C[(long long)gm * ldc + gn] = f2bf(c[r * kGCs + cc] + bias[gn]);
  }
}

// ---------------------------------------------------- outproj_ln_residual
// y = bf16(x + bf16(LN(bf16(o W^T + bo)))), D = 512: a block owns 32 whole
// rows so the LN statistics are taken in the epilogue.
constexpr int kOD = 512, kOM = 32, kOK = 32, kOLd = kOK + 8, kOCs = kOD + 4;

constexpr size_t outproj_smem_bytes() {
  // the K-loop tiles, then the f32 staging of the 32 x 512 result
  return (size_t)(kOM + kOD) * kOLd * sizeof(bf16) > (size_t)kOM * kOCs * sizeof(float)
             ? (size_t)(kOM + kOD) * kOLd * sizeof(bf16)
             : (size_t)kOM * kOCs * sizeof(float);
}

__global__ void __launch_bounds__(256) outproj_ln_residual_kernel(
    const bf16* __restrict__ O, const bf16* __restrict__ Wo,
    const float* __restrict__ bo, const float* __restrict__ g,
    const float* __restrict__ be, const bf16* __restrict__ X,
    bf16* __restrict__ Y, int M) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = as + kOM * kOLd;
  float* cs = reinterpret_cast<float*>(smem_raw);
  const int m0 = blockIdx.x * kOM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wn = warp * 64;
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < kOD; k0 += kOK) {
    for (int v = threadIdx.x; v < kOM * (kOK / 8); v += 256) {
      const int r = v / (kOK / 8);
      const int c = (v % (kOK / 8)) * 8;
      if (m0 + r < M) {
        copy8(as + r * kOLd + c, O + (long long)(m0 + r) * kOD + k0 + c);
      } else {
        zero8(as + r * kOLd + c);
      }
    }
    for (int v = threadIdx.x; v < kOD * (kOK / 8); v += 256) {
      const int r = v / (kOK / 8);
      const int c = (v % (kOK / 8)) * 8;
      copy8(ws + r * kOLd + c, Wo + (long long)r * kOD + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kOK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (i * 16) * kOLd + kk, kOLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBCol fb;
        wmma::load_matrix_sync(fb, ws + (wn + j * 16) * kOLd + kk, kOLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (i * 16) * kOCs + wn + j * 16, acc[i][j], kOCs,
                              wmma::mem_row_major);
  __syncthreads();

  constexpr int kPer = kOD / 32;
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    const int row = m0 + r;
    if (row >= M) break;
    float v[kPer];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = i * 32 + lane;
      v[i] = bf2f(f2bf(cs[r * kOCs + c] + bo[c]));
      s += v[i];
      ss += v[i] * v[i];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / kOD;
    const float var = fmaxf(0.f, ss / kOD - mu * mu);
    const float rstd = rsqrtf(var + kLnEps);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = i * 32 + lane;
      const float on = bf2f(f2bf((v[i] - mu) * rstd * g[c] + be[c]));
      const long long off = (long long)row * kOD + c;
      Y[off] = f2bf(bf2f(X[off]) + on);
    }
  }
}

// ------------------------------------------------------------ host side
static cudaError_t launch_ln_pos(const bf16* x, const float* g, const float* b,
                                 const bf16* pos, bf16* xl, bf16* qin, int M,
                                 int L, int D, int do_ln, cudaStream_t st) {
  dim3 grid((M + 7) / 8);
  switch (D) {
    case 256:
      ln_pos_kernel<256><<<grid, 256, 0, st>>>(x, g, b, pos, xl, qin, M, L, do_ln);
      break;
    case 512:
      ln_pos_kernel<512><<<grid, 256, 0, st>>>(x, g, b, pos, xl, qin, M, L, do_ln);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

static cudaError_t launch_gemm(const bf16* A, int lda, const bf16* W,
                               const float* bias, bf16* C, int ldc, int M,
                               int N, int K, cudaStream_t st) {
  if (N % kGN || K % kGK || lda % 8 || ldc % 8) return cudaErrorInvalidValue;
  dim3 grid(N / kGN, (M + kGM - 1) / kGM);
  gemm_bias_kernel<<<grid, 128, 0, st>>>(A, lda, W, bias, C, ldc, M, N, K);
  return cudaGetLastError();
}

static cudaError_t launch_outproj(const bf16* O, const bf16* Wo, const float* bo,
                                  const float* g, const float* be, const bf16* X,
                                  bf16* Y, int M, int D, cudaStream_t st) {
  if (D != kOD) return cudaErrorInvalidValue;
  const size_t smem = outproj_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      outproj_ln_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  outproj_ln_residual_kernel<<<(M + kOM - 1) / kOM, 256, smem, st>>>(
      O, Wo, bo, g, be, X, Y, M);
  return cudaGetLastError();
}

}  // namespace crog

#define CROG_TRY(expr)                      \
  do {                                      \
    cudaError_t e_ = (expr);                \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

using crog::bf16;

// Self block over x [B, L, D].  w_in [3D, D] packs q, k, v (torch
// in_proj_weight), b_in [3D]; w_out [D, D]; the four LN vectors [D] f32.
// Workspace: xl, qin, o [B*L, D]; qk [B*L, 2D]; v [B*L, D].
extern "C" int crog_self_block_fwd(
    const void* x, const void* pos, const void* w_in, const float* b_in,
    const void* w_out, const float* b_out, const float* g_pre,
    const float* b_pre, const float* g_post, const float* b_post, void* y,
    void* ws_xl, void* ws_qin, void* ws_qk, void* ws_v, void* ws_o, int B,
    int L, int D, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* xl = static_cast<bf16*>(ws_xl);
  bf16* qin = static_cast<bf16*>(ws_qin);
  bf16* qk = static_cast<bf16*>(ws_qk);
  bf16* v = static_cast<bf16*>(ws_v);
  bf16* o = static_cast<bf16*>(ws_o);
  if (D != heads * crog::kAttnDH) return (int)cudaErrorInvalidValue;
  CROG_TRY(crog::launch_ln_pos(xb, g_pre, b_pre, static_cast<const bf16*>(pos),
                               xl, qin, M, L, D, 1, st));
  CROG_TRY(crog::launch_gemm(qin, D, wi, b_in, qk, 2 * D, M, 2 * D, D, st));
  CROG_TRY(crog::launch_gemm(xl, D, wi + (long long)2 * D * D, b_in + 2 * D, v, D,
                             M, D, D, st));
  crog::AttnArgs a;
  a.q = qk;
  a.k = qk + D;
  a.v = v;
  a.mask = nullptr;
  a.o = o;
  a.heads = heads;
  a.lq = L;
  a.lk = L;
  a.q_bs = a.k_bs = (long long)L * 2 * D;
  a.q_rs = a.k_rs = 2 * D;
  a.v_bs = a.o_bs = (long long)L * D;
  a.v_rs = a.o_rs = D;
  a.scale = 1.0f / 8.0f;  // head dim 64
  CROG_TRY(crog::launch_attention(a, B, st));
  CROG_TRY(crog::launch_outproj(o, static_cast<const bf16*>(w_out), b_out, g_post,
                                b_post, xb, static_cast<bf16*>(y), M, D, st));
  return 0;
}

// Cross block: queries from x [B, L, D], keys/values from kv [B, T, D];
// mask [B, T] additive f32 (0 keep, -1e30 drop).  Workspace: qin, q, o
// [B*L, D]; kin, k, v [B*T, D].
extern "C" int crog_cross_block_fwd(
    const void* x, const void* kv, const void* pos, const void* kpos,
    const float* mask, const void* w_in, const float* b_in, const void* w_out,
    const float* b_out, const float* g_pre, const float* b_pre,
    const float* g_post, const float* b_post, void* y, void* ws_qin,
    void* ws_q, void* ws_o, void* ws_kin, void* ws_k, void* ws_v, int B, int L,
    int T, int D, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const int MT = B * T;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* kvb = static_cast<const bf16*>(kv);
  const bf16* wi = static_cast<const bf16*>(w_in);
  bf16* qin = static_cast<bf16*>(ws_qin);
  bf16* q = static_cast<bf16*>(ws_q);
  bf16* o = static_cast<bf16*>(ws_o);
  bf16* kin = static_cast<bf16*>(ws_kin);
  bf16* k = static_cast<bf16*>(ws_k);
  bf16* v = static_cast<bf16*>(ws_v);
  if (D != heads * crog::kAttnDH) return (int)cudaErrorInvalidValue;
  CROG_TRY(crog::launch_ln_pos(xb, g_pre, b_pre, static_cast<const bf16*>(pos),
                               nullptr, qin, M, L, D, 1, st));
  CROG_TRY(crog::launch_ln_pos(kvb, nullptr, nullptr,
                               static_cast<const bf16*>(kpos), nullptr, kin, MT,
                               T, D, 0, st));
  CROG_TRY(crog::launch_gemm(qin, D, wi, b_in, q, D, M, D, D, st));
  CROG_TRY(crog::launch_gemm(kin, D, wi + (long long)D * D, b_in + D, k, D, MT, D,
                             D, st));
  CROG_TRY(crog::launch_gemm(kvb, D, wi + (long long)2 * D * D, b_in + 2 * D, v, D,
                             MT, D, D, st));
  crog::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o = o;
  a.heads = heads;
  a.lq = L;
  a.lk = T;
  a.q_bs = a.o_bs = (long long)L * D;
  a.k_bs = a.v_bs = (long long)T * D;
  a.q_rs = a.k_rs = a.v_rs = a.o_rs = D;
  a.scale = 1.0f / 8.0f;  // head dim 64
  CROG_TRY(crog::launch_attention(a, B, st));
  CROG_TRY(crog::launch_outproj(o, static_cast<const bf16*>(w_out), b_out, g_post,
                                b_post, xb, static_cast<bf16*>(y), M, D, st));
  return 0;
}
