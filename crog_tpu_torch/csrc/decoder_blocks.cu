// K2 and K3: the CROG decoder's pre-LN self- and cross-attention blocks,
// forward, as a short sequence of hand-written kernels behind one C call.
//
// Replaces crog_tpu/ops/pallas_decoder.py:416 `_self_fwd` (pallas_call at
// :422, under `fused_self_block` :404 / `decoder_self_block` :590) and
// :503 `_cross_fwd` (pallas_call at :511, under `fused_cross_block` :492 /
// `decoder_cross_block` :613):
//
//   self : y = x + drop(LN_post(OutProj(MHA(LN_pre(x)+pos, LN_pre(x)+pos, LN_pre(x)))))
//   cross: y = x + drop(LN_post(OutProj(MHA(LN_pre(x)+pos, kv+kpos, kv))))  (+key mask)
//
// with the TPU kernel's cast points: bf16 after every Dense and after each
// LN, LN statistics in f32 with flax's fast variance E[x^2] - E[x]^2, bias
// added to the f32 sum before the bf16 rounding, softmax in f32.
//
// Bound on an H100 at B=24, L=676, D=512: the self block is 56.5 GFLOP over
// 37 MB (about 57 us, limited by the tensor cores); the cross block 18.0
// GFLOP over 36 MB (about 18 us, compute).  At D=1024 (CLIP RN50x64's text
// width, 8 heads of 128): 181.0 GFLOP, 0.183 ms, and about 71 GFLOP, 0.072
// ms.
//
// D is a run-time value, any of decoder_width_ok's 256, 512, 768 and 1024:
// the GEMMs' K and row strides are D, the projection launch has D / 256
// column tiles a product, and the out-projection's cluster D / 256 CTAs.
//
// Design: the block runs as four launches instead of the TPU's one program
// per sample, because a Hopper SM cannot hold a sample's [688, 512]
// activations and all weights the way a TPU core's VMEM does.
//   1. ln_pos: one warp per token row: LN_pre and the positional add.
//   2. proj_gemm: every q/k/v projection of the block in one launch on
//      gemm.cuh's wgmma mainloop, a [128, 256] output tile per CTA, B read
//      K-major straight from torch's in_proj_weight [3D, D] (no transpose),
//      the bias added to the f32 accumulators and each value rounded once
//      to bf16 in registers, 16-byte stores.  The launch's CTAs walk a list
//      of products (ProjArgs, mirrored by ops/decoder_blocks.py:proj_plan):
//      the self block's q and k from qin into the packed [M, 2D] qk and v
//      from xl; the cross block's q from qin over M rows and k, v over the
//      B*T text rows.  One wave tail per block instead of one per product.
//   3. attention (attention.cuh): q, k, v read in place from the projection
//      outputs by stride; the two-pass kernel for the self block's 676
//      keys, the one-pass kernel for the cross block's 17.
//   4. outproj_ln_cluster: the LayerNorm needs whole D-column rows, so a
//      cluster of D / 256 CTAs (1 to 4) owns 128 rows, each CTA a [128, 256] slice of the
//      out-projection on the same mainloop (Wo K-major); bias and the bf16
//      rounding on the accumulators, the row partials of sum and sum of
//      squares exchanged through distributed shared memory and added in
//      rank order (every CTA adds all D / 256, from rank 0 up, so each row's
//      statistics are the same bits in every CTA and every run) while x's
//      [128, 256] tile comes into the ring the mainloop has left
//      free (cp.async), then LN, the dropout (counter-based mask, common.cuh,
//      keyed by the global row and column) and the residual add in
//      registers, 16-byte stores.  In training it also writes the pre-LN
//      projection `op`, which the backward (decoder_blocks_bwd.cu) reads
//      with the other intermediates; TRAIN is a compile-time switch, so
//      eval's epilogue has neither branch.
// Both GEMM kernels hold one CTA of 16 warps per SM (205 KB of ring).  Their
// bound is the tensor cores' (K2's three products: 25.5 GFLOP, 26 us) or
// bytes (the out-projection: o, x, y and op, 50-67 MB, 15-20 us); at K =
// 512 a CTA's ring fill and epilogue are a large share of its time.  The
// activations between the launches (about 5 bf16 [M, D] tensors) do
// round-trip device memory; fusing them away is later work.
#include "attention.cuh"
#include "gemm.cuh"

namespace crog {

constexpr float kLnEps = 1e-5f;
using ProjRing = GemmRing<128, false, kGKDeep, true>;  // [128, 256] tiles, B K-major
constexpr int kPN = ProjRing::kN;                    // output columns per CTA
constexpr int kPNT = ProjRing::kNT;                  // C fragments per warp
static_assert(kPN == 256, "decoder_width_ok's widths are whole 256-column tiles");

// CTAs per out-projection cluster at width D (ops/decoder_blocks.py
// out_cluster): 1 to 4, all portable cluster sizes
__host__ __device__ inline int out_cluster(int D) { return D / kPN; }
constexpr int kXLd = kPN + 8;  // x's tile row stride (conflict-free 4-byte reads)
// the out-projection's row partials, exchange and statistics after the ring
constexpr size_t kOutSmem = ProjRing::kSmem + (size_t)8 * kGM * sizeof(float);

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

// ------------------------------------------------------------- proj_gemm
// One product of a projection launch: C [m, ldc] (from its column 0) =
// bf16(A W_s^T + b_s), A [m, D] row-major, W_s rows w0 .. w0 + 256 nct - 1
// of W [*, D] (bias entries alike).
struct ProjSeg {
  const bf16* a;
  bf16* c;
  int m, ldc, w0, nct;
};

struct ProjArgs {
  ProjSeg seg[3];
  int nseg;
  int d;              // the model width D: A's and W's row length, the products' K
  const bf16* w;      // torch's in_proj_weight [3D, D], K-major as it is
  const float* bias;  // [3D]
};

// CTAs of one product: row tiles of kGM, column tiles of kPN
__host__ __device__ inline int proj_seg_ctas(const ProjSeg& s) {
  return (s.m + kGM - 1) / kGM * s.nct;
}

// CTA blockIdx.x takes the products' tiles in order: product by product,
// row tiles outer, column tiles inner (ops/decoder_blocks.py:proj_plan)
__global__ void __launch_bounds__(kGThreads, 1) proj_gemm_kernel(ProjArgs p) {
  unsigned char* ring = gemm_smem_base();
  ProjSeg s = p.seg[0];
  int t = blockIdx.x;
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    const int n = proj_seg_ctas(s);
    if (i < p.nseg && t >= n) {
      t -= n;
      s = p.seg[i];
    }
  }
  const int m0 = (t / s.nct) * kGM;
  const int n0 = (t % s.nct) * kPN;
  float acc[kPNT][4];
  gemm_zero(acc);
  gemm_mainloop<128, false, kGKDeep, true>(acc, s.a, p.d, m0, s.m, p.w + (long long)s.w0 * p.d,
                                           p.d, n0, 0, p.d, ring, NoChunkHook());
  const int cw = n0 + ((threadIdx.x >> 7) & 1) * 128;  // the warpgroup's first column
  const float* bias = p.bias + s.w0 + cw + frag_col();
  store_frags_bf16<kPNT>([&](int nt, int e) { return acc[nt][e] + bias[nt * 8 + (e & 1)]; },
                         s.c + cw, s.ldc, m0 + frag_row(), s.m);
}

// ---------------------------------------------------- outproj_ln_cluster
// y = bf16(x + drop(bf16(LN(bf16(o Wo^T + bo))))) over D columns; OP (or
// null) receives bf16(o Wo^T + bo).  Cluster blockIdx.x / (D / 256) takes
// rows m0 .. m0 + 127, its CTA of rank r columns 256 r .. 256 r + 255.
template <bool TRAIN>
__global__ void __launch_bounds__(kGThreads, 1) outproj_ln_cluster_kernel(
    const bf16* __restrict__ O, const bf16* __restrict__ Wo, const float* __restrict__ bo,
    const float* __restrict__ g, const float* __restrict__ be, const bf16* __restrict__ X,
    bf16* __restrict__ Y, bf16* __restrict__ OP, int M, int D, Dropout drop) {
  unsigned char* ring = gemm_smem_base();
  const int m0 = (blockIdx.x / out_cluster(D)) * kGM;
  float acc[kPNT][4];
  gemm_zero(acc);
  gemm_mainloop<128, false, kGKDeep, true>(acc, O, D, m0, M, Wo, D,
                                           (int)cluster_rank() * kPN, 0, D, ring,
                                           NoChunkHook());
  // (what follows is computed after the mainloop, so that nothing but the
  // accumulators stays live across it)
  const int tid = threadIdx.x;
  const int n0 = (int)cluster_rank() * kPN;
  const int cw = n0 + ((tid >> 7) & 1) * 128;  // the warpgroup's first column
  const int r0 = frag_row();
  float* red = reinterpret_cast<float*>(ring + ProjRing::kBytes);  // [2][128][2] row partials
  float* xch = red + 4 * kGM;                                      // [2][128], read by the peer
  float* rowst = xch + 2 * kGM;                                    // mu [128], rstd [128]
  // x's [128, 256] tile into the ring, which the mainloop has left free:
  // the loads overlap the epilogue up to the statistics' exchange
  bf16* xs = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int i = 0; i < kGM * kPN / 8 / kGThreads; ++i) {
    const int v = tid + i * kGThreads;
    const int r = v / (kPN / 8), cs = (v % (kPN / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async16(smem_u32(xs + r * kXLd + cs), ok ? X + (long long)(m0 + r) * D + n0 + cs : X,
               ok ? 16 : 0);
  }
  cp_async_commit();
  // op = bf16(o Wo^T + bo) as bf16 pairs (half the registers of the
  // accumulators): pk[nt][hf] holds fragment nt's two columns of row r0 + 8 hf
  uint32_t pk[kPNT][2];
#pragma unroll
  for (int nt = 0; nt < kPNT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bo + cw + nt * 8 + frag_col());
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      pk[nt][hf] = pack_bf16(acc[nt][2 * hf] + b.x, acc[nt][2 * hf + 1] + b.y);
  }
  if (TRAIN && OP)
    store_pairs_bf16<kPNT>([&](int nt, int hf) { return pk[nt][hf]; }, OP + cw, D, m0 + r0, M);
  // the row partials of sum(op), sum(op^2) over this CTA's 256 columns
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kPNT; ++nt) {
      const float2 v = unpack_bf16(pk[nt][hf]);
      s += v.x + v.y;
      ss += v.x * v.x + v.y * v.y;
    }
    s = quad_sum(s);
    ss = quad_sum(ss);
    if ((tid & 3) == 0) {
      const int i = ((tid >> 7) & 1) * kGM + r0 + 8 * hf;
      red[i * 2] = s;
      red[i * 2 + 1] = ss;
    }
  }
  __syncthreads();
  {  // LN statistics of the whole rows, from the cluster's partials
    const float2 tot = cluster_row_sums(red, xch, out_cluster(D));
    if (tid < kGM) {
      const float mu = tot.x / D;
      rowst[tid] = mu;
      rowst[kGM + tid] = rsqrtf(fmaxf(0.0f, tot.y / D - mu * mu) + kLnEps);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the statistics and x's tile are in place
  cluster_arrive();  // this CTA is done reading its peer's exchange
  const bool drop_on = TRAIN && drop.thresh != 0u;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    const float mu = rowst[r], rstd = rowst[kGM + r];
    // the row's part of the counter hash, mix(mix(seed) ^ row), once
    const uint32_t rowbits = mix32(mix32(drop.seed) ^ (uint32_t)(m0 + r));
#pragma unroll
    for (int nt = 0; nt < kPNT; ++nt) {
      const int c = cw + nt * 8 + frag_col();
      const float2 v = unpack_bf16(pk[nt][hf]);
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + r * kXLd + c - n0));
      const float2 gv = *reinterpret_cast<const float2*>(g + c);
      const float2 bv = *reinterpret_cast<const float2*>(be + c);
      float on0 = bf2f(f2bf((v.x - mu) * rstd * gv.x + bv.x));
      float on1 = bf2f(f2bf((v.y - mu) * rstd * gv.y + bv.y));
      if (drop_on) {
        on0 = mix32(rowbits ^ (uint32_t)c) >= drop.thresh ? bf2f(f2bf(on0 * drop.scale)) : 0.0f;
        on1 = mix32(rowbits ^ (uint32_t)(c + 1)) >= drop.thresh ? bf2f(f2bf(on1 * drop.scale))
                                                                : 0.0f;
      }
      pk[nt][hf] = pack_bf16(xv.x + on0, xv.y + on1);  // y = bf16(x + on)
    }
  }
  store_pairs_bf16<kPNT>([&](int nt, int hf) { return pk[nt][hf]; }, Y + cw, D, m0 + r0, M);
  cluster_wait();  // no CTA leaves while a peer may still read its exchange
}

// ------------------------------------------------------------ host side
// one build of the row kernel per width (a lane holds D / 32 values)
static cudaError_t launch_ln_pos(const bf16* x, const float* g, const float* b,
                                 const bf16* pos, bf16* xl, bf16* qin, int M, int L,
                                 int D, int do_ln, cudaStream_t st) {
  return with_decoder_width(D, [&](auto w) {
    ln_pos_kernel<decltype(w)::value><<<(M + 7) / 8, 256, 0, st>>>(x, g, b, pos, xl, qin, M, L,
                                                                   do_ln);
  });
}

// the kernels' dynamic shared memory limits, set once per card
static cudaError_t decoder_fwd_smem_once() {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        proj_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ProjRing::kSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(outproj_ln_cluster_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOutSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(outproj_ln_cluster_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOutSmem);
  }();
  return attr;
}

static int proj_ctas(const ProjArgs& p) {
  int n = 0;
  for (int i = 0; i < p.nseg; ++i) n += proj_seg_ctas(p.seg[i]);
  return n;
}

// `ctas` is the caller's count of the plan's CTAs (ops/decoder_blocks.py:
// proj_plan), which must be this launch's
static cudaError_t launch_proj(const ProjArgs& p, int ctas, cudaStream_t st) {
  if (!decoder_width_ok(p.d)) return cudaErrorInvalidValue;
  for (int i = 0; i < p.nseg; ++i)
    if (p.seg[i].m < 1 || p.seg[i].w0 % kPN || p.seg[i].ldc % 8) return cudaErrorInvalidValue;
  if (ctas != proj_ctas(p)) return cudaErrorInvalidValue;
  const cudaError_t err = decoder_fwd_smem_once();
  if (err != cudaSuccess) return err;
  proj_gemm_kernel<<<ctas, kGThreads, ProjRing::kSmem, st>>>(p);
  return cudaGetLastError();
}

// a launch of `tiles` clusters of out_cluster(D) CTAs
static cudaLaunchConfig_t outproj_config(int tiles, int D, cudaLaunchAttribute* attr,
                                         cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = out_cluster(D);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(out_cluster(D) * tiles);
  cfg.blockDim = dim3(kGThreads);
  cfg.dynamicSmemBytes = kOutSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// `tiles`: the caller's count of 128-row cluster tiles (ops/decoder_blocks.py:
// out_schedule), which must cover M
static cudaError_t launch_outproj(const bf16* O, const bf16* Wo, const float* bo,
                                  const float* g, const float* be, const bf16* X,
                                  bf16* Y, bf16* OP, int M, int D, int tiles, Dropout drop,
                                  cudaStream_t st) {
  if (!decoder_width_ok(D) || M < 1 || tiles != (M + kGM - 1) / kGM) return cudaErrorInvalidValue;
  cudaError_t err = decoder_fwd_smem_once();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = outproj_config(tiles, D, &attr, st);
  const bool train = OP != nullptr || drop.thresh != 0u;
  auto kernel = train ? outproj_ln_cluster_kernel<true> : outproj_ln_cluster_kernel<false>;
  err = cudaLaunchKernelEx(&cfg, kernel, O, Wo, bo, g, be, X, Y, OP, M, D, drop);
  if (err != cudaSuccess) return err;
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
// Workspace: xl, qin, o [B*L, D]; qk [B*L, 2D]; v [B*L, D]; ws_op [B*L, D]
// or null (written for the backward).  proj_ctas and out_tiles: the
// projection launch's CTAs and the out-projection's cluster tiles as
// ops/decoder_blocks.py plans them.  Dropout on the block output with (seed,
// thresh, scale); thresh 0 is eval.
extern "C" int crog_self_block_fwd(
    const void* x, const void* pos, const void* w_in, const float* b_in,
    const void* w_out, const float* b_out, const float* g_pre,
    const float* b_pre, const float* g_post, const float* b_post, void* y,
    void* ws_xl, void* ws_qin, void* ws_qk, void* ws_v, void* ws_o, void* ws_op,
    int B, int L, int D, int heads, int proj_ctas, int out_tiles, unsigned seed,
    unsigned thresh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xl = static_cast<bf16*>(ws_xl);
  bf16* qin = static_cast<bf16*>(ws_qin);
  bf16* qk = static_cast<bf16*>(ws_qk);
  bf16* v = static_cast<bf16*>(ws_v);
  bf16* o = static_cast<bf16*>(ws_o);
  const int dh = crog::attn_head_dim(D, heads);
  if (!crog::decoder_width_ok(D) || dh == 0) return (int)cudaErrorInvalidValue;
  CROG_TRY(crog::launch_ln_pos(xb, g_pre, b_pre, static_cast<const bf16*>(pos),
                               xl, qin, M, L, D, 1, st));
  crog::ProjArgs p = {};
  p.seg[0] = {qin, qk, M, 2 * D, 0, 2 * D / crog::kPN};   // q and k, packed
  p.seg[1] = {xl, v, M, D, 2 * D, D / crog::kPN};          // v
  p.nseg = 2;
  p.d = D;
  p.w = static_cast<const bf16*>(w_in);
  p.bias = b_in;
  CROG_TRY(crog::launch_proj(p, proj_ctas, st));
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
  a.dh = dh;
  a.scale = crog::attn_scale(dh);
  CROG_TRY(crog::launch_attention(a, B, st));
  CROG_TRY(crog::launch_outproj(o, static_cast<const bf16*>(w_out), b_out, g_post,
                                b_post, xb, static_cast<bf16*>(y),
                                static_cast<bf16*>(ws_op), M, D, out_tiles,
                                crog::Dropout{seed, thresh, scale}, st));
  return 0;
}

// Cross block: queries from x [B, L, D], keys/values from kv [B, T, D];
// mask [B, T] additive f32 (0 keep, -1e30 drop).  Workspace: qin, q, o
// [B*L, D]; kin, k, v [B*T, D]; ws_op, proj_ctas and out_tiles as for the
// self block.
extern "C" int crog_cross_block_fwd(
    const void* x, const void* kv, const void* pos, const void* kpos,
    const float* mask, const void* w_in, const float* b_in, const void* w_out,
    const float* b_out, const float* g_pre, const float* b_pre,
    const float* g_post, const float* b_post, void* y, void* ws_qin,
    void* ws_q, void* ws_o, void* ws_kin, void* ws_k, void* ws_v, void* ws_op,
    int B, int L, int T, int D, int heads, int proj_ctas, int out_tiles, unsigned seed,
    unsigned thresh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const int MT = B * T;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* kvb = static_cast<const bf16*>(kv);
  bf16* qin = static_cast<bf16*>(ws_qin);
  bf16* q = static_cast<bf16*>(ws_q);
  bf16* o = static_cast<bf16*>(ws_o);
  bf16* kin = static_cast<bf16*>(ws_kin);
  bf16* k = static_cast<bf16*>(ws_k);
  bf16* v = static_cast<bf16*>(ws_v);
  const int dh = crog::attn_head_dim(D, heads);
  if (!crog::decoder_width_ok(D) || dh == 0) return (int)cudaErrorInvalidValue;
  CROG_TRY(crog::launch_ln_pos(xb, g_pre, b_pre, static_cast<const bf16*>(pos),
                               nullptr, qin, M, L, D, 1, st));
  CROG_TRY(crog::launch_ln_pos(kvb, nullptr, nullptr,
                               static_cast<const bf16*>(kpos), nullptr, kin, MT,
                               T, D, 0, st));
  crog::ProjArgs p = {};
  p.seg[0] = {qin, q, M, D, 0, D / crog::kPN};       // q over the image rows
  p.seg[1] = {kin, k, MT, D, D, D / crog::kPN};      // k and v over the text rows
  p.seg[2] = {kvb, v, MT, D, 2 * D, D / crog::kPN};
  p.nseg = 3;
  p.d = D;
  p.w = static_cast<const bf16*>(w_in);
  p.bias = b_in;
  CROG_TRY(crog::launch_proj(p, proj_ctas, st));
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
  a.dh = dh;
  a.scale = crog::attn_scale(dh);
  CROG_TRY(crog::launch_attention(a, B, st));
  CROG_TRY(crog::launch_outproj(o, static_cast<const bf16*>(w_out), b_out, g_post,
                                b_post, xb, static_cast<bf16*>(y),
                                static_cast<bf16*>(ws_op), M, D, out_tiles,
                                crog::Dropout{seed, thresh, scale}, st));
  return 0;
}

// out[8]: proj_gemm_kernel's registers per thread, shared memory per CTA
// (static + dynamic), spill bytes per thread and CTAs per SM; then the
// out-projection's cluster kernel (train variant): registers, shared
// memory, spills and clusters of width D's launch resident at once
extern "C" int crog_decoder_fwd_attrs(int D, void* out_) {
  int* out = static_cast<int*>(out_);
  if (!crog::decoder_width_ok(D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = crog::decoder_fwd_smem_once();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, crog::proj_gemm_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + crog::ProjRing::kSmem);
  out[2] = (int)fa.localSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], crog::proj_gemm_kernel,
                                                      crog::kGThreads, crog::ProjRing::kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&fa, crog::outproj_ln_cluster_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  out[4] = fa.numRegs;
  out[5] = (int)(fa.sharedSizeBytes + crog::kOutSmem);
  out[6] = (int)fa.localSizeBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = crog::outproj_config(1, D, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(&out[7], crog::outproj_ln_cluster_kernel<true>,
                                             &cfg);
}
