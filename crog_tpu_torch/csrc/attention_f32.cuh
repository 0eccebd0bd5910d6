// Softmax attention on fp32 operands, head dims 8-512: the fp32 build of
// the attention forward (K1-f32, and the attention step of K2-f32 /
// K3-f32).
//
// Replaces crog_tpu/ops/pallas_attention.py:104 `_fused_fwd` (pallas_call
// at :111) and the attention `_mha_fwd` inside the decoder block kernels
// (crog_tpu/ops/pallas_decoder.py:99) where the model computes in fp32
// (`compute_dtype: float32`): the Pallas kernels work in f32 and cast to the
// operands' dtype, which is then f32, so nothing is rounded to bf16.
//
// What it computes, per (batch, head):
//   s = (q k^T) * scale + mask[key]     (keys >= Lk weigh exactly 0, so an
//                                        all-masked row averages over the Lk
//                                        real keys, as the twin's does)
//   o = softmax(s) v                    (all in f32)
//   lse = logsumexp(s) over the keys     (K1-f32 only, for K1b-f32)
// q/k/v/o are [B, L, H*dh] f32 with a free row and batch stride (multiples
// of 4 floats), so q and k can be column slices of one packed projection;
// any Lk >= 1 and Lq >= 1 (the key tiles stream, nothing is sized by Lk).
// The twin is ops/attention.py:attention_plain.
//
// Bound on an H100 (ops/work.py, 3xTF32 at a third of TF32's 495 TFLOP/s):
// the CLIP attention pool (B=24, 32 heads, L=169) is 5.6 GFLOP against 133
// MB of q/k/v/o, about 40 us, limited by memory; the decoder's self
// attention (B=24, 8 heads, L=676) 22.5 GFLOP, about 136 us, limited by
// the products.
//
// Design: the forward of the fp32 backward's statistics pre-pass
// (attention_bwd_f32.cuh, whose wgmma and plane helpers it shares).  A CTA
// of one warpgroup owns 64 query rows of one head, 16 a warp; their Q
// fragments are split once into TF32 hi and lo registers.  The head's keys
// stream in tiles of 64 (cp.async into raw [64][64] tiles, K and V apart),
// and each tile is split once into 128-byte-swizzled hi and lo planes in
// the orientation its product reads (TF32 wgmma reads B only K-major):
//   K as [key][d], the B of S = Q K^T (8 steps of wgmma m64n64k8);
//   V as V^T [d][key'], the B of P V, the keys of each 8-step relabelled
//     (position t holds key 2t, t + 4 holds key 2t + 1), so that the C
//     fragments of S, after the online softmax in registers, are the A
//     fragments of P V without leaving the thread; a thread transposes
//     four keys by four columns in registers and stores 16-byte chunks.
// The splits overlap the products: V's split runs while S's wgmmas do, the
// next tile's K while P V's do (both planes single, the raw tiles loaded
// one stage ahead).  Every product is 3xTF32 (tf32.cuh: lo.hi, hi.lo,
// hi.hi), so it keeps f32 accuracy; each row keeps its running max and
// sum, rescales when the max grows, and divides by the sum once at the
// end; it works in log2 units, its exponentials ex2.approx (fw_exp2).  Each tile's P V sums in
// fresh registers (scale-d 0) joined to the running output by an IEEE f32
// multiply-add, so that the tensor cores' truncating accumulation sees at
// most 64 keys.  Every wgmma is issued by the whole warpgroup under no
// branch (ptxas may serialize the products of a wgmma under a branch);
// keys past Lk weigh 0 and load zeros.  No product falls back to mma.sync.
// Shared memory at head tile 64: K's planes 32 KiB, V^T's 32 KiB, the raw K
// and V tiles 32 KiB: 98,304 bytes, two CTAs an SM (242 registers).
//
// Head dims: a template on the head tile DH (32, 64, 128; common.cuh
// attn_head_tile), the head's dh (8 to DH) at run time, its columns past dh
// zero-filled where they are loaded (registers or shared memory) and never
// stored, so dh 8 and 16 run in the DH 32 build.  At DH 128 Q's split
// fragments would take 128 registers beside O's 64: Q stays raw in shared
// memory and its fragments are split per use (in groups of four 8-deep
// steps, as the backward's main kernel splits K), the key tiles are 32
// keys (S m64n32, so the [key][d] planes stay 16 KiB), and P V runs as two
// m64n64 halves of O's columns, each joined to O before the next: 128 KiB,
// one CTA an SM.  A CTA of two
// warpgroups sharing each tile's split (one CTA an SM) measured slower on
// an H100 at the decoder's 676 keys and at the attention pool's 169.  Head
// tiles 256 and 512 run attn_fwd_f32_wide_kernel (below).
#pragma once

#include "attention_bwd_f32.cuh"  // the wgmma .tf32 and plane helpers ab_*, wg_step
#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kF32BQ = 64;  // query rows per CTA, one warpgroup
constexpr int kF32AttnThreads = 128;
static_assert(kF32AttnThreads == kAbF32Threads, "ab_load_raw and ab_split_tile stride by it");

// shared memory (bytes) at head tile DH; each plane pair hi at +0, lo
// kPlane after
template <int DH>
struct FwLayout {
  static constexpr int kBK = ab_f32_key_tile<DH>();  // keys per tile
  static constexpr int kPlane = kBK * DH * 4;         // one [key][d] or [d][key'] plane
  static constexpr int kK = 0;                        // K [key][d] planes
  static constexpr int kVt = 2 * kPlane;              // V^T [d][key'] planes
  static constexpr int kRawK = 4 * kPlane;            // the raw K tile [kBK][DH]
  static constexpr int kRawV = 5 * kPlane;            // the raw V tile
  static constexpr int kQ = 6 * kPlane;               // DH 128: the raw Q tile [64][DH]
  static constexpr int kSmem = kQ + (DH > 64 ? kF32BQ * DH * 4 : 0);
};

struct AttnF32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;  // [B, Lk] additive, or null
  float* o;
  float* lse = nullptr;  // [B*H, Lq]: each row's logsumexp of s, or null (K2/K3-f32)
  int heads, lq, lk;
  int dh;  // head dim; head h's columns are [h * dh, (h + 1) * dh)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
};

// keeps the compiler from moving register accesses across the wgmma
// issue and wait (no instruction)
template <int N>
__device__ __forceinline__ void fw_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x: one instruction, about 2 ulp (expf takes about ten); 2^-inf = 0
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The raw K tile is loaded and split by the backward's ab_load_raw and
// ab_split_tile (ab_raw_off's swizzle; its hi / lo planes [key][d]).
// The raw V tile [kBK][DH]: 16-byte chunk c of key row r at r * DH * 4 + (c
// ^ fw_vswz(r)) * 16, so that the split below reads keys 8j + 2w + e (j of
// one quad of j, e 0 or 1) of one chunk from 8 distinct bank groups
__device__ __forceinline__ int fw_vswz(int r) { return ((r >> 2) & 6) | (r & 1); }

template <int DH, class L = FwLayout<DH>>
__device__ __forceinline__ void fw_load_v(uint32_t dst, const float* src, long long rs, int r0,
                                          int limit, int dh) {
  constexpr int BK = L::kBK, C = DH / 4;
  for (int i = threadIdx.x; i < BK * C; i += kF32AttnThreads) {
    const int r = (unsigned)i / C, c4 = (unsigned)i % C;
    const bool in = r0 + r < limit && c4 * 4 < dh;
    cp_async16(dst + r * (DH * 4) + ((c4 ^ fw_vswz(r)) << 4),
               src + (in ? (long long)(r0 + r) * rs : 0) + (c4 * 4 < dh ? c4 * 4 : 0),
               in ? 16 : 0);
  }
}

// the raw V tile split once into its transposed hi / lo planes [d][key']:
// key 8j + 2w + e at column 8j + 4e + w, so that a thread takes keys 8j +
// e, + 2, + 4, + 6 of four columns d and writes each d's four keys as one
// 16-byte chunk of each plane (the same planes as ab_split_tile's
// transposed ones); a quarter-warp covers the key chunks of one d.  L
// gives the tile's keys kBK, its offsets kRawV and kVt and the plane's
// bytes kPlane; DH the raw tile's columns.
template <int P, int DH, class L = FwLayout<DH>>
__device__ __forceinline__ void fw_split_vt(unsigned char* smem) {
  constexpr int NJE = L::kBK / 4;  // key chunks 8j + 4e of a column
#pragma unroll
  for (int u = threadIdx.x; u < L::kBK * DH / 16; u += kF32AttnThreads) {
    // key chunk 8j + 4e (je = 2j + e), columns 4 c4 ..
    const int je = (unsigned)u % NJE, c4 = (unsigned)u / NJE;
    const int r0 = 8 * (je >> 1) + (je & 1);
    float x[4][4];  // [w][i]: key r0 + 2w, column 4 c4 + i
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int r = r0 + 2 * w;
      const float4 v = *reinterpret_cast<const float4*>(smem + L::kRawV + r * (DH * 4) +
                                                        ((c4 ^ fw_vswz(r)) << 4));
      x[w][0] = v.x;
      x[w][1] = v.y;
      x[w][2] = v.z;
      x[w][3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) split_p<P>(x[w][i], hi[w], lo[w]);
      const uint32_t off = ab_plane_off(DH, 4 * c4 + i, 4 * je);
      st_u4(smem + L::kVt + off, hi);
      st_u4(smem + L::kVt + L::kPlane + off, lo);
    }
  }
}

// PS, PO: how QK^T and P.V form their products (tf32.cuh Products)
template <int PS, int PO, int DH>
__global__ void __launch_bounds__(kF32AttnThreads, DH > 64 ? 1 : 2)
    attn_fwd_f32_kernel(const AttnF32Args a) {
  using L = FwLayout<DH>;
  constexpr int BK = L::kBK;
  constexpr bool QREG = DH <= 64;  // Q's fragments split once into registers
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  unsigned char* smem = fw_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int dh = attn_run_dh<DH>(a.dh);
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kb = a.k + b * a.k_bs + h * dh;
  const float* vb = a.v + b * a.v_bs + h * dh;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const int ntiles = (a.lk + BK - 1) / BK;
  // one cp.async group each, empty past the last tile, so that the waits
  // below count alike on every tile: K(kt + 1) is committed before V(kt + 1)
  auto load_k = [&](int kt) {
    if (kt < ntiles) ab_load_raw<DH>(sbase + L::kRawK, kb, a.k_rs, kt * BK, BK, a.lk, dh);
    cp_async_commit();
  };
  auto load_v = [&](int kt) {
    if (kt < ntiles) fw_load_v<DH>(sbase + L::kRawV, vb, a.v_rs, kt * BK, a.lk, dh);
    cp_async_commit();
  };
  const int q0 = blockIdx.x * kF32BQ;
  if constexpr (!QREG)  // the raw Q tile, in K(0)'s group
    ab_load_kswz<DH>(sbase + L::kQ, a.q + b * a.q_bs + h * dh, a.q_rs, q0, kF32BQ, a.lq, dh);
  load_k(0);
  load_v(0);

  // this thread's rows ra, rb: their Q A fragments, split once
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  constexpr int QS = QREG ? DH / 8 : 1;
  uint32_t qh[QS][4], ql[QS][4];
  if constexpr (QREG) {
    const float* qa = a.q + b * a.q_bs + h * dh + (long long)(ra < a.lq ? ra : 0) * a.q_rs;
    const float* qc = a.q + b * a.q_bs + h * dh + (long long)(rb < a.lq ? rb : 0) * a.q_rs;
#pragma unroll
    for (int s = 0; s < DH / 8; ++s) {
      const int c = 8 * s + t;
      const bool c_in = c < dh, c4_in = c + 4 < dh;
      split_p<PS>(ra < a.lq && c_in ? qa[c] : 0.0f, qh[s][0], ql[s][0]);
      split_p<PS>(rb < a.lq && c_in ? qc[c] : 0.0f, qh[s][1], ql[s][1]);
      split_p<PS>(ra < a.lq && c4_in ? qa[c + 4] : 0.0f, qh[s][2], ql[s][2]);
      split_p<PS>(rb < a.lq && c4_in ? qc[c + 4] : 0.0f, qh[s][3], ql[s][3]);
    }
  }
  cp_async_wait<1>();  // K(0) landed
  __syncthreads();
  ab_split_tile<PS, PS, false, DH>(smem, L::kRawK, L::kK, 0, BK, L::kPlane);
  fence_proxy_async();
  __syncthreads();  // K(0)'s planes are whole; the raw K tile is free
  load_k(1);

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  // the softmax in log2 units: x = (s * scale + mask[key]) log2(e)
  const float sl2 = a.scale * kLog2e;
  float m[2] = {ab_neg_inf(), ab_neg_inf()};  // running max of rows ra, rb (the quad's)
  float l[2] = {0.0f, 0.0f};                  // this thread's share of the running sums
  for (int kt = 0; kt < ntiles; ++kt) {
    // S = Q K^T over the tile, on K(kt)'s planes (scale-d 0: s is written
    // afresh)
    float s[BK / 2];
    fw_fence_regs(s);
    if constexpr (QREG) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk)
        wg_step<PS, BK>(s, qh[kk], ql[kk], ab_desc(sbase + L::kK, BK, kk),
                        ab_desc(sbase + L::kK + L::kPlane, BK, kk), kk > 0);
      wgmma_commit();
    } else {
      uint32_t fh[2][4][4], fl[2][4][4];
      ab_product_raw<PS, BK, true, DH, 0, 2>(s, reinterpret_cast<const float*>(smem + L::kQ),
                                             sbase + L::kK, BK, L::kPlane, fh, fl);
    }
    // while they run: V(kt) into its transposed planes (P V of tile kt - 1
    // is done with them)
    cp_async_wait<1>();  // V(kt) landed (K(kt + 1) may be in flight)
    __syncthreads();
    fw_split_vt<PO, DH>(smem);
    fence_proxy_async();
    wgmma_wait<0>();
    fw_fence_regs(s);

    // scale, key mask, keys past Lk (-inf); then the online softmax
    const int k0 = kt * BK;
    float tmax[2] = {ab_neg_inf(), ab_neg_inf()};
    if (mk == nullptr && k0 + BK <= a.lk) {  // alike in the CTA: no mask, every key real
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] *= sl2;
        tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          float x = ab_neg_inf();
          if (key < a.lk) x = mk != nullptr ? fmaf(s[4 * j + e], sl2, mk[key] * kLog2e)
                                            : s[4 * j + e] * sl2;
          s[4 * j + e] = x;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
        }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);  // finite: key 0 is in the first tile
      corr[r] = fw_exp2(m[r] - mnew);
      m[r] = mnew;
      l[r] *= corr[r];
    }
    // P's A fragments of the 8-key steps, keys relabelled within each step
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fw_exp2(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      split_p<PO>(p[0], ph[j][0], pl[j][0]);  // (row g,     key 2t)
      split_p<PO>(p[2], ph[j][1], pl[j][1]);  // (row g + 8, key 2t)
      split_p<PO>(p[1], ph[j][2], pl[j][2]);  // (row g,     key 2t + 1)
      split_p<PO>(p[3], ph[j][3], pl[j][3]);  // (row g + 8, key 2t + 1)
    }
    __syncthreads();  // V(kt)'s planes are whole; the raw V tile is free
    load_v(kt + 1);

    // this tile's P V (keys past Lk weigh 0, their V rows load zeros),
    // written afresh, in halves of O's columns of at most 64 (N = PN)
    constexpr int PN = DH > 64 ? 64 : DH;
#pragma unroll
    for (int half = 0; half < DH / PN; ++half) {
      float pv[PN / 2];
      fw_fence_regs(pv);
      wgmma_fence();
      const uint32_t vt = sbase + L::kVt + half * PN * 128;  // rows d of this half
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wg_step<PO, PN>(pv, ph[kk], pl[kk], ab_desc(vt, DH, kk),
                        ab_desc(vt + L::kPlane, DH, kk), kk > 0);
      wgmma_commit();
      // while they run: K(kt + 1) into its planes (S of tile kt is done)
      if (half == 0 && kt + 1 < ntiles) {
        cp_async_wait<1>();  // K(kt + 1) landed (V(kt + 1) may be in flight)
        __syncthreads();
        ab_split_tile<PS, PS, false, DH>(smem, L::kRawK, L::kK, 0, BK, L::kPlane);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      fw_fence_regs(pv);
#pragma unroll
      for (int i = 0; i < PN / 2; ++i)
        o[half * PN / 2 + i] = o[half * PN / 2 + i] * corr[(i >> 1) & 1] + pv[i];
    }
    __syncthreads();  // K(kt + 1)'s planes are whole, V^T's free; the raw K tile is free
    load_k(kt + 2);
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  if (a.lse != nullptr && t == 0) {  // m + log(l) in natural units, as `_fwd_kernel` saves it
    float* ls = a.lse + (long long)blockIdx.y * a.lq;
    if (ra < a.lq) ls[ra] = m[0] * kLn2 + logf(l[0]);
    if (rb < a.lq) ls[rb] = m[1] * kLn2 + logf(l[1]);
  }
  float* ob = a.o + b * a.o_bs + h * dh + 2 * t;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (8 * j >= dh) continue;
    if (ra < a.lq)
      *reinterpret_cast<float2*>(ob + (long long)ra * a.o_rs + 8 * j) =
          make_float2(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    if (rb < a.lq)
      *reinterpret_cast<float2*>(ob + (long long)rb * a.o_rs + 8 * j) =
          make_float2(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
}

// ------------------------------------------------- head tiles 256 and 512
// At DH 256 and 512 O alone would take 128 or 256 registers a thread and a
// 32-key tile of K's planes 64 or 128 KiB.  The wide kernel gives each CTA
// kF32WideCols of O's columns (grid z: 2 CTAs a query block at DH 256, 4
// at 512), keeps its 64 rows of Q raw in shared memory (as the DH-128
// build does) and streams each 32-key tile of K in 64-column chunks: a
// chunk lands raw, is split into its [key][d] planes, and its 8 steps of S
// = Q K^T (m64n32k8, Q's fragments split per use) sum in fresh registers
// joined to the tile's scores by IEEE adds, so that no truncating tensor-
// core sum runs deeper than 64.  Then the tile's V columns of the CTA land
// raw, are split into V^T planes (fw_split_vt), and P V runs as two m64n64
// halves joined to O after the online softmax, as at DH 128.  Chunks land
// one ahead of their split.  Every CTA of a query block forms the whole
// head's S: twice at DH 256, four times at 512.  Shared memory 139,264
// bytes at DH 256, 204,800 at 512: one CTA an SM.
constexpr int kF32WideCols = 128;  // O's columns a CTA owns

template <int DH>
struct FwWide {
  static constexpr int kBK = 32;                     // keys per tile
  static constexpr int kQ = 0;                       // the raw Q tile [64][DH]
  static constexpr int kKPlane = kBK * 64 * 4;       // a K chunk's [key][d] plane
  static constexpr int kK = kQ + kF32BQ * DH * 4;    // K chunk planes
  static constexpr int kPlane = kF32WideCols * kBK * 4;  // a V^T [d][key'] plane
  static constexpr int kVt = kK + 2 * kKPlane;       // V^T planes of the CTA's columns
  static constexpr int kRawK = kVt + 2 * kPlane;     // a raw K chunk [kBK][64]
  static constexpr int kRawV = kRawK + kBK * 64 * 4; // the raw V tile [kBK][kF32WideCols]
  static constexpr int kSmem = kRawV + kBK * kF32WideCols * 4;
};

template <int PS, int PO, int DH>
__global__ void __launch_bounds__(kF32AttnThreads, 1)
    attn_fwd_f32_wide_kernel(const AttnF32Args a) {
  using L = FwWide<DH>;
  constexpr int BK = L::kBK, NCH = DH / 64, NO = kF32WideCols;
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  unsigned char* smem = fw_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int c0 = blockIdx.z * NO;  // this CTA's columns of O
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kb = a.k + b * a.k_bs + h * DH;
  const float* vb = a.v + b * a.v_bs + h * DH + c0;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const float* qt = reinterpret_cast<const float*>(smem + L::kQ);
  const int ntiles = (a.lk + BK - 1) / BK;
  const int n = ntiles * (NCH + 1);  // per key tile its NCH K chunks, then V
  // item i into its raw tile, one cp.async group
  auto load = [&](int i) {
    if (i < n) {
      const int kt = i / (NCH + 1), c = i % (NCH + 1);
      if (c < NCH)
        ab_load_raw<64>(sbase + L::kRawK, kb + c * 64, a.k_rs, kt * BK, BK, a.lk, 64);
      else
        fw_load_v<NO, L>(sbase + L::kRawV, vb, a.v_rs, kt * BK, a.lk, NO);
    }
    cp_async_commit();
  };
  const int q0 = blockIdx.x * kF32BQ;
  ab_load_kswz<DH>(sbase + L::kQ, a.q + b * a.q_bs + h * DH, a.q_rs, q0, kF32BQ, a.lq, DH);
  load(0);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  float o[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) o[i] = 0.0f;
  const float sl2 = a.scale * kLog2e;
  float m[2] = {ab_neg_inf(), ab_neg_inf()};  // running max of rows ra, rb (the quad's)
  float l[2] = {0.0f, 0.0f};                  // this thread's share of the running sums
  int i = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    // S = Q K^T over the head, a 64-column chunk at a time
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < NCH; ++c, ++i) {
      cp_async_wait<0>();
      __syncthreads();  // chunk i landed; every warp is done with the K planes
      ab_split_tile<PS, PS, false, 64>(smem, L::kRawK, L::kK, 0, BK, L::kKPlane);
      fence_proxy_async();
      __syncthreads();  // the planes are whole; the raw K chunk is free
      load(i + 1);
      float sc[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] = 0.0f;
      uint32_t fh[2][4][4], fl[2][4][4];
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        // the chunk's columns of Q (ab_kswz leaves bits 6 and up of a column alone)
        ab_frags4<PS, false, DH>(qt + c * 64, 4 * grp, fh[grp], fl[grp]);
        ab_issue4<PS, BK, true>(sc, fh[grp], fl[grp], sbase + L::kK, BK, 4 * grp, L::kKPlane);
      }
      wgmma_wait<0>();
      fw_fence_regs(sc);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] += sc[e];
    }
    // V(kt) into its transposed planes (P V of tile kt - 1 is done with them)
    cp_async_wait<0>();
    __syncthreads();
    fw_split_vt<PO, NO, L>(smem);
    fence_proxy_async();
    __syncthreads();  // V^T's planes are whole; the raw V tile is free
    load(++i);

    // scale, key mask, keys past Lk (-inf); then the online softmax
    const int k0 = kt * BK;
    float tmax[2] = {ab_neg_inf(), ab_neg_inf()};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = ab_neg_inf();
        if (key < a.lk) x = mk != nullptr ? fmaf(s[4 * j + e], sl2, mk[key] * kLog2e)
                                          : s[4 * j + e] * sl2;
        s[4 * j + e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);  // finite: key 0 is in the first tile
      corr[r] = fw_exp2(m[r] - mnew);
      m[r] = mnew;
      l[r] *= corr[r];
    }
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fw_exp2(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      split_p<PO>(p[0], ph[j][0], pl[j][0]);  // (row g,     key 2t)
      split_p<PO>(p[2], ph[j][1], pl[j][1]);  // (row g + 8, key 2t)
      split_p<PO>(p[1], ph[j][2], pl[j][2]);  // (row g,     key 2t + 1)
      split_p<PO>(p[3], ph[j][3], pl[j][3]);  // (row g + 8, key 2t + 1)
    }
    // this tile's P V in halves of 64 of the CTA's columns, each written
    // afresh and joined to O
#pragma unroll
    for (int half = 0; half < NO / 64; ++half) {
      float pv[32];
      fw_fence_regs(pv);
      wgmma_fence();
      const uint32_t vt = sbase + L::kVt + half * 64 * 128;  // rows d of this half
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wg_step<PO, 64>(pv, ph[kk], pl[kk], ab_desc(vt, NO, kk), ab_desc(vt + L::kPlane, NO, kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fw_fence_regs(pv);
#pragma unroll
      for (int e = 0; e < 32; ++e) o[half * 32 + e] = o[half * 32 + e] * corr[(e >> 1) & 1] + pv[e];
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
  if (a.lse != nullptr && t == 0 && blockIdx.z == 0) {
    float* ls = a.lse + (long long)blockIdx.y * a.lq;
    if (ra < a.lq) ls[ra] = m[0] * kLn2 + logf(l[0]);
    if (rb < a.lq) ls[rb] = m[1] * kLn2 + logf(l[1]);
  }
  float* ob = a.o + b * a.o_bs + h * DH + c0 + 2 * t;
#pragma unroll
  for (int j = 0; j < NO / 8; ++j) {
    if (ra < a.lq)
      *reinterpret_cast<float2*>(ob + (long long)ra * a.o_rs + 8 * j) =
          make_float2(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    if (rb < a.lq)
      *reinterpret_cast<float2*>(ob + (long long)rb * a.o_rs + 8 * j) =
          make_float2(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
}

template <int PS, int PO, int DH>
static cudaError_t launch_attn_f32_wide_p(const AttnF32Args& a, int batch, cudaStream_t stream) {
  auto kernel = attn_fwd_f32_wide_kernel<PS, PO, DH>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FwWide<DH>::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kF32BQ - 1) / kF32BQ, batch * a.heads, DH / kF32WideCols);
  kernel<<<grid, kF32AttnThreads, FwWide<DH>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_attention_f32_wide(const AttnF32Args& a, int batch,
                                             cudaStream_t stream) {
  return launch_attn_f32_wide_p<products_of(kProdScores), products_of(kProdPV), DH>(a, batch,
                                                                                    stream);
}

// Internal linkage: two libraries include this header (attention_f32,
// decoder_blocks_f32), and a function-local static of an inline function
// would be one object across them.
template <int PS, int PO, int DH>
static cudaError_t launch_attn_f32_p(const AttnF32Args& a, int batch, cudaStream_t stream) {
  auto kernel = attn_fwd_f32_kernel<PS, PO, DH>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FwLayout<DH>::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.lq + kF32BQ - 1) / kF32BQ, batch * a.heads);
  kernel<<<grid, kF32AttnThreads, FwLayout<DH>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_attention_f32_dh(const AttnF32Args& a, int batch, cudaStream_t stream) {
  return launch_attn_f32_p<products_of(kProdScores), products_of(kProdPV), DH>(a, batch, stream);
}

static cudaError_t launch_attention_f32(const AttnF32Args& a, int batch, cudaStream_t stream) {
  if (a.lk < 1 || a.lq < 1 || batch < 1) return cudaErrorInvalidValue;
  if ((a.q_rs | a.k_rs | a.v_rs | a.o_rs | a.q_bs | a.k_bs | a.v_bs | a.o_bs) & 3)
    return cudaErrorInvalidValue;
  switch (attn_head_tile(a.dh)) {
    case 32: return launch_attention_f32_dh<32>(a, batch, stream);
    case 64: return launch_attention_f32_dh<64>(a, batch, stream);
    case 128: return launch_attention_f32_dh<128>(a, batch, stream);
    case 256: return launch_attention_f32_wide<256>(a, batch, stream);
    case 512: return launch_attention_f32_wide<512>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace crog
