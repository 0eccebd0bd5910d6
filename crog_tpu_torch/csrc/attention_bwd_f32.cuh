// The attention backward on fp32 operands, head dim 64: K1b-f32, and the
// attention step of K2b-f32 / K3b-f32.
//
// Replaces crog_tpu/ops/pallas_attention.py:133 `_fused_bwd_vjp`
// (pallas_call at :140, kernel `_bwd_kernel` :53) and the attention
// backward `_mha_bwd` inside the decoder blocks' backward kernels
// (crog_tpu/ops/pallas_decoder.py:126) where the model computes in fp32:
// every cast there goes to the operands' dtype, which is then f32, so P and
// dS are not rounded.
//
// What it computes, per (batch, head), with x = (q k^T) * scale + mask[key]:
//   p  = exp(x - m) * r                   recomputed from q and k
//   dv = p^T do
//   dp = do v^T
//   ds = p * (dp - delta) * scale
//   dq = ds k,  dk = ds^T q
// all in f32.  Two modes share the kernels:
//   K1b (lse given, twin ops/attention.py:attention_bwd_plain with the
//     forward's logsumexp): m = lse from the forward (K1-f32 writes it),
//     r = 1, delta = rowsum(do * o), as `_bwd_kernel` takes them;
//   the blocks (lse null, twin mha_bwd_plain, with the blocks' key mask and
//     Lk != Lq): m and r = 1 / l from a pre-pass over the keys, delta =
//     rowsum(dp * p), as `_mha_bwd` takes it (an exact 0 up to rounding
//     where one key takes all the weight).
// q, o, do, dq are [B, Lq, H*64], k, v, dk, dv [B, Lk, H*64], f32 with a
// free row and batch stride (multiples of 4 floats); any Lq, Lk >= 1.
//
// Products per (64-query, 64-key) pair: 5 in K1b (QK^T, dO V^T, P^T dO,
// dS^T Q, dS K, each once), 7 in the blocks (the pre-pass forms QK^T and
// dO V^T once more for its statistics); two mma.sync kernels formed 8 and 10.
//
// Bound on an H100 (ops/work.py, 3xTF32 at a third of TF32's 495
// TFLOP/s): the CLIP attention pool (B=24, 32 heads, L=169) is 14.0 GFLOP
// against 266 MB, about 85 us by operations (79 us by bytes); the
// decoder's self attention (B=24, 8 heads, L=676) 56 GFLOP, about 0.34 ms.
// The dQ partials add 3 (K1b) and 11 (K2b) times dq's bytes, written once
// and read once: 0.06 and 0.22 ms at 3.35 TB/s.  At 640^2 (L = 1600) the
// decoder's step is 315 GFLOP, about 1.9 ms; its 9 partials (below) add
// 708 MB written once, read once and (by the CTAs that walk three key
// blocks) read and written again for the second and third block.
//
// Design: FlashAttention-2's backward on wgmma, no atomics.
//   attn_bwd_f32_delta_kernel (K1b): each row's (lse, 1, rowsum(do * o)).
//   attn_bwd_f32_stats_kernel (the blocks): a CTA of one warpgroup takes
//     64 query rows, its Q and dO fragments split once into registers, and
//     streams 64-key tiles of K and V: S = Q K^T and dP = dO V^T
//     (wgmma m64n64k8) build the row max, the sum and sum(exp(s - m) dp)
//     together with online rescaling; it writes each row's (m, 1 / l,
//     delta).
//   attn_bwd_f32_main_kernel: a CTA of one warpgroup owns 64 keys (16 a
//     warp) and streams the head's queries in tiles of 32 with their
//     statistics.  Per tile: S^T = K Q^T and dP^T = V dO^T (m64n32k8, in
//     groups of 4 steps, each group's A fragments split while the group
//     before runs), P and dS in registers, dV += P^T dO and dK += dS^T Q
//     (m64n64k8, P and dS as register A fragments), dS to shared memory,
//     dQ^T = K^T dS (m64n32k8, two groups) into its partial [Lq, 64].  A
//     CTA walks ab_f32_group(Lk) consecutive key blocks, one after the
//     other, each from its own K and V tile with fresh dK and dV: the
//     first block writes the partial, each later one adds its dQ^T to it
//     (the same thread reads back what it wrote), so the launch writes at
//     most kAbF32MaxParts partials whatever Lk, and the workspace grows
//     linearly in Lq (11 partials at 676 keys, as one per block; 9 at
//     1600, where one per block would be 25 and grow as L^2).
//   attn_bwd_f32_dq_sum_kernel: dq = the partials added in key-block
//     order.  Every sum is in a fixed order, so two runs give equal bits.
// Every product is wgmma .tf32 with the 3xTF32 split (tf32.cuh): three
// wgmmas, lo.hi, hi.lo, hi.hi (the main kernel's scores and dP in the
// mirrored order hi.lo, lo.hi, so that each element sums the same terms in
// the same order as the pre-pass).  TF32 wgmma takes K-major operands
// only, so each streamed tile lands raw (cp.async, one stage ahead) and is
// split once into TF32 hi and lo planes, 128-byte swizzled, in the
// orientation its product reads: Q and dO as [query][d] (B of the scores
// and dP), and transposed as [d][query] (B of dK and dV), the queries of
// each 8-step relabelled (position t holds query 2t, t + 4 holds 2t + 1) so
// that the C fragments of P^T and dS^T are A fragments without leaving the
// thread; dS as [query][key] (B of dQ^T), over Q's planes once the scores
// are formed.  No warp splits a B operand in the product loop.  A operands
// come from registers: K, V and K^T are read raw from shared memory (an
// XOR swizzle that is free of bank conflicts both ways) and split per use
// by the warp that owns those rows; P and dS are split per use by the
// thread that holds them.  No product falls back to mma.sync.
// Fresh accumulators: each product's tile is at most 64 deep and sums in
// registers that start at zero (scale-d 0); dK and dV join the tile's sums
// by IEEE f32 adds, dq the key blocks' partials (one accumulator over
// K = 2048 read 1.45e-5 against the twin in the fp32 GEMMs).
// Shared memory per CTA: main 115,456 bytes (Q, dO planes and their
// transposes, hi and lo: 64 KiB; the raw Q and dO tile: 16 KiB; K and V
// raw: 32 KiB; two stages of the tile's statistics), so that two CTAs share
// an SM (2 x (115,456 + 1,024 reserved) <= 233,472); the pre-pass 98,304,
// two CTAs an SM too.
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kAbF32DH = 64;     // head dim
constexpr int kAbF32Keys = 64;   // keys per CTA of the main kernel
constexpr int kAbF32Q = 32;      // queries per streamed tile of the main kernel
constexpr int kAbF32PreQ = 64;   // query rows per CTA of the pre-pass
constexpr int kAbF32PreK = 64;   // keys per streamed tile of the pre-pass
constexpr int kAbF32Threads = 128;
constexpr int kAbF32MaxParts = 11;  // dQ partials at most (K2b-f32's count at 676 keys)

// key blocks of 64 that one main-kernel CTA walks, and the dQ partials the
// launch writes (the CTAs of a head); the wrapper sizes the workspace by
// the same count (ops/attention.py:f32_dq_parts)
__host__ __device__ inline int ab_f32_group(int lk) {
  const int blocks = (lk + kAbF32Keys - 1) / kAbF32Keys;
  return (blocks + kAbF32MaxParts - 1) / kAbF32MaxParts;
}
__host__ __device__ inline int ab_f32_parts(int lk) {
  const int blocks = (lk + kAbF32Keys - 1) / kAbF32Keys, g = ab_f32_group(lk);
  return (blocks + g - 1) / g;
}

// main kernel shared memory (bytes): planes hi at +0, lo at +kAbPlane
constexpr int kAbPlane = 8192;            // one [32][64] or [64][32] f32 plane
constexpr int kAbMainQn = 0;              // Q [query][d]; then dS [query][key]
constexpr int kAbMainDOn = 2 * kAbPlane;  // dO [query][d]
constexpr int kAbMainQt = 4 * kAbPlane;   // Q^T [d][query']
constexpr int kAbMainDOt = 6 * kAbPlane;  // dO^T [d][query']
constexpr int kAbMainRaw = 8 * kAbPlane;  // the next tile's raw Q, then dO [32][64]
constexpr int kAbMainK = kAbMainRaw + 2 * kAbPlane;  // raw K [64][64]
constexpr int kAbMainV = kAbMainK + 4 * kAbF32DH * kAbF32Keys;
constexpr int kAbMainStat = kAbMainV + 4 * kAbF32DH * kAbF32Keys;  // 2 x [3][32]
constexpr int kAbMainSmem = kAbMainStat + 2 * 3 * kAbF32Q * 4;
// pre-pass shared memory (bytes): planes hi at +0, lo at +kAbPrePlane
constexpr int kAbPrePlane = 16384;          // one [64][64] f32 plane
constexpr int kAbPreK = 0;                  // K [key][d] planes
constexpr int kAbPreV = 2 * kAbPrePlane;    // V [key][d] planes
constexpr int kAbPreRaw = 4 * kAbPrePlane;  // the next tile's raw K, then V [64][64]
constexpr int kAbPreSmem = 6 * kAbPrePlane;

struct AttnBwdF32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* mask;  // [B, Lk] additive, or null
  const float* lse;   // [B*H, Lq]: the forward's row logsumexp (K1b), or null (the blocks)
  float* dq;
  float* dk;
  float* dv;
  float* stats;   // [B*H, 3, Lq]: m, r, delta
  float* dqpart;  // [ab_f32_parts(Lk), B*H, Lq, 64]: each CTA's dq over its key blocks
  int heads, lq, lk;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs, dq_bs, dq_rs, dk_bs,
      dk_rs, dv_bs, dv_rs;
  float scale;
};

__device__ __forceinline__ float ab_neg_inf() { return __int_as_float(0xff800000); }

// generic-proxy stores to shared memory made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A B over the warpgroup: wgmma m64n32k8 / m64n64k8 .tf32, f32
// sums.  A: this warp's 16 of the 64 rows x 8 k in registers as an
// mma.m16n8k8 tf32 A fragment (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)); B [N][8 k] K-major in shared memory through desc_b.
// d holds this warp's 16 rows as C fragments of 8 columns; scale_d 0
// writes d afresh.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  if constexpr (N == 32)
    wgmma_tf32_n32(d, a, desc_b, scale_d);
  else
    wgmma_tf32_n64(d, a, desc_b, scale_d);
}

// one 8-deep step of d (+)= A B with split operands (split_p<P>): for
// k3xTF32 the cross terms, lo.hi then hi.lo (or hi.lo then lo.hi, !LO),
// then hi.hi; one pass otherwise.  scale_d 0 starts d afresh.
template <int P, int N, bool LO = true>
__device__ __forceinline__ void wg_step(float (&d)[N / 2], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                        int scale_d) {
  if constexpr (P == k3xTF32) {
    if constexpr (LO) {
      wgmma_tf32<N>(d, al, bh, scale_d);
      wgmma_tf32<N>(d, ah, bl, 1);
    } else {
      wgmma_tf32<N>(d, ah, bl, scale_d);
      wgmma_tf32<N>(d, al, bh, 1);
    }
    wgmma_tf32<N>(d, ah, bh, 1);
  } else {
    wgmma_tf32<N>(d, ah, bh, scale_d);
  }
}

// byte offset of element (r, c) in a K-major plane of `rows` rows: 32
// floats (128 bytes) per row of each 32-column atom, atoms rows * 128 bytes
// apart, the 16-byte chunks of row r XOR-ed with r & 7 (wgmma's 128-byte
// swizzle; every atom starts 1024-byte aligned)
__device__ __forceinline__ uint32_t ab_plane_off(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// descriptor of 8-deep step kk of a K-major plane of `rows` rows at `addr`
__device__ __forceinline__ uint64_t ab_desc(uint32_t addr, int rows, int kk) {
  return wgmma_desc_sw128(addr + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 8 * 128);
}

// a raw [rows][64] tile: 16-byte chunk c of row r at r * 256 + (c ^ (r & 7)) * 16
__device__ __forceinline__ uint32_t ab_raw_off(int r, int c4) {
  return r * 256 + ((c4 ^ (r & 7)) << 4);
}

// the raw K / V tile of the main kernel, read by A fragments both ways
// (rows = keys, and transposed): float (r, c) at r * 64 + (c ^ ab_kswz(r)),
// free of bank conflicts for both (bits 3-4 follow r & 3, bit 2 r & 4)
__device__ __forceinline__ int ab_kswz(int r) { return ((r & 3) << 3) | (((r >> 2) & 1) << 2); }

__device__ __forceinline__ float ab_kval(const float* t, int r, int c) {
  return t[r * 64 + (c ^ ab_kswz(r))];
}

// rows [r0, r0 + rows) of a [*, 64] head slice (row stride rs) as a raw
// tile, rows past `limit` zero-filled
__device__ __forceinline__ void ab_load_raw(uint32_t dst, const float* src, long long rs, int r0,
                                            int rows, int limit) {
  for (int i = threadIdx.x; i < rows * 16; i += kAbF32Threads) {
    const int r = i >> 4, c4 = i & 15;
    const bool in = r0 + r < limit;
    cp_async16(dst + ab_raw_off(r, c4), src + (in ? (long long)(r0 + r) * rs : 0) + c4 * 4,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ void st_u4(unsigned char* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// a raw [rows][64] tile split once into its hi / lo planes [row][d] (PN)
// and, with T, its transposed planes [d][row'] (PT): rows' 8-steps
// relabelled, row 8j + 2t + e at column 8j + 4e + t
template <int PN, int PT, bool T>
__device__ __forceinline__ void ab_split_tile(unsigned char* smem, int raw, int nplane, int tplane,
                                              int rows, int plane) {
  for (int i = threadIdx.x; i < rows * 16; i += kAbF32Threads) {
    const int r = i % rows, c4 = i / rows;  // a warp: 32 rows of one chunk
    const float4 x = *reinterpret_cast<const float4*>(smem + raw + ab_raw_off(r, c4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_p<PN>(xs[e], hi[e], lo[e]);
    const uint32_t on = ab_plane_off(rows, r, 4 * c4);
    st_u4(smem + nplane + on, hi);
    st_u4(smem + nplane + plane + on, lo);
    if constexpr (T) {
      const int rp = (r & ~7) | ((r & 1) << 2) | ((r & 6) >> 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_p<PT>(xs[e], hi[e], lo[e]);
        const uint32_t ot = ab_plane_off(kAbF32DH, 4 * c4 + e, rp);
        *reinterpret_cast<uint32_t*>(smem + tplane + ot) = hi[e];
        *reinterpret_cast<uint32_t*>(smem + tplane + kAbPlane + ot) = lo[e];
      }
    }
  }
}

// K1b: each row's statistics (the forward's lse, 1, rowsum(do * o)), 16
// threads a row summing in a fixed order
__global__ void __launch_bounds__(256) attn_bwd_f32_delta_kernel(const AttnBwdF32Args a,
                                                                  int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = i >> 4, c = (i & 15) * 4;
  float s = 0.0f;
  const int bh = row / a.lq, qi = row % a.lq, b = bh / a.heads, h = bh % a.heads;
  if (row < rows) {
    const float4 ov = *reinterpret_cast<const float4*>(a.o + b * a.o_bs + qi * a.o_rs +
                                                       h * kAbF32DH + c);
    const float4 dv = *reinterpret_cast<const float4*>(a.dout + b * a.do_bs + qi * a.do_rs +
                                                       h * kAbF32DH + c);
    s = ov.x * dv.x + ov.y * dv.y + ov.z * dv.z + ov.w * dv.w;
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((i & 15) == 0 && row < rows) {
    float* st = a.stats + (long long)bh * 3 * a.lq;
    st[qi] = a.lse[(long long)bh * a.lq + qi];
    st[a.lq + qi] = 1.0f;
    st[2 * a.lq + qi] = s;
  }
}

// The blocks' pre-pass: each row's (m, 1 / l, delta) over every key, with
// delta = sum(p dp).  PS, PDP: how QK^T and dO V^T form their products.
template <int PS, int PDP>
__global__ void __launch_bounds__(kAbF32Threads, 2) attn_bwd_f32_stats_kernel(
    const AttnBwdF32Args a) {
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* smem = ab_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kb = a.k + b * a.k_bs + h * kAbF32DH;
  const float* vb = a.v + b * a.v_bs + h * kAbF32DH;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const int ntiles = (a.lk + kAbF32PreK - 1) / kAbF32PreK;
  auto load = [&](int kt) {
    ab_load_raw(sbase + kAbPreRaw, kb, a.k_rs, kt * kAbF32PreK, kAbF32PreK, a.lk);
    ab_load_raw(sbase + kAbPreRaw + kAbPrePlane, vb, a.v_rs, kt * kAbF32PreK, kAbF32PreK,
                a.lk);
    cp_async_commit();
  };
  load(0);

  // this thread's rows ra, rb: their Q and dO A fragments, split once
  const int ra = blockIdx.x * kAbF32PreQ + warp * 16 + g, rb = ra + 8;
  uint32_t qh[8][4], ql[8][4], oh[8][4], ol[8][4];
  {
    const float* qa = a.q + b * a.q_bs + h * kAbF32DH + (long long)(ra < a.lq ? ra : 0) * a.q_rs;
    const float* qc = a.q + b * a.q_bs + h * kAbF32DH + (long long)(rb < a.lq ? rb : 0) * a.q_rs;
    const float* da =
        a.dout + b * a.do_bs + h * kAbF32DH + (long long)(ra < a.lq ? ra : 0) * a.do_rs;
    const float* dc =
        a.dout + b * a.do_bs + h * kAbF32DH + (long long)(rb < a.lq ? rb : 0) * a.do_rs;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int c = 8 * s + t;
      split_p<PS>(ra < a.lq ? qa[c] : 0.0f, qh[s][0], ql[s][0]);
      split_p<PS>(rb < a.lq ? qc[c] : 0.0f, qh[s][1], ql[s][1]);
      split_p<PS>(ra < a.lq ? qa[c + 4] : 0.0f, qh[s][2], ql[s][2]);
      split_p<PS>(rb < a.lq ? qc[c + 4] : 0.0f, qh[s][3], ql[s][3]);
      split_p<PDP>(ra < a.lq ? da[c] : 0.0f, oh[s][0], ol[s][0]);
      split_p<PDP>(rb < a.lq ? dc[c] : 0.0f, oh[s][1], ol[s][1]);
      split_p<PDP>(ra < a.lq ? da[c + 4] : 0.0f, oh[s][2], ol[s][2]);
      split_p<PDP>(rb < a.lq ? dc[c + 4] : 0.0f, oh[s][3], ol[s][3]);
    }
  }

  // running max (shared by the quad), this thread's share of the sum and
  // of sum(exp(x - m) dp), rows ra (0) and rb (1)
  float m[2] = {ab_neg_inf(), ab_neg_inf()}, l[2] = {0.0f, 0.0f}, w[2] = {0.0f, 0.0f};
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with the planes
    ab_split_tile<PS, PS, false>(smem, kAbPreRaw, kAbPreK, 0, kAbF32PreK, kAbPrePlane);
    ab_split_tile<PDP, PDP, false>(smem, kAbPreRaw + kAbPrePlane, kAbPreV, 0, kAbF32PreK,
                                   kAbPrePlane);
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < ntiles) load(kt + 1);
    float s[kAbF32PreK / 2], dp[kAbF32PreK / 2];
#pragma unroll
    for (int i = 0; i < kAbF32PreK / 2; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wg_step<PS, kAbF32PreK>(s, qh[kk], ql[kk], ab_desc(sbase + kAbPreK, kAbF32PreK, kk),
                              ab_desc(sbase + kAbPreK + kAbPrePlane, kAbF32PreK, kk), kk > 0);
      wg_step<PDP, kAbF32PreK>(dp, oh[kk], ol[kk], ab_desc(sbase + kAbPreV, kAbF32PreK, kk),
                               ab_desc(sbase + kAbPreV + kAbPrePlane, kAbF32PreK, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    const int k0 = kt * kAbF32PreK;
    float tmax[2] = {ab_neg_inf(), ab_neg_inf()};
#pragma unroll
    for (int j = 0; j < kAbF32PreK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float x = ab_neg_inf();  // keys past Lk weigh exactly 0
        if (key < a.lk) x = mk != nullptr ? s[4 * j + e] * a.scale + mk[key]
                                          : s[4 * j + e] * a.scale;
        s[4 * j + e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);  // finite: key 0 is in the first tile
      const float c = expf(m[r] - mnew);
      l[r] *= c;
      w[r] *= c;
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < kAbF32PreK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p;
        w[e >> 1] += p * dp[4 * j + e];
      }
  }
  float* st = a.stats + (long long)bh * 3 * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    w[r] += __shfl_xor_sync(0xffffffffu, w[r], 1);
    w[r] += __shfl_xor_sync(0xffffffffu, w[r], 2);
    const int row = r ? rb : ra;
    if (t == 0 && row < a.lq) {
      st[row] = m[r];
      st[a.lq + row] = 1.0f / l[r];
      st[2 * a.lq + row] = w[r] / l[r];
    }
  }
}

// this warp's A fragment of 8-deep step kk from the raw K / V tile: rows
// (keys) 16 warp + g (+ 8), columns (d) 8 kk + t (+ 4); with T, of its
// transpose: rows (d) 16 warp + g (+ 8), columns (keys) 8 kk + t (+ 4)
template <int P, bool T>
__device__ __forceinline__ void ab_frag(const float* tile, int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int c0 = 8 * kk + (lane & 3);
  float x[4];
  if constexpr (T) {
    x[0] = ab_kval(tile, c0, r0);
    x[1] = ab_kval(tile, c0, r0 + 8);
    x[2] = ab_kval(tile, c0 + 4, r0);
    x[3] = ab_kval(tile, c0 + 4, r0 + 8);
  } else {
    x[0] = ab_kval(tile, r0, c0);
    x[1] = ab_kval(tile, r0 + 8, c0);
    x[2] = ab_kval(tile, r0, c0 + 4);
    x[3] = ab_kval(tile, r0 + 8, c0 + 4);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_p<P>(x[e], hi[e], lo[e]);
}

// this warp's A fragments of 8-deep steps kk0 .. kk0 + 3 (ab_frag)
template <int P, bool T>
__device__ __forceinline__ void ab_frags4(const float* tile, int kk0, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ab_frag<P, T>(tile, kk0 + i, hi[i], lo[i]);
}

// issues steps kk0 .. kk0 + 3 of d (+)= A B as one wgmma group, A's
// fragments (hi, lo) in registers, B the plane pair (hi at bplane, lo
// kAbPlane after) of `brows` rows; step 0 starts d afresh
template <int P, int N, bool LO>
__device__ __forceinline__ void ab_issue4(float (&d)[N / 2], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t bplane,
                                          int brows, int kk0) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wg_step<P, N, LO>(d, hi[i], lo[i], ab_desc(bplane, brows, kk0 + i),
                      ab_desc(bplane + kAbPlane, brows, kk0 + i), kk0 + i > 0);
  wgmma_commit();
}

// d = X^T B over the tile's 32 queries (4 steps), X^T held as C fragments
// (x[4 j + e]: key rows g + 8 (e >> 1), queries 8 j + 2 t + (e & 1)),
// which are A fragments of the relabelled queries; B a [64][32] plane pair
template <int P>
__device__ __forceinline__ void ab_c_product(float (&d)[32], const float (&x)[16],
                                             uint32_t bplane) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_p<P>(x[4 * kk + 0], hi[kk][0], lo[kk][0]);  // (row g,     query 2t)
    split_p<P>(x[4 * kk + 2], hi[kk][1], lo[kk][1]);  // (row g + 8, query 2t)
    split_p<P>(x[4 * kk + 1], hi[kk][2], lo[kk][2]);  // (row g,     query 2t + 1)
    split_p<P>(x[4 * kk + 3], hi[kk][3], lo[kk][3]);  // (row g + 8, query 2t + 1)
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg_step<P, 64>(d, hi[kk], lo[kk], ab_desc(bplane, kAbF32DH, kk),
                   ab_desc(bplane + kAbPlane, kAbF32DH, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
}

// The main pass over ab_f32_group(Lk) consecutive 64-key blocks.  PS, PDP,
// PDV, PDK, PDQ: how QK^T, dO V^T, P^T dO, dS^T Q and dS K form their
// products.
template <int PS, int PDP, int PDV, int PDK, int PDQ>
__global__ void __launch_bounds__(kAbF32Threads, 2) attn_bwd_f32_main_kernel(
    const AttnBwdF32Args a) {
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* smem = ab_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kt = reinterpret_cast<const float*>(smem + kAbMainK);
  const float* vt = reinterpret_cast<const float*>(smem + kAbMainV);
  const float* kb = a.k + b * a.k_bs + h * kAbF32DH;
  const float* vb = a.v + b * a.v_bs + h * kAbF32DH;
  const float* qb = a.q + b * a.q_bs + h * kAbF32DH;
  const float* db = a.dout + b * a.do_bs + h * kAbF32DH;
  const float* st = a.stats + (long long)bh * 3 * a.lq;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  auto load_q = [&](int qt) {
    const int q0 = qt * kAbF32Q;
    ab_load_raw(sbase + kAbMainRaw, qb, a.q_rs, q0, kAbF32Q, a.lq);
    ab_load_raw(sbase + kAbMainRaw + kAbPlane, db, a.do_rs, q0, kAbF32Q, a.lq);
    if (threadIdx.x < 3 * kAbF32Q) {  // m, r, delta of the tile's rows
      const int which = threadIdx.x / kAbF32Q, r = q0 + threadIdx.x % kAbF32Q;
      const bool in = r < a.lq;
      cp_async4(sbase + kAbMainStat + ((qt & 1) * 3 * kAbF32Q + threadIdx.x) * 4,
                st + (long long)which * a.lq + (in ? r : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  float* part = a.dqpart + ((long long)blockIdx.x * gridDim.y + bh) * a.lq * kAbF32DH;
  const int nqt = (a.lq + kAbF32Q - 1) / kAbF32Q;
  const int group = ab_f32_group(a.lk);
  const int kb0 = blockIdx.x * group;
  const int kb1 = min(kb0 + group, (a.lk + kAbF32Keys - 1) / kAbF32Keys);

  for (int kblk = kb0; kblk < kb1; ++kblk) {
    const int k0 = kblk * kAbF32Keys;
    if (kblk > kb0) __syncthreads();  // every warp is done with the last block's tiles
    for (int i = threadIdx.x; i < kAbF32Keys * 16; i += kAbF32Threads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool in = k0 + r < a.lk;
      const long long row = in ? k0 + r : 0;  // rows past Lk are zero-filled
      const uint32_t off = (r * 64 + (c ^ ab_kswz(r))) * 4;
      cp_async16(sbase + kAbMainK + off, kb + row * a.k_rs + c, in ? 16 : 0);
      cp_async16(sbase + kAbMainV + off, vb + row * a.v_rs + c, in ? 16 : 0);
    }
    load_q(0);

    // this thread's keys ka (C fragment rows g) and kc (g + 8)
    const int ka = k0 + warp * 16 + g, kc = ka + 8;
    const float mka = (mk != nullptr && ka < a.lk) ? mk[ka] : 0.0f;
    const float mkc = (mk != nullptr && kc < a.lk) ? mk[kc] : 0.0f;
    const bool first = kblk == kb0;  // writes the partial; later blocks add to it

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
    for (int qt = 0; qt < nqt; ++qt) {
      cp_async_wait_all();
      __syncthreads();  // tile qt landed; every warp is done with the planes
      ab_split_tile<PS, PDK, true>(smem, kAbMainRaw, kAbMainQn, kAbMainQt, kAbF32Q, kAbPlane);
      ab_split_tile<PDP, PDV, true>(smem, kAbMainRaw + kAbPlane, kAbMainDOn, kAbMainDOt, kAbF32Q,
                                    kAbPlane);
      fence_proxy_async();
      __syncthreads();
      if (qt + 1 < nqt) load_q(qt + 1);  // the raw tile is free: one tile ahead
      const float* sts =
          reinterpret_cast<const float*>(smem + kAbMainStat) + (qt & 1) * 3 * kAbF32Q;

      // S^T = K Q^T and dP^T = V dO^T (keys g (+ 8) x queries 8 j + 2 t (+ 1)),
      // 4 steps a group: each group's A fragments are split while the group
      // before runs, in the registers of the group two before
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.0f;
      uint32_t fh0[4][4], fl0[4][4], fh1[4][4], fl1[4][4];
      ab_frags4<PS, false>(kt, 0, fh0, fl0);
      ab_issue4<PS, 32, false>(s, fh0, fl0, sbase + kAbMainQn, kAbF32Q, 0);
      ab_frags4<PS, false>(kt, 4, fh1, fl1);
      ab_issue4<PS, 32, false>(s, fh1, fl1, sbase + kAbMainQn, kAbF32Q, 4);
      wgmma_wait<1>();
      ab_frags4<PDP, false>(vt, 0, fh0, fl0);
      ab_issue4<PDP, 32, false>(dp, fh0, fl0, sbase + kAbMainDOn, kAbF32Q, 0);
      wgmma_wait<1>();
      ab_frags4<PDP, false>(vt, 4, fh1, fl1);
      ab_issue4<PDP, 32, false>(dp, fh1, fl1, sbase + kAbMainDOn, kAbF32Q, 4);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          const bool in = qt * kAbF32Q + ql < a.lq && ((e >> 1) ? kc : ka) < a.lk;
          const float x = s[4 * j + e] * a.scale + ((e >> 1) ? mkc : mka);
          const float p = in ? expf(x - sts[ql]) * sts[kAbF32Q + ql] : 0.0f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - sts[2 * kAbF32Q + ql]) * a.scale;  // dS
        }
      __syncthreads();  // every warp's scores are formed: Q's planes take dS
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi, lo;
          split_p<PDQ>(dp[4 * j + e], hi, lo);
          const uint32_t off =
              ab_plane_off(kAbF32Q, 8 * j + 2 * t + (e & 1), warp * 16 + g + 8 * (e >> 1));
          *reinterpret_cast<uint32_t*>(smem + kAbMainQn + off) = hi;
          *reinterpret_cast<uint32_t*>(smem + kAbMainQn + kAbPlane + off) = lo;
        }
      fence_proxy_async();

      float tile[32];
      ab_c_product<PDV>(tile, s, sbase + kAbMainDOt);  // dV += P^T dO
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[i] += tile[i];
      ab_c_product<PDK>(tile, dp, sbase + kAbMainQt);  // dK += dS^T Q
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] += tile[i];
      __syncthreads();  // dS is in shared memory for every warp
      float dqt[16];  // dQ^T = K^T dS: d rows g (+ 8) x queries 8 j + 2 t (+ 1)
#pragma unroll
      for (int i = 0; i < 16; ++i) dqt[i] = 0.0f;
      ab_frags4<PDQ, true>(kt, 0, fh0, fl0);
      ab_issue4<PDQ, 32, true>(dqt, fh0, fl0, sbase + kAbMainQn, kAbF32Q, 0);
      ab_frags4<PDQ, true>(kt, 4, fh1, fl1);
      ab_issue4<PDQ, 32, true>(dqt, fh1, fl1, sbase + kAbMainQn, kAbF32Q, 4);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qt * kAbF32Q + 8 * j + 2 * t + (e & 1);
          if (qi < a.lq) {
            float* pp = part + (long long)qi * kAbF32DH + warp * 16 + g + 8 * (e >> 1);
            *pp = first ? dqt[4 * j + e] : *pp + dqt[4 * j + e];
          }
        }
    }
    float* dko = a.dk + b * a.dk_bs + h * kAbF32DH + 2 * t;
    float* dvo = a.dv + b * a.dv_bs + h * kAbF32DH + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ka < a.lk) {
        *reinterpret_cast<float2*>(dko + (long long)ka * a.dk_rs + 8 * j) =
            make_float2(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<float2*>(dvo + (long long)ka * a.dv_rs + 8 * j) =
            make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (kc < a.lk) {
        *reinterpret_cast<float2*>(dko + (long long)kc * a.dk_rs + 8 * j) =
            make_float2(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<float2*>(dvo + (long long)kc * a.dv_rs + 8 * j) =
            make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// dq = the partials added in key-block order, a float4 a thread
__global__ void __launch_bounds__(256) attn_bwd_f32_dq_sum_kernel(const AttnBwdF32Args a,
                                                                   int bhs, int nparts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)bhs * a.lq;
  if (i >= rows * 16) return;
  const long long row = i >> 4;
  const int c = (int)(i & 15) * 4;
  const float* p = a.dqpart + row * kAbF32DH + c;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int kp = 1; kp < nparts; ++kp) {
    const float4 x = *reinterpret_cast<const float4*>(p + kp * rows * kAbF32DH);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int bh = (int)(row / a.lq), qi = (int)(row % a.lq);
  const int b = bh / a.heads, h = bh % a.heads;
  *reinterpret_cast<float4*>(a.dq + b * a.dq_bs + (long long)qi * a.dq_rs + h * kAbF32DH + c) =
      acc;
}

// Internal linkage: two libraries include this header (attention_bwd_f32,
// decoder_blocks_bwd_f32).
template <int PS, int PDP, int PDQ, int PDV, int PDK>
static cudaError_t launch_attention_bwd_f32_p(const AttnBwdF32Args& a, int batch,
                                              cudaStream_t stream) {
  auto main_kernel = attn_bwd_f32_main_kernel<PS, PDP, PDV, PDK, PDQ>;
  auto stats_kernel = attn_bwd_f32_stats_kernel<PS, PDP>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kAbMainSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(main_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kAbPreSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int bh = batch * a.heads;
  const long long rows = (long long)bh * a.lq;
  if (a.lse != nullptr) {
    attn_bwd_f32_delta_kernel<<<(unsigned)((rows * 16 + 255) / 256), 256, 0, stream>>>(a,
                                                                                      (int)rows);
  } else {
    stats_kernel<<<dim3((a.lq + kAbF32PreQ - 1) / kAbF32PreQ, bh), kAbF32Threads, kAbPreSmem,
                   stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nparts = ab_f32_parts(a.lk);
  main_kernel<<<dim3(nparts, bh), kAbF32Threads, kAbMainSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_f32_dq_sum_kernel<<<(unsigned)((rows * 16 + 255) / 256), 256, 0, stream>>>(a, bh,
                                                                                    nparts);
  return cudaGetLastError();
}

// a.lse non-null: K1b (a.o required); null: the blocks (a.o unused)
static cudaError_t launch_attention_bwd_f32(const AttnBwdF32Args& a, int batch,
                                            cudaStream_t stream) {
  if (a.lq < 1 || a.lk < 1 || batch < 1 || a.heads < 1 || (a.lse != nullptr && a.o == nullptr))
    return cudaErrorInvalidValue;
  if ((a.q_rs | a.k_rs | a.v_rs | a.do_rs | a.q_bs | a.k_bs | a.v_bs | a.do_bs | a.dq_rs |
       a.dk_rs | a.dv_rs | a.dq_bs | a.dk_bs | a.dv_bs) & 3 ||
      (a.lse != nullptr && (a.o_rs | a.o_bs) & 3))
    return cudaErrorInvalidValue;
  return launch_attention_bwd_f32_p<products_of(kProdBwdScores), products_of(kProdDP),
                                    products_of(kProdDQ), products_of(kProdDV),
                                    products_of(kProdDK)>(a, batch, stream);
}

}  // namespace crog
