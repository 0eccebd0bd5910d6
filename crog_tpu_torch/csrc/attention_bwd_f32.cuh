// The attention backward on fp32 operands, head dims 8-512: K1b-f32, and
// the attention step of K2b-f32 / K3b-f32.
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
// q, o, do, dq are [B, Lq, H*dh], k, v, dk, dv [B, Lk, H*dh], f32 with a
// free row and batch stride (multiples of 4 floats); any Lq, Lk >= 1.
//
// Head dims.  The kernels are templates on the head tile DH (32, 64 or
// 128; common.cuh attn_head_tile), the head's own dh (8 to DH) a
// run-time value: every load zero-fills the columns dh .. DH - 1 (in
// shared memory or registers, never in device memory) and no store writes
// them, so dh 8 and 16 run in the DH 32 build.  At DH 128 the Q and dO
// fragments of a 64-row tile would take 256 registers, so the pre-pass
// keeps Q and dO raw in shared memory and splits their fragments per use
// (as the main kernel does K's), over 32-key tiles; the main kernel's
// CTAs each own 64 of the head's columns of dK, dV and dQ (grid z), both
// forming S^T and dP^T over the whole head, so that the accumulators stay
// at DH 64's registers (with one register set for the split K and V
// fragments, which with two spill at DH 128's eight groups a product).
// One CTA an SM at DH 128 (160 and 193 KB).  Head tiles 256 and 512 run the
// wide pre-pass and main kernel (below).
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
//   (At head tile 64; 32 and 128 as the paragraph above says.)
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

constexpr int kAbF32Keys = 64;   // keys per CTA of the main kernel
constexpr int kAbF32Q = 32;      // queries per streamed tile of the main kernel
constexpr int kAbF32PreQ = 64;   // query rows per CTA of the pre-pass
constexpr int kAbF32Threads = 128;
constexpr int kAbF32MaxParts = 11;  // dQ partials at most (K2b-f32's count at 676 keys)

// keys per streamed tile of the pre-pass and of the forward: 64, or 32 at
// head tile 128 (whose [key][d] planes are as large)
template <int DH>
__host__ __device__ constexpr int ab_f32_key_tile() {
  return DH > 64 ? 32 : 64;
}

// head columns of dK, dV and dQ one main-kernel CTA owns
template <int DH>
__host__ __device__ constexpr int ab_f32_cols() {
  return DH > 64 ? 64 : DH;
}

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

// main kernel shared memory (bytes); each plane pair hi at +0, lo one plane
// after
template <int DH>
struct AbMain {
  static constexpr int kNC = ab_f32_cols<DH>();
  static constexpr int kQS = kAbF32Q * (DH > 64 ? DH : 64) * 4;  // a plane of Q [query][d], then of dS [query][key]
  static constexpr int kQP = kAbF32Q * DH * 4;    // a plane of dO [query][d]
  static constexpr int kTP = kNC * kAbF32Q * 4;   // a plane of Q^T or dO^T [d][query'], the CTA's columns
  static constexpr int kRawQ = kAbF32Q * DH * 4;  // the raw Q or dO tile
  static constexpr int kRawK = kAbF32Keys * DH * 4;  // the raw K or V tile
  static constexpr int kQn = 0;
  static constexpr int kDOn = kQn + 2 * kQS;
  static constexpr int kQt = kDOn + 2 * kQP;
  static constexpr int kDOt = kQt + 2 * kTP;
  static constexpr int kRaw = kDOt + 2 * kTP;  // the next tile's raw Q, then dO
  static constexpr int kK = kRaw + 2 * kRawQ;
  static constexpr int kV = kK + kRawK;
  static constexpr int kStat = kV + kRawK;  // 2 x [3][32]
  static constexpr int kSmem = kStat + 2 * 3 * kAbF32Q * 4;
};

// pre-pass shared memory (bytes)
template <int DH>
struct AbPre {
  static constexpr int kBK = ab_f32_key_tile<DH>();
  static constexpr int kPlane = kBK * DH * 4;  // one [key][d] plane
  static constexpr int kK = 0;                 // K [key][d] planes
  static constexpr int kV = 2 * kPlane;        // V [key][d] planes
  static constexpr int kRaw = 4 * kPlane;      // the next tile's raw K, then V
  static constexpr int kQ = 6 * kPlane;        // DH 128: the raw Q, then dO [64][DH]
  static constexpr int kSmem = kQ + (DH > 64 ? 2 * kAbF32PreQ * DH * 4 : 0);
};

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
  float* dqpart;  // [ab_f32_parts(Lk), B*H, Lq, dh]: each CTA's dq over its key blocks
  int heads, lq, lk;
  int dh;  // head dim; head h's columns are [h * dh, (h + 1) * dh)
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

// a raw [rows][DH] tile: 16-byte chunk c of row r at r * DH * 4 + (c ^ (r & 7)) * 16
template <int DH>
__device__ __forceinline__ uint32_t ab_raw_off(int r, int c4) {
  return r * (DH * 4) + ((c4 ^ (r & 7)) << 4);
}

// a raw tile read by A fragments both ways (rows, and transposed): float
// (r, c) of a [rows][DH] tile at r * DH + (c ^ ab_kswz(r)), free of bank
// conflicts for both (bits 3-4 follow r & 3, bit 2 r & 4)
__device__ __forceinline__ int ab_kswz(int r) { return ((r & 3) << 3) | (((r >> 2) & 1) << 2); }

template <int DH>
__device__ __forceinline__ float ab_kval(const float* t, int r, int c) {
  return t[r * DH + (c ^ ab_kswz(r))];
}

// rows [r0, r0 + rows) of a head slice of dh columns (row stride rs) into a
// raw [rows][DH] tile (ab_raw_off), rows past `limit` and columns past dh
// zero-filled
template <int DH>
__device__ __forceinline__ void ab_load_raw(uint32_t dst, const float* src, long long rs, int r0,
                                            int rows, int limit, int dh) {
  constexpr int C = DH / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * C; i += kAbF32Threads) {
    const int r = (unsigned)i / C, c4 = (unsigned)i % C;
    const bool in = r0 + r < limit && c4 * 4 < dh;
    cp_async16(dst + ab_raw_off<DH>(r, c4),
               src + (in ? (long long)(r0 + r) * rs : 0) + (c4 * 4 < dh ? c4 * 4 : 0), in ? 16 : 0);
  }
}

// the same rows into a [rows][DH] tile read by A fragments (ab_kval)
template <int DH>
__device__ __forceinline__ void ab_load_kswz(uint32_t dst, const float* src, long long rs, int r0,
                                             int rows, int limit, int dh) {
  constexpr int C = DH / 4;
  for (int i = threadIdx.x; i < rows * C; i += kAbF32Threads) {
    const int r = (unsigned)i / C, c = ((unsigned)i % C) * 4;
    const bool in = r0 + r < limit && c < dh;
    cp_async16(dst + (r * DH + (c ^ ab_kswz(r))) * 4,
               src + (in ? (long long)(r0 + r) * rs : 0) + (c < dh ? c : 0), in ? 16 : 0);
  }
}

__device__ __forceinline__ void st_u4(unsigned char* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// a raw [rows][DH] tile split once into its hi / lo planes [row][d] (PN;
// lo `plane` bytes after hi) and, with T, the head columns [c0, c0 + NC)
// of it into transposed planes [d][row'] (PT; lo `tplane_lo` bytes after
// hi): rows' 8-steps relabelled, row 8j + 2t + e at column 8j + 4e + t
template <int PN, int PT, bool T, int DH, int NC = DH>
__device__ __forceinline__ void ab_split_tile(unsigned char* smem, int raw, int nplane, int tplane,
                                              int rows, int plane, int tplane_lo = 0,
                                              int c0 = 0) {
  for (int i = threadIdx.x; i < rows * (DH / 4); i += kAbF32Threads) {
    const int r = i % rows, c4 = i / rows;  // a warp: 32 rows of one chunk
    const float4 x = *reinterpret_cast<const float4*>(smem + raw + ab_raw_off<DH>(r, c4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_p<PN>(xs[e], hi[e], lo[e]);
    const uint32_t on = ab_plane_off(rows, r, 4 * c4);
    st_u4(smem + nplane + on, hi);
    st_u4(smem + nplane + plane + on, lo);
    if constexpr (T) {
      if (NC == DH || (4 * c4 >= c0 && 4 * c4 < c0 + NC)) {
        const int rp = (r & ~7) | ((r & 1) << 2) | ((r & 6) >> 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_p<PT>(xs[e], hi[e], lo[e]);
          const uint32_t ot = ab_plane_off(NC, 4 * c4 + e - c0, rp);
          *reinterpret_cast<uint32_t*>(smem + tplane + ot) = hi[e];
          *reinterpret_cast<uint32_t*>(smem + tplane + tplane_lo + ot) = lo[e];
        }
      }
    }
  }
}

// K1b: each row's statistics (the forward's lse, 1, rowsum(do * o)), 16
// threads a row summing in a fixed order (64 columns a pass)
template <int DH>
__global__ void __launch_bounds__(256) attn_bwd_f32_delta_kernel(const AttnBwdF32Args a,
                                                                  int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = i >> 4;
  const int dh = attn_run_dh<DH>(a.dh);
  float s = 0.0f;
  const int bh = row / a.lq, qi = row % a.lq, b = bh / a.heads, h = bh % a.heads;
  if (row < rows) {
#pragma unroll
    for (int c = (i & 15) * 4; c < dh; c += 64) {
      const float4 ov = *reinterpret_cast<const float4*>(a.o + b * a.o_bs + qi * a.o_rs +
                                                         h * dh + c);
      const float4 dv = *reinterpret_cast<const float4*>(a.dout + b * a.do_bs + qi * a.do_rs +
                                                         h * dh + c);
      s += ov.x * dv.x + ov.y * dv.y + ov.z * dv.z + ov.w * dv.w;
    }
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

// this warp's A fragment of 8-deep step kk from a raw tile read by ab_kval
// (rows of DH floats): rows 16 warp + g (+ 8), columns 8 kk + t (+ 4); with
// T, of its transpose: rows (d) r0 + 16 warp + g (+ 8), columns (rows of
// the tile) 8 kk + t (+ 4), zero for d >= DH (M = 64 rows over a narrower
// head)
template <int P, bool T, int DH>
__device__ __forceinline__ void ab_frag(const float* tile, int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4], int r0 = 0) {
  const int lane = threadIdx.x & 31, r = r0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int c0 = 8 * kk + (lane & 3);
  float x[4];
  if constexpr (T) {
    const bool in = DH >= 64 || r < DH;  // the rows r, r + 8 are in or out together
    x[0] = in ? ab_kval<DH>(tile, c0, r) : 0.0f;
    x[1] = in ? ab_kval<DH>(tile, c0, r + 8) : 0.0f;
    x[2] = in ? ab_kval<DH>(tile, c0 + 4, r) : 0.0f;
    x[3] = in ? ab_kval<DH>(tile, c0 + 4, r + 8) : 0.0f;
  } else {
    x[0] = ab_kval<DH>(tile, r, c0);
    x[1] = ab_kval<DH>(tile, r + 8, c0);
    x[2] = ab_kval<DH>(tile, r, c0 + 4);
    x[3] = ab_kval<DH>(tile, r + 8, c0 + 4);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_p<P>(x[e], hi[e], lo[e]);
}

// this warp's A fragments of 8-deep steps kk0 .. kk0 + 3 (ab_frag)
template <int P, bool T, int DH>
__device__ __forceinline__ void ab_frags4(const float* tile, int kk0, uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4], int r0 = 0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ab_frag<P, T, DH>(tile, kk0 + i, hi[i], lo[i], r0);
}

// issues steps kk0 .. kk0 + 3 of d (+)= A B as one wgmma group, A's
// fragments (hi, lo) in registers, B the plane pair (hi at bplane, lo
// `lo_off` bytes after) of `brows` rows; step 0 starts d afresh
template <int P, int N, bool LO>
__device__ __forceinline__ void ab_issue4(float (&d)[N / 2], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t bplane,
                                          int brows, int kk0, int lo_off) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wg_step<P, N, LO>(d, hi[i], lo[i], ab_desc(bplane, brows, kk0 + i),
                      ab_desc(bplane + lo_off, brows, kk0 + i), kk0 + i > 0);
  wgmma_commit();
}

// d (+)= A B over the head tile's DH / 8 steps in groups of 4, A's fragments
// split per use from a raw tile read by ab_kval (ab_frags4) into SETS
// register sets in turn: with two, each group's fragments are split while
// the group before runs, a set refilled once the group that read it is
// done; with one (fewer registers), each group waits for the one before.
// G0: the groups this warpgroup issued before in the same sequence (their
// register sets alternate on).  B the plane pair of `brows` rows.  The
// caller waits for the last group.
template <int P, int N, bool LO, int DH, int G0, int SETS>
__device__ __forceinline__ void ab_product_raw(float (&d)[N / 2], const float* tile,
                                               uint32_t bplane, int brows, int lo_off,
                                               uint32_t (&fh)[SETS][4][4],
                                               uint32_t (&fl)[SETS][4][4]) {
#pragma unroll
  for (int grp = 0; grp < DH / 32; ++grp) {
    const int set = (G0 + grp) % SETS;
    if (G0 + grp >= SETS) wgmma_wait<SETS - 1>();
    ab_frags4<P, false, DH>(tile, 4 * grp, fh[set], fl[set]);
    ab_issue4<P, N, LO>(d, fh[set], fl[set], bplane, brows, 4 * grp, lo_off);
  }
}

// The blocks' pre-pass: each row's (m, 1 / l, delta) over every key, with
// delta = sum(p dp).  PS, PDP: how QK^T and dO V^T form their products.
template <int PS, int PDP, int DH>
__global__ void __launch_bounds__(kAbF32Threads, DH > 64 ? 1 : 2) attn_bwd_f32_stats_kernel(
    const AttnBwdF32Args a) {
  using L = AbPre<DH>;
  constexpr int BK = L::kBK;
  constexpr bool QREG = DH <= 64;  // Q and dO fragments split once into registers
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* smem = ab_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int dh = attn_run_dh<DH>(a.dh);
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kb = a.k + b * a.k_bs + h * dh;
  const float* vb = a.v + b * a.v_bs + h * dh;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const int ntiles = (a.lk + BK - 1) / BK;
  const int q0 = blockIdx.x * kAbF32PreQ;
  if constexpr (!QREG) {  // the raw Q and dO tiles, in the first group
    ab_load_kswz<DH>(sbase + L::kQ, a.q + b * a.q_bs + h * dh, a.q_rs, q0, kAbF32PreQ, a.lq, dh);
    ab_load_kswz<DH>(sbase + L::kQ + kAbF32PreQ * DH * 4, a.dout + b * a.do_bs + h * dh,
                     a.do_rs, q0, kAbF32PreQ, a.lq, dh);
  }
  auto load = [&](int kt) {
    ab_load_raw<DH>(sbase + L::kRaw, kb, a.k_rs, kt * BK, BK, a.lk, dh);
    ab_load_raw<DH>(sbase + L::kRaw + L::kPlane, vb, a.v_rs, kt * BK, BK, a.lk, dh);
    cp_async_commit();
  };
  load(0);

  // this thread's rows ra, rb: their Q and dO A fragments, split once
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  constexpr int QS = QREG ? DH / 8 : 1;
  uint32_t qh[QS][4], ql[QS][4], oh[QS][4], ol[QS][4];
  if constexpr (QREG) {
    const float* qa = a.q + b * a.q_bs + h * dh + (long long)(ra < a.lq ? ra : 0) * a.q_rs;
    const float* qc = a.q + b * a.q_bs + h * dh + (long long)(rb < a.lq ? rb : 0) * a.q_rs;
    const float* da = a.dout + b * a.do_bs + h * dh + (long long)(ra < a.lq ? ra : 0) * a.do_rs;
    const float* dc = a.dout + b * a.do_bs + h * dh + (long long)(rb < a.lq ? rb : 0) * a.do_rs;
#pragma unroll
    for (int s = 0; s < DH / 8; ++s) {
      const int c = 8 * s + t;
      const bool c_in = c < dh, c4_in = c + 4 < dh;
      split_p<PS>(ra < a.lq && c_in ? qa[c] : 0.0f, qh[s][0], ql[s][0]);
      split_p<PS>(rb < a.lq && c_in ? qc[c] : 0.0f, qh[s][1], ql[s][1]);
      split_p<PS>(ra < a.lq && c4_in ? qa[c + 4] : 0.0f, qh[s][2], ql[s][2]);
      split_p<PS>(rb < a.lq && c4_in ? qc[c + 4] : 0.0f, qh[s][3], ql[s][3]);
      split_p<PDP>(ra < a.lq && c_in ? da[c] : 0.0f, oh[s][0], ol[s][0]);
      split_p<PDP>(rb < a.lq && c_in ? dc[c] : 0.0f, oh[s][1], ol[s][1]);
      split_p<PDP>(ra < a.lq && c4_in ? da[c + 4] : 0.0f, oh[s][2], ol[s][2]);
      split_p<PDP>(rb < a.lq && c4_in ? dc[c + 4] : 0.0f, oh[s][3], ol[s][3]);
    }
  }

  // running max (shared by the quad), this thread's share of the sum and
  // of sum(exp(x - m) dp), rows ra (0) and rb (1)
  float m[2] = {ab_neg_inf(), ab_neg_inf()}, l[2] = {0.0f, 0.0f}, w[2] = {0.0f, 0.0f};
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with the planes
    ab_split_tile<PS, PS, false, DH>(smem, L::kRaw, L::kK, 0, BK, L::kPlane);
    ab_split_tile<PDP, PDP, false, DH>(smem, L::kRaw + L::kPlane, L::kV, 0, BK, L::kPlane);
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < ntiles) load(kt + 1);
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;
    if constexpr (QREG) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        wg_step<PS, BK>(s, qh[kk], ql[kk], ab_desc(sbase + L::kK, BK, kk),
                        ab_desc(sbase + L::kK + L::kPlane, BK, kk), kk > 0);
        wg_step<PDP, BK>(dp, oh[kk], ol[kk], ab_desc(sbase + L::kV, BK, kk),
                         ab_desc(sbase + L::kV + L::kPlane, BK, kk), kk > 0);
      }
      wgmma_commit();
    } else {
      uint32_t fh[2][4][4], fl[2][4][4];
      const float* qt = reinterpret_cast<const float*>(smem + L::kQ);
      ab_product_raw<PS, BK, true, DH, 0, 2>(s, qt, sbase + L::kK, BK, L::kPlane, fh, fl);
      ab_product_raw<PDP, BK, true, DH, DH / 32, 2>(dp, qt + kAbF32PreQ * DH, sbase + L::kV,
                                                    BK, L::kPlane, fh, fl);
    }
    wgmma_wait_all();
    const int k0 = kt * BK;
    float tmax[2] = {ab_neg_inf(), ab_neg_inf()};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
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
    for (int j = 0; j < BK / 8; ++j)
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

// d = X^T B over the tile's 32 queries (4 steps), X^T held as C fragments
// (x[4 j + e]: key rows g + 8 (e >> 1), queries 8 j + 2 t + (e & 1)),
// which are A fragments of the relabelled queries; B an [N][32] plane pair
// (lo `lo_off` bytes after hi)
template <int P, int N>
__device__ __forceinline__ void ab_c_product(float (&d)[N / 2], const float (&x)[16],
                                             uint32_t bplane, int lo_off) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_p<P>(x[4 * kk + 0], hi[kk][0], lo[kk][0]);  // (row g,     query 2t)
    split_p<P>(x[4 * kk + 2], hi[kk][1], lo[kk][1]);  // (row g + 8, query 2t)
    split_p<P>(x[4 * kk + 1], hi[kk][2], lo[kk][2]);  // (row g,     query 2t + 1)
    split_p<P>(x[4 * kk + 3], hi[kk][3], lo[kk][3]);  // (row g + 8, query 2t + 1)
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg_step<P, N>(d, hi[kk], lo[kk], ab_desc(bplane, N, kk), ab_desc(bplane + lo_off, N, kk),
                  kk > 0);
  wgmma_commit();
  wgmma_wait_all();
}

// The main pass over ab_f32_group(Lk) consecutive 64-key blocks.  PS, PDP,
// PDV, PDK, PDQ: how QK^T, dO V^T, P^T dO, dS^T Q and dS K form their
// products.
template <int PS, int PDP, int PDV, int PDK, int PDQ, int DH>
__global__ void __launch_bounds__(kAbF32Threads, DH > 64 ? 1 : 2) attn_bwd_f32_main_kernel(
    const AttnBwdF32Args a) {
  using L = AbMain<DH>;
  constexpr int NC = L::kNC;
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* smem = ab_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int dh = attn_run_dh<DH>(a.dh);
  const int c0 = NC == DH ? 0 : blockIdx.z * NC;  // this CTA's head columns of dK, dV and dQ
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kt = reinterpret_cast<const float*>(smem + L::kK);
  const float* vt = reinterpret_cast<const float*>(smem + L::kV);
  const float* kb = a.k + b * a.k_bs + h * dh;
  const float* vb = a.v + b * a.v_bs + h * dh;
  const float* qb = a.q + b * a.q_bs + h * dh;
  const float* db = a.dout + b * a.do_bs + h * dh;
  const float* st = a.stats + (long long)bh * 3 * a.lq;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  auto load_q = [&](int qt) {
    const int q0 = qt * kAbF32Q;
    ab_load_raw<DH>(sbase + L::kRaw, qb, a.q_rs, q0, kAbF32Q, a.lq, dh);
    ab_load_raw<DH>(sbase + L::kRaw + L::kRawQ, db, a.do_rs, q0, kAbF32Q, a.lq, dh);
    if (threadIdx.x < 3 * kAbF32Q) {  // m, r, delta of the tile's rows
      const int which = threadIdx.x / kAbF32Q, r = q0 + threadIdx.x % kAbF32Q;
      const bool in = r < a.lq;
      cp_async4(sbase + L::kStat + ((qt & 1) * 3 * kAbF32Q + threadIdx.x) * 4,
                st + (long long)which * a.lq + (in ? r : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  float* part = a.dqpart + ((long long)blockIdx.x * gridDim.y + bh) * a.lq * dh;
  const int nqt = (a.lq + kAbF32Q - 1) / kAbF32Q;
  const int group = ab_f32_group(a.lk);
  const int kb0 = blockIdx.x * group;
  const int kb1 = min(kb0 + group, (a.lk + kAbF32Keys - 1) / kAbF32Keys);

  for (int kblk = kb0; kblk < kb1; ++kblk) {
    const int k0 = kblk * kAbF32Keys;
    if (kblk > kb0) __syncthreads();  // every warp is done with the last block's tiles
    for (int i = threadIdx.x; i < kAbF32Keys * (DH / 4); i += kAbF32Threads) {
      const int r = (unsigned)i / (DH / 4), c = ((unsigned)i % (DH / 4)) * 4;
      const bool in = k0 + r < a.lk && c < dh;
      const long long row = in ? k0 + r : 0;  // rows past Lk are zero-filled
      const uint32_t off = (r * DH + (c ^ ab_kswz(r))) * 4;
      cp_async16(sbase + L::kK + off, kb + row * a.k_rs + (c < dh ? c : 0), in ? 16 : 0);
      cp_async16(sbase + L::kV + off, vb + row * a.v_rs + (c < dh ? c : 0), in ? 16 : 0);
    }
    load_q(0);

    // this thread's keys ka (C fragment rows g) and kc (g + 8)
    const int ka = k0 + warp * 16 + g, kc = ka + 8;
    const float mka = (mk != nullptr && ka < a.lk) ? mk[ka] : 0.0f;
    const float mkc = (mk != nullptr && kc < a.lk) ? mk[kc] : 0.0f;
    const bool first = kblk == kb0;  // writes the partial; later blocks add to it

    float dk[NC / 2], dv[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dk[i] = dv[i] = 0.0f;
    for (int qt = 0; qt < nqt; ++qt) {
      cp_async_wait_all();
      __syncthreads();  // tile qt landed; every warp is done with the planes
      ab_split_tile<PS, PDK, true, DH, NC>(smem, L::kRaw, L::kQn, L::kQt, kAbF32Q, L::kQS,
                                           L::kTP, c0);
      ab_split_tile<PDP, PDV, true, DH, NC>(smem, L::kRaw + L::kRawQ, L::kDOn, L::kDOt, kAbF32Q,
                                            L::kQP, L::kTP, c0);
      fence_proxy_async();
      __syncthreads();
      if (qt + 1 < nqt) load_q(qt + 1);  // the raw tile is free: one tile ahead
      const float* sts =
          reinterpret_cast<const float*>(smem + L::kStat) + (qt & 1) * 3 * kAbF32Q;

      // S^T = K Q^T and dP^T = V dO^T (keys g (+ 8) x queries 8 j + 2 t (+ 1)),
      // 4 steps a group: each group's A fragments are split while the group
      // before runs, in the registers of the group two before
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.0f;
      // (one register set at DH 128, whose eight groups would spill with two)
      constexpr int SETS = DH > 64 ? 1 : 2;
      uint32_t fh[SETS][4][4], fl[SETS][4][4];
      ab_product_raw<PS, 32, false, DH, 0, SETS>(s, kt, sbase + L::kQn, kAbF32Q, L::kQS, fh,
                                                 fl);
      ab_product_raw<PDP, 32, false, DH, DH / 32, SETS>(dp, vt, sbase + L::kDOn, kAbF32Q,
                                                        L::kQP, fh, fl);
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
          *reinterpret_cast<uint32_t*>(smem + L::kQn + off) = hi;
          *reinterpret_cast<uint32_t*>(smem + L::kQn + L::kQS + off) = lo;
        }
      fence_proxy_async();

      float tile[NC / 2];
      ab_c_product<PDV, NC>(tile, s, sbase + L::kDOt, L::kTP);  // dV += P^T dO
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) dv[i] += tile[i];
      ab_c_product<PDK, NC>(tile, dp, sbase + L::kQt, L::kTP);  // dK += dS^T Q
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) dk[i] += tile[i];
      __syncthreads();  // dS is in shared memory for every warp
      float dqt[16];  // dQ^T = K^T dS: d rows g (+ 8) x queries 8 j + 2 t (+ 1)
#pragma unroll
      for (int i = 0; i < 16; ++i) dqt[i] = 0.0f;
      ab_frags4<PDQ, true, DH>(kt, 0, fh[0], fl[0], c0);
      ab_issue4<PDQ, 32, true>(dqt, fh[0], fl[0], sbase + L::kQn, kAbF32Q, 0, L::kQS);
      if constexpr (SETS == 1) wgmma_wait<0>();
      ab_frags4<PDQ, true, DH>(kt, 4, fh[SETS - 1], fl[SETS - 1], c0);
      ab_issue4<PDQ, 32, true>(dqt, fh[SETS - 1], fl[SETS - 1], sbase + L::kQn, kAbF32Q, 4,
                               L::kQS);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qt * kAbF32Q + 8 * j + 2 * t + (e & 1);
          const int d = c0 + warp * 16 + g + 8 * (e >> 1);
          if (qi < a.lq && d < dh) {
            float* pp = part + (long long)qi * dh + d;
            *pp = first ? dqt[4 * j + e] : *pp + dqt[4 * j + e];
          }
        }
    }
    float* dko = a.dk + b * a.dk_bs + h * dh + c0 + 2 * t;
    float* dvo = a.dv + b * a.dv_bs + h * dh + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      if (c0 + 8 * j >= dh) continue;
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

// dq = the partials [parts][B*H][Lq][dh] added in key-block order, a float4
// a thread
template <int DH>
__global__ void __launch_bounds__(256) attn_bwd_f32_dq_sum_kernel(const AttnBwdF32Args a,
                                                                   int bhs, int nparts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)bhs * a.lq;
  const int dh = attn_run_dh<DH>(a.dh);
  const int per = dh / 4;  // float4 a row
  if (i >= rows * per) return;
  const long long row = i / per;
  const int c = (int)(i % per) * 4;
  const float* p = a.dqpart + row * dh + c;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int kp = 1; kp < nparts; ++kp) {
    const float4 x = *reinterpret_cast<const float4*>(p + kp * rows * dh);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int bh = (int)(row / a.lq), qi = (int)(row % a.lq);
  const int b = bh / a.heads, h = bh % a.heads;
  *reinterpret_cast<float4*>(a.dq + b * a.dq_bs + (long long)qi * a.dq_rs + h * dh + c) = acc;
}

// ------------------------------------------------- head tiles 256 and 512
// At DH 256 and 512 neither kernel above fits: the pre-pass's raw Q and dO
// rows would take 128 or 256 KiB, the main kernel's raw K and V block as
// much, and Q's and dO's planes twice that.  The wide kernels stream the
// head in 64-column chunks, each landing raw (double-buffered, one chunk
// ahead) and split once into the planes its product reads, each chunk's
// product summing in fresh registers joined to the running sums by IEEE
// adds (no truncating tensor-core sum deeper than 64):
//   attn_bwd_f32_stats_wide_kernel: 64 query rows a CTA; per 32-key tile
//     the chunks (Q, dO, K, V) c give S and dP over the head (Q and dO the
//     A fragments, split per use from their raw chunks; K and V split into
//     [key][d] planes); then the pre-pass's online statistics.
//   attn_bwd_f32_main_wide_kernel: 64 keys and one 64-column chunk cz of
//     dK, dV and dQ a CTA (grid z DH / 64), over 32-query tiles as the main
//     kernel walks them (its key-block groups and dQ partials alike).  Per
//     tile the chunks (Q, dO, K, V) c give S^T and dP^T over the head (K
//     and V the A fragments from their raw chunks; Q and dO split into
//     [query][d] planes, and at c = cz also into the transposed planes of
//     dK's and dV's B); then P, dS, dV, dK and dQ^T = K_cz^T dS as the main
//     kernel forms them, K's chunk cz held raw for the block.
// Every CTA of a key block forms the whole head's S^T and dP^T (4 times at
// DH 256, 8 at 512).  Shared memory: pre-pass 131,072 bytes, main 180,992,
// at either width: one CTA an SM.
template <int DH>
struct AbPreWide {
  static constexpr int kBK = 32;                // keys per tile
  static constexpr int kPlane = kBK * 64 * 4;   // a K or V chunk's [key][d] plane
  static constexpr int kQRaw = kAbF32PreQ * 64 * 4;  // a raw Q or dO chunk [64][64]
  static constexpr int kKRaw = kBK * 64 * 4;    // a raw K or V chunk [kBK][64]
  static constexpr int kStage = 2 * kQRaw + 2 * kKRaw;  // raw Q, dO, K, V chunks
  static constexpr int kK = 0;                  // K chunk planes
  static constexpr int kV = 2 * kPlane;         // V chunk planes
  static constexpr int kRaw = 4 * kPlane;       // [2 stages]
  static constexpr int kSmem = kRaw + 2 * kStage;
};

template <int DH>
struct AbMainWide {
  static constexpr int kQS = kAbF32Q * 64 * 4;  // a plane of Q or dO [query][d], or dS [query][key]
  static constexpr int kTP = 64 * kAbF32Q * 4;  // a plane of Q^T or dO^T [d][query']
  static constexpr int kQRaw = kAbF32Q * 64 * 4;     // a raw Q or dO chunk [32][64]
  static constexpr int kKRaw = kAbF32Keys * 64 * 4;  // a raw K or V chunk [64][64]
  static constexpr int kStage = 2 * kQRaw + 2 * kKRaw;
  static constexpr int kQn = 0;
  static constexpr int kDOn = kQn + 2 * kQS;
  static constexpr int kQt = kDOn + 2 * kQS;
  static constexpr int kDOt = kQt + 2 * kTP;
  static constexpr int kKz = kDOt + 2 * kTP;  // K's chunk cz, raw, for the block
  static constexpr int kRaw = kKz + kKRaw;    // [2 stages][Q, dO, K, V]
  static constexpr int kStat = kRaw + 2 * kStage;  // 2 x [3][32]
  static constexpr int kSmem = kStat + 2 * 3 * kAbF32Q * 4;
};

template <int PS, int PDP, int DH>
__global__ void __launch_bounds__(kAbF32Threads, 1) attn_bwd_f32_stats_wide_kernel(
    const AttnBwdF32Args a) {
  using L = AbPreWide<DH>;
  constexpr int BK = L::kBK, NCH = DH / 64;
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* smem = ab_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* qb = a.q + b * a.q_bs + h * DH;
  const float* db = a.dout + b * a.do_bs + h * DH;
  const float* kb = a.k + b * a.k_bs + h * DH;
  const float* vb = a.v + b * a.v_bs + h * DH;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  const int ntiles = (a.lk + BK - 1) / BK;
  const int q0 = blockIdx.x * kAbF32PreQ;
  const int n = ntiles * NCH;
  auto load = [&](int i) {  // chunk c of key tile kt: raw Q, dO (kswz), K, V
    if (i < n) {
      const int kt = i / NCH, c = i % NCH;
      const uint32_t st = sbase + L::kRaw + (i & 1) * L::kStage;
      ab_load_kswz<64>(st, qb + c * 64, a.q_rs, q0, kAbF32PreQ, a.lq, 64);
      ab_load_kswz<64>(st + L::kQRaw, db + c * 64, a.do_rs, q0, kAbF32PreQ, a.lq, 64);
      ab_load_raw<64>(st + 2 * L::kQRaw, kb + c * 64, a.k_rs, kt * BK, BK, a.lk, 64);
      ab_load_raw<64>(st + 2 * L::kQRaw + L::kKRaw, vb + c * 64, a.v_rs, kt * BK, BK, a.lk, 64);
    }
    cp_async_commit();
  };
  load(0);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  float m[2] = {ab_neg_inf(), ab_neg_inf()}, l[2] = {0.0f, 0.0f}, w[2] = {0.0f, 0.0f};
  float s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int kt = i / NCH, c = i % NCH;
    const int so = L::kRaw + (i & 1) * L::kStage;
    cp_async_wait<0>();
    __syncthreads();  // chunk i landed; every warp is done with the planes and stage i - 1
    ab_split_tile<PS, PS, false, 64>(smem, so + 2 * L::kQRaw, L::kK, 0, BK, L::kPlane);
    ab_split_tile<PDP, PDP, false, 64>(smem, so + 2 * L::kQRaw + L::kKRaw, L::kV, 0, BK,
                                       L::kPlane);
    fence_proxy_async();
    __syncthreads();
    load(i + 1);
    if (c == 0) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.0f;
    }
    float sc[BK / 2], dpc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = dpc[e] = 0.0f;
    uint32_t fh[2][4][4], fl[2][4][4];
    const float* qr = reinterpret_cast<const float*>(smem + so);
    ab_product_raw<PS, BK, true, 64, 0, 2>(sc, qr, sbase + L::kK, BK, L::kPlane, fh, fl);
    ab_product_raw<PDP, BK, true, 64, 2, 2>(dpc, qr + kAbF32PreQ * 64, sbase + L::kV, BK,
                                            L::kPlane, fh, fl);
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      s[e] += sc[e];
      dp[e] += dpc[e];
    }
    if (c < NCH - 1) continue;
    const int k0 = kt * BK;
    float tmax[2] = {ab_neg_inf(), ab_neg_inf()};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
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
      const float cr = expf(m[r] - mnew);
      l[r] *= cr;
      w[r] *= cr;
      m[r] = mnew;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p;
        w[e >> 1] += p * dp[4 * j + e];
      }
  }
  cp_async_wait<0>();
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

template <int PS, int PDP, int PDV, int PDK, int PDQ, int DH>
__global__ void __launch_bounds__(kAbF32Threads, 1) attn_bwd_f32_main_wide_kernel(
    const AttnBwdF32Args a) {
  using L = AbMainWide<DH>;
  constexpr int NCH = DH / 64;
  extern __shared__ __align__(1024) unsigned char ab_smem[];
  unsigned char* smem = ab_smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int cz = blockIdx.z;  // this CTA's 64 columns of dK, dV and dQ are chunk cz
  const uint32_t sbase = smem_u32(smem);
  if (sbase & 1023) __trap();  // the planes' swizzle needs 1024-byte alignment
  const float* kzt = reinterpret_cast<const float*>(smem + L::kKz);
  const float* kb = a.k + b * a.k_bs + h * DH;
  const float* vb = a.v + b * a.v_bs + h * DH;
  const float* qb = a.q + b * a.q_bs + h * DH;
  const float* db = a.dout + b * a.do_bs + h * DH;
  const float* stg = a.stats + (long long)bh * 3 * a.lq;
  const float* mk = a.mask != nullptr ? a.mask + (long long)b * a.lk : nullptr;
  float* part = a.dqpart + ((long long)blockIdx.x * gridDim.y + bh) * a.lq * DH;
  const int nqt = (a.lq + kAbF32Q - 1) / kAbF32Q;
  const int n = nqt * NCH;
  const int group = ab_f32_group(a.lk);
  const int kb0 = blockIdx.x * group;
  const int kb1 = min(kb0 + group, (a.lk + kAbF32Keys - 1) / kAbF32Keys);

  for (int kblk = kb0; kblk < kb1; ++kblk) {
    const int k0 = kblk * kAbF32Keys;
    // chunk c of query tile qt: raw Q, dO, K, V (and with c = 0 the tile's
    // statistics), one cp.async group
    auto load = [&](int i) {
      if (i < n) {
        const int qt = i / NCH, c = i % NCH, q0 = qt * kAbF32Q;
        const uint32_t st = sbase + L::kRaw + (i & 1) * L::kStage;
        ab_load_raw<64>(st, qb + c * 64, a.q_rs, q0, kAbF32Q, a.lq, 64);
        ab_load_raw<64>(st + L::kQRaw, db + c * 64, a.do_rs, q0, kAbF32Q, a.lq, 64);
        ab_load_kswz<64>(st + 2 * L::kQRaw, kb + c * 64, a.k_rs, k0, kAbF32Keys, a.lk, 64);
        ab_load_kswz<64>(st + 2 * L::kQRaw + L::kKRaw, vb + c * 64, a.v_rs, k0, kAbF32Keys,
                         a.lk, 64);
        if (c == 0 && threadIdx.x < 3 * kAbF32Q) {  // m, r, delta of the tile's rows
          const int which = threadIdx.x / kAbF32Q, r = q0 + threadIdx.x % kAbF32Q;
          const bool in = r < a.lq;
          cp_async4(sbase + L::kStat + ((qt & 1) * 3 * kAbF32Q + threadIdx.x) * 4,
                    stg + (long long)which * a.lq + (in ? r : 0), in ? 4 : 0);
        }
      }
      cp_async_commit();
    };
    if (kblk > kb0) __syncthreads();  // every warp is done with the last block's tiles
    ab_load_kswz<64>(sbase + L::kKz, kb + cz * 64, a.k_rs, k0, kAbF32Keys, a.lk, 64);
    load(0);

    const int ka = k0 + warp * 16 + g, kc = ka + 8;
    const float mka = (mk != nullptr && ka < a.lk) ? mk[ka] : 0.0f;
    const float mkc = (mk != nullptr && kc < a.lk) ? mk[kc] : 0.0f;
    const bool first = kblk == kb0;  // writes the partial; later blocks add to it
    float dk[32], dv[32], s[16], dp[16];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int qt = i / NCH, c = i % NCH;
      const int so = L::kRaw + (i & 1) * L::kStage;
      cp_async_wait<0>();
      __syncthreads();  // chunk i landed; every warp is done with the planes and stage i - 1
      if (c == cz) {
        ab_split_tile<PS, PDK, true, 64, 64>(smem, so, L::kQn, L::kQt, kAbF32Q, L::kQS, L::kTP);
        ab_split_tile<PDP, PDV, true, 64, 64>(smem, so + L::kQRaw, L::kDOn, L::kDOt, kAbF32Q,
                                              L::kQS, L::kTP);
      } else {
        ab_split_tile<PS, PS, false, 64>(smem, so, L::kQn, 0, kAbF32Q, L::kQS);
        ab_split_tile<PDP, PDP, false, 64>(smem, so + L::kQRaw, L::kDOn, 0, kAbF32Q, L::kQS);
      }
      fence_proxy_async();
      __syncthreads();
      load(i + 1);
      if (c == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = dp[e] = 0.0f;
      }
      // S^T = K Q^T and dP^T = V dO^T over this chunk (keys g (+ 8) x
      // queries 8 j + 2 t (+ 1)), one register set: each group waits for
      // the one before
      float sc[16], dpc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] = dpc[e] = 0.0f;
      uint32_t fh[1][4][4], fl[1][4][4];
      const float* kr = reinterpret_cast<const float*>(smem + so + 2 * L::kQRaw);
      ab_product_raw<PS, 32, false, 64, 0, 1>(sc, kr, sbase + L::kQn, kAbF32Q, L::kQS, fh, fl);
      ab_product_raw<PDP, 32, false, 64, 2, 1>(dpc, kr + kAbF32Keys * 64, sbase + L::kDOn,
                                               kAbF32Q, L::kQS, fh, fl);
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        s[e] += sc[e];
        dp[e] += dpc[e];
      }
      if (c < NCH - 1) continue;

      const float* sts = reinterpret_cast<const float*>(smem + L::kStat) + (qt & 1) * 3 * kAbF32Q;
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
          *reinterpret_cast<uint32_t*>(smem + L::kQn + off) = hi;
          *reinterpret_cast<uint32_t*>(smem + L::kQn + L::kQS + off) = lo;
        }
      fence_proxy_async();

      float tile[32];
      ab_c_product<PDV, 64>(tile, s, sbase + L::kDOt, L::kTP);  // dV += P^T dO
#pragma unroll
      for (int e = 0; e < 32; ++e) dv[e] += tile[e];
      ab_c_product<PDK, 64>(tile, dp, sbase + L::kQt, L::kTP);  // dK += dS^T Q
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[e] += tile[e];
      __syncthreads();  // dS is in shared memory for every warp
      float dqt[16];  // dQ^T = K^T dS: d rows g (+ 8) x queries 8 j + 2 t (+ 1)
#pragma unroll
      for (int e = 0; e < 16; ++e) dqt[e] = 0.0f;
      ab_frags4<PDQ, true, 64>(kzt, 0, fh[0], fl[0]);
      ab_issue4<PDQ, 32, true>(dqt, fh[0], fl[0], sbase + L::kQn, kAbF32Q, 0, L::kQS);
      wgmma_wait<0>();
      ab_frags4<PDQ, true, 64>(kzt, 4, fh[0], fl[0]);
      ab_issue4<PDQ, 32, true>(dqt, fh[0], fl[0], sbase + L::kQn, kAbF32Q, 4, L::kQS);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qt * kAbF32Q + 8 * j + 2 * t + (e & 1);
          const int d = cz * 64 + warp * 16 + g + 8 * (e >> 1);
          if (qi < a.lq) {
            float* pp = part + (long long)qi * DH + d;
            *pp = first ? dqt[4 * j + e] : *pp + dqt[4 * j + e];
          }
        }
    }
    cp_async_wait<0>();
    float* dko = a.dk + b * a.dk_bs + h * DH + cz * 64 + 2 * t;
    float* dvo = a.dv + b * a.dv_bs + h * DH + cz * 64 + 2 * t;
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

template <int PS, int PDP, int PDQ, int PDV, int PDK, int DH>
static cudaError_t launch_attention_bwd_f32_wide_p(const AttnBwdF32Args& a, int batch,
                                                   cudaStream_t stream) {
  using LM = AbMainWide<DH>;
  using LP = AbPreWide<DH>;
  auto main_kernel = attn_bwd_f32_main_wide_kernel<PS, PDP, PDV, PDK, PDQ, DH>;
  auto stats_kernel = attn_bwd_f32_stats_wide_kernel<PS, PDP, DH>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         LM::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LP::kSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int bh = batch * a.heads;
  const long long rows = (long long)bh * a.lq;
  if (a.lse != nullptr) {
    attn_bwd_f32_delta_kernel<DH><<<(unsigned)((rows * 16 + 255) / 256), 256, 0, stream>>>(
        a, (int)rows);
  } else {
    stats_kernel<<<dim3((a.lq + kAbF32PreQ - 1) / kAbF32PreQ, bh), kAbF32Threads, LP::kSmem,
                   stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nparts = ab_f32_parts(a.lk);
  main_kernel<<<dim3(nparts, bh, DH / 64), kAbF32Threads, LM::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = rows * (DH / 4);
  attn_bwd_f32_dq_sum_kernel<DH><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(a, bh,
                                                                                      nparts);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_attention_bwd_f32_wide(const AttnBwdF32Args& a, int batch,
                                                 cudaStream_t stream) {
  return launch_attention_bwd_f32_wide_p<products_of(kProdBwdScores), products_of(kProdDP),
                                         products_of(kProdDQ), products_of(kProdDV),
                                         products_of(kProdDK), DH>(a, batch, stream);
}

// Internal linkage: two libraries include this header (attention_bwd_f32,
// decoder_blocks_bwd_f32).
template <int PS, int PDP, int PDQ, int PDV, int PDK, int DH>
static cudaError_t launch_attention_bwd_f32_p(const AttnBwdF32Args& a, int batch,
                                              cudaStream_t stream) {
  using LM = AbMain<DH>;
  using LP = AbPre<DH>;
  auto main_kernel = attn_bwd_f32_main_kernel<PS, PDP, PDV, PDK, PDQ, DH>;
  auto stats_kernel = attn_bwd_f32_stats_kernel<PS, PDP, DH>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         LM::kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(main_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LP::kSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int bh = batch * a.heads;
  const long long rows = (long long)bh * a.lq;
  if (a.lse != nullptr) {
    attn_bwd_f32_delta_kernel<DH><<<(unsigned)((rows * 16 + 255) / 256), 256, 0, stream>>>(
        a, (int)rows);
  } else {
    stats_kernel<<<dim3((a.lq + kAbF32PreQ - 1) / kAbF32PreQ, bh), kAbF32Threads, LP::kSmem,
                   stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nparts = ab_f32_parts(a.lk);
  main_kernel<<<dim3(nparts, bh, DH / LM::kNC), kAbF32Threads, LM::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long quads = rows * (a.dh / 4);
  attn_bwd_f32_dq_sum_kernel<DH><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(a, bh,
                                                                                      nparts);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_attention_bwd_f32_dh(const AttnBwdF32Args& a, int batch,
                                               cudaStream_t stream) {
  return launch_attention_bwd_f32_p<products_of(kProdBwdScores), products_of(kProdDP),
                                    products_of(kProdDQ), products_of(kProdDV),
                                    products_of(kProdDK), DH>(a, batch, stream);
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
  switch (attn_head_tile(a.dh)) {
    case 32: return launch_attention_bwd_f32_dh<32>(a, batch, stream);
    case 64: return launch_attention_bwd_f32_dh<64>(a, batch, stream);
    case 128: return launch_attention_bwd_f32_dh<128>(a, batch, stream);
    case 256: return launch_attention_bwd_f32_wide<256>(a, batch, stream);
    case 512: return launch_attention_bwd_f32_wide<512>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace crog
