// The fp32 products on Hopper's wgmma: C = A B (+ an epilogue) with f32
// accuracy, every product 3xTF32 (tf32.cuh).  Where A comes from is the
// kernel's A policy: a matrix read as stored, [M, K] (GwAMatrix<false>), or
// transposed from a [K, M] matrix (GwAMatrix<true>: dW = dY^T X, K the rows
// of the batch, split in fixed chunks), or a patch gathered from an
// activation tensor (s2dconv_f32.cu's policies: the s2d stem's conv K6-f32
// and its wgrad K6b-f32); B arrives as its TF32 hi and lo planes [N, K],
// split once per call by gw_split_b_kernel from a B stored [N, K] (a torch
// Linear weight) or [K, N] (a weight read with its rows as K, or the
// batch's rows).  K4-f32 (ffn_f32.cu) forms its hidden x W1^T and its
// output hn W2^T here, K4b-f32 (ffn_bwd_f32.cu) the recompute of that
// hidden (`ffn_hidden_f32`, the same kernels, tile, K order and epilogue,
// so the two agree bit for bit), dhn = dy W2, dx = dh W1, dW1 = dh^T x and
// dW2 as its transpose hn^T dy; K2-f32 and K3-f32 (decoder_blocks_f32.cu)
// their projections, K2b-f32 and K3b-f32 (decoder_blocks_bwd_f32.cu) their
// dO, dX, d(txt) and dW.
//
// Bound on an H100: operations, at 3xTF32's third of TF32's 495 TFLOP/s
// (each of the six products at the main path's M = 16224, D 512, F 2048:
// 34 GFLOP, about 0.206 ms).
//
// Design.  TF32 wgmma reads only K-major operands from shared memory, and
// the 3xTF32 split needs a hi and a lo copy of each:
//   - B is split once per call, not per tile: a pre-pass writes its hi and
//     lo planes K-major to a workspace (W1, W2, W2^T, W1^T: 8 MB each pair;
//     x and dy for dW: 66 MB, about 20 us), and TMA lands both planes of a
//     tile 128-byte swizzled, as wgmma reads them.  No warp splits B in the
//     product loop.  Splitting each B tile once per CTA in shared memory
//     instead (an earlier version of this header) was slower on an H100 for
//     every product: the CTAs of a column of tiles each split the same
//     tile, and the split's shared-memory traffic did not overlap the
//     products.
//   - A comes from registers: the warp that owns 16 rows of the tile reads
//     its fragments from the TMA-landed tile (128-byte swizzled; read
//     transposed for dW, as two boxes whose swizzle keeps the fragment
//     loads on 32 banks) and splits them once per use, the next slice's
//     while this slice's products run.  The policy says which of a
//     thread's values lie inside A (GwKeep); the others are split as 0,
//     so a gathered A with zeros off an image costs a select, no pass.
//   - each 8-deep step is three wgmma m64n128k8 .tf32: lo.hi, hi.lo, hi.hi.
// A CTA of two warpgroups computes a 128 x 128 tile of C, 64 rows each,
// over 32-deep K slices that a four-stage TMA ring (an mbarrier a stage,
// thread 0 issuing) brings into shared memory, 48 KiB a stage (A, B hi, B
// lo).  Shared memory: 4 x 49,152 + 1,024 bytes (the ring aligned to 1,024
// for the swizzle) and the tile's bias, one CTA an SM.  Registers: the
// running sum and the slice's sum, 64 each a thread, and two slices' A
// fragments, hi and lo, 64.  No product falls back to mma.sync.
// Fresh accumulators: each 32-deep slice sums in registers that start at
// zero (scale-d 0, 12 wgmmas), joined to the running sum by an IEEE f32
// add: one accumulator over K = 2048 read 1.45e-5 against the twin in the
// first fp32 GEMMs.  K4b-f32's dW runs over row chunks of at most
// kGwChunkRows (`gw_dw_chunk`, a function of M alone; the decoder blocks'
// products take a plan of their own, decoder_blocks_bwd_f32.cu
// bwd_chunk), each chunk's partial written to a workspace and the partials
// summed in chunk order (grad_f32.cuh reduce_parts): no atomics, two calls
// give the same bits.  Rows of C past
// M are not stored; rows of A past M and K past its chunk load zeros.  The
// grid's x runs over the tiles, columns fastest (so a row tile's CTAs start
// together), z over the chunks of K.
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kGwM = 128;         // rows of a CTA's tile: two warpgroups of 64
constexpr int kGwN = 128;         // columns of a CTA's tile
constexpr int kGwK = 32;          // K per slice, one ring stage each
constexpr int kGwThreads = 256;
constexpr int kGwStages = 4;
constexpr int kGwChunkRows = 8192;  // dW: K rows per chunk at most
constexpr int kGwTile = kGwN * kGwK * 4;  // bytes of one [128][32] f32 tile
// a ring stage: A's tile, B's TF32 hi and lo planes
constexpr int kGwOffA = 0, kGwOffBh = kGwTile, kGwOffBl = 2 * kGwTile;
constexpr int kGwStage = 3 * kGwTile;
constexpr int kGwSmem = kGwStages * kGwStage + 1024;

enum GwEpilogue : int { kGwStore = 0, kGwBias = 1, kGwBiasReluDrop = 2 };

struct GemmWgF32 {
  const float* a;     // GwAMatrix<false>: A[m][k] at a + m lda + k; <true>: at a + k lda + m
  const float* b;     // B's hi plane [n][k] at b + n ldb + k, its lo plane N ldb after
  float* c;           // C[m][n] of chunk z at c + z c_zs + m ldc + n
  const float* bias;  // [N]: kGwBias, kGwBiasReluDrop
  long long lda, ldb, ldc, c_zs;
  int m, n, k;
  int kchunk;    // K per chunk, a multiple of kGwK; gridDim.z chunks
  Dropout drop;  // kGwBiasReluDrop: over (row, column) of C
  int img_h = 0, img_w = 0;  // a gathered A's image, in cells (s2dconv_f32.cu)
};

// dW's row chunks over m rows: ceil(m / kGwChunkRows) of equal length
// rounded up to kGwK, the last one shorter (ops/ffn.py f32_dw_chunks)
inline int gw_dw_chunk(int m) {
  const int chunks = (m + kGwChunkRows - 1) / kGwChunkRows;
  return round_up((m + chunks - 1) / chunks, kGwK);
}

// keeps the compiler from moving register accesses across the wgmma
// fences and waits (no instruction)
template <int N>
__device__ __forceinline__ void gw_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void gw_fence_regs(uint32_t (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// d (+)= A B over the warpgroup: wgmma m64n128k8 .tf32, f32 sums.  A: this
// warp's 16 of the 64 rows x 8 k in registers as an mma.m16n8k8 tf32 A
// fragment (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)); B
// [128 n][8 k] K-major in shared memory through desc_b.  d holds this
// warp's 16 rows as 16 C fragments of 8 columns: d[4 j + e] at row g + 8 (e
// >> 1), column 8 j + 2 t + (e & 1).  scale_d 0 writes d afresh.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// one 8-deep step of d (+)= A B with split operands (split_p<P>): for
// k3xTF32 lo.hi, hi.lo, hi.hi; one pass otherwise.  scale_d 0 starts d
// afresh.
template <int P>
__device__ __forceinline__ void gw_step(float (&d)[64], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                        int scale_d) {
  if constexpr (P == k3xTF32) {
    wgmma_tf32_n128(d, al, bh, scale_d);
    wgmma_tf32_n128(d, ah, bl, 1);
    wgmma_tf32_n128(d, ah, bh, 1);
  } else {
    wgmma_tf32_n128(d, ah, bh, scale_d);
  }
}

// K-major tile [128 rows][32 k] (A as stored, B's planes), as one TMA box
// lands it with the 128-byte swizzle, wgmma's: the 16-byte chunk c of row r
// at r * 128 + (c ^ (r & 7)) * 16 (every tile starts 1024-byte aligned)
__device__ __forceinline__ uint32_t gw_kmajor_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// a tile of 32 rows of K x 128 (A transposed), as two TMA boxes of [32
// k][64] land it (a 4-d view of 32-float lines, 128-byte swizzled): element
// (k, i) in line 2 k + (i >> 5 & 1) of half i >> 6, its chunk (i & 31) >> 2
// XOR-ed with the line's low bits, so that a warp's fragment loads (i = g,
// k = t) hit 32 banks
__device__ __forceinline__ uint32_t gw_krows_off(int k, int i) {
  const int line = 2 * k + ((i >> 5) & 1);
  return (i >> 6) * (kGwTile / 2) + line * 128 + ((((i & 31) >> 2) ^ (line & 7)) << 4) +
         (i & 3) * 4;
}

// descriptor of 8-deep step s of a K-major [128][32] plane at `plane`
__device__ __forceinline__ uint64_t gw_desc(uint32_t plane, int s) {
  return wgmma_desc_sw128(plane + 32 * s, 16, 8 * 128);
}

// Which of a thread's A values of a slice lie inside A: those of its tile
// rows 16 warp + g (r0) and 16 warp + g + 8 (r1) whose k (0..31 in the
// slice) has its bit set in `k`.  The others are split as 0.
struct GwKeep {
  bool r0, r1;
  uint32_t k;
};

// An A policy tells gemm_wgmma_f32_kernel where A comes from:
//   k_range        the CTA's K range [kbeg, kend), narrowed where A B is
//                  known to vanish (a uniform decision of the CTA)
//   Rows           what a thread keeps about its rows and the slice's K,
//                  from rows(p, m0, kbeg)
//   row(r)         the row of A and C (in the tile) that the wgmma's tile
//                  row r holds: a permutation, so that fragment loads avoid
//                  bank conflicts
//   load           thread 0: the TMA loads of the slice at k0's A tile
//   off(r, k)      the byte offset of A (wgmma tile row r, k) in the tile
//   keep           the GwKeep of each slice in turn, k0 = kbeg, kbeg + 32,
//                  ... (every thread of the warp calls it; it may advance Rows)
//   map, ok        the host's TMA map of A, and whether p suits the policy
// GwAMatrix is A as a matrix: [M, K] as stored, or (AT) [K, M] read
// transposed in tiles of 32 rows x 128 as two boxes of [32 k][64] (a 4-d
// view of 32-float lines, gw_krows_off).
template <bool AT_>
struct GwAMatrix {
  static constexpr bool AT = AT_;
  struct Rows {};
  __device__ __forceinline__ static void k_range(const GemmWgF32&, int, int&, int&) {}
  __device__ __forceinline__ static Rows rows(const GemmWgF32&, int, int) { return {}; }
  __device__ __forceinline__ static int row(int r) { return r; }
  __device__ __forceinline__ static void load(const CUtensorMap* map, uint32_t dst,
                                              uint64_t* bar, const GemmWgF32&, int m0, int k0) {
    if (AT) {
      tma_load_4d(map, dst, bar, 0, m0 / 32, k0, 0);
      tma_load_4d(map, dst + kGwTile / 2, bar, 0, m0 / 32 + 2, k0, 0);
    } else {
      tma_load_2d(map, dst, bar, k0, m0);
    }
  }
  __device__ __forceinline__ static uint32_t off(int r, int k) {
    return AT ? gw_krows_off(k, r) : gw_kmajor_off(r, k >> 2) + (k & 3) * 4;
  }
  __device__ __forceinline__ static GwKeep keep(const GemmWgF32&, Rows&, int) {
    return {true, true, 0xffffffffu};
  }
  static bool map(CUtensorMap* amap, const GemmWgF32& p);
  static bool ok(const GemmWgF32& p) { return !AT || p.m % kGwM == 0; }
};

// thread 0: the TMA loads of the slice at k0 into the ring stage at `st`,
// completing `bar` by their bytes: A's tile (the policy's), B's hi and lo
// planes at (n0, k0); what lies outside the tensors loads zeros
template <class A>
__device__ __forceinline__ void gw_load(const CUtensorMap* amap, const CUtensorMap* bmap,
                                        const CUtensorMap* blmap, uint32_t st, uint64_t* bar,
                                        const GemmWgF32& p, int m0, int n0, int k0) {
  mbar_arrive_expect_tx(bar, 3 * kGwTile);
  A::load(amap, st + kGwOffA, bar, p, m0, k0);
  tma_load_2d(bmap, st + kGwOffBh, bar, k0, n0);
  tma_load_2d(blmap, st + kGwOffBl, bar, k0, n0);
}

// this warp's A fragments of the slice's four 8-deep steps, split: rows
// 16 warp + g (+ 8) of the CTA's tile, k 8 s + t (+ 4); values outside A
// (`keep`) as 0
template <int P, class A>
__device__ __forceinline__ void gw_a_frags(const unsigned char* sa, const GwKeep& keep,
                                           uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), t = lane & 3;
  auto val = [&](int rr, int k, bool row) {
    const float v = *reinterpret_cast<const float*>(sa + A::off(rr, k));
    return row && ((keep.k >> k) & 1u) ? v : 0.0f;
  };
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = 8 * s + t;
    split_p<P>(val(r, k, keep.r0), hi[s][0], lo[s][0]);
    split_p<P>(val(r + 8, k, keep.r1), hi[s][1], lo[s][1]);
    split_p<P>(val(r, k + 4, keep.r0), hi[s][2], lo[s][2]);
    split_p<P>(val(r + 8, k + 4, keep.r1), hi[s][3], lo[s][3]);
  }
}

template <int P, class A, int EPI>
__global__ void __launch_bounds__(kGwThreads, 1) gemm_wgmma_f32_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap blmap, const GemmWgF32 p) {
  extern __shared__ __align__(16) unsigned char gw_smem[];
  __shared__ uint64_t full[kGwStages];  // a stage's TMA loads have landed
  __shared__ float bias[kGwN];          // the tile's columns of the bias
  const uint32_t base = smem_u32(gw_smem);
  const uint32_t pad = ((base + 1023) & ~1023u) - base;
  const unsigned char* smem = gw_smem + pad;
  const uint32_t sbase = base + pad;
  const int ntiles = p.n / kGwN;
  const int m0 = (int)(blockIdx.x / ntiles) * kGwM, n0 = (int)(blockIdx.x % ntiles) * kGwN;
  int kbeg = blockIdx.z * p.kchunk, kend = min(p.k, kbeg + p.kchunk);
  A::k_range(p, n0, kbeg, kend);
  const int nk = kend > kbeg ? (kend - kbeg + kGwK - 1) / kGwK : 0;
  typename A::Rows rows = A::rows(p, m0, kbeg);
  // thread 0: slice kt's loads into stage kt % kGwStages
  auto load = [&](int kt) {
    if (kt < nk)
      gw_load<A>(&amap, &bmap, &blmap, sbase + (kt % kGwStages) * kGwStage,
                 &full[kt % kGwStages], p, m0, n0, kbeg + kt * kGwK);
  };
  // every thread: wait for slice kt, take its A fragments
  auto prepare = [&](int kt, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
    if (kt < nk) {
      const int stage = kt % kGwStages;
      const GwKeep keep = A::keep(p, rows, kbeg + kt * kGwK);
      mbar_wait(&full[stage], (kt / kGwStages) & 1);
      gw_a_frags<P, A>(smem + stage * kGwStage + kGwOffA, keep, ah, al);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGwStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  // read before the loop: in the epilogue every load of it would wait for
  // the stores to C before it (the two may alias)
  if (EPI != kGwStore && threadIdx.x < kGwN) bias[threadIdx.x] = p.bias[n0 + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGwStages - 1; ++s) load(s);
  }
  // the A fragments of two slices: the one whose products run and the next
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  prepare(0, ah0, al0);

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  // slice kt's products on its planes and fragments (ah, al); while they
  // run, slice kt + 1's fragments are taken into (nh, nl)
  auto slice = [&](int kt, uint32_t(&ah)[4][4], uint32_t(&al)[4][4], uint32_t(&nh)[4][4],
                   uint32_t(&nl)[4][4]) {
    const uint32_t st = sbase + (kt % kGwStages) * kGwStage;
    __syncthreads();  // every warp is done with slice kt - 1's stage
    if (threadIdx.x == 0) load(kt + kGwStages - 1);
    gw_fence_regs(ah);
    gw_fence_regs(al);
    gw_fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      gw_step<P>(part, ah[s], al[s], gw_desc(st + kGwOffBh, s), gw_desc(st + kGwOffBl, s),
                 s > 0 ? 1 : 0);
    wgmma_commit();
    prepare(kt + 1, nh, nl);
    wgmma_wait<0>();
    gw_fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  };
  for (int kt = 0; kt < nk; kt += 2) {
    slice(kt, ah0, al0, ah1, al1);
    if (kt + 1 < nk) slice(kt + 1, ah1, al1, ah0, al0);
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this thread's wgmma tile rows r0, r0 + 8
  float* c = p.c + blockIdx.z * p.c_zs;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    float b0 = 0.0f, b1 = 0.0f;
    if (EPI != kGwStore) {
      b0 = bias[8 * j + 2 * t];
      b1 = bias[8 * j + 2 * t + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + A::row(r0 + 8 * h);
      if (row >= p.m) continue;
      float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (EPI != kGwStore) {
        x0 += b0;
        x1 += b1;
      }
      if (EPI == kGwBiasReluDrop) {
        x0 = fmaxf(x0, 0.0f);
        x1 = fmaxf(x1, 0.0f);
        if (p.drop.thresh != 0u) {  // x * keep / (1 - rate) in f32, as the twin
          x0 = dropout_keep(p.drop, row, col) ? x0 * p.drop.scale : 0.0f;
          x1 = dropout_keep(p.drop, row, col + 1) ? x1 * p.drop.scale : 0.0f;
        }
      }
      *reinterpret_cast<float2*>(c + (long long)row * p.ldc + col) = make_float2(x0, x1);
    }
  }
}

// The TMA map of a row-major matrix (row stride ld floats) read in tiles of
// box_rows rows x 32 columns (K-major: `rows` x `cols` = M or N x K), or
// (krows: A transposed) in tiles of 32 rows x 128 columns as two boxes of 32
// x 64 (a 4-d view of 32-float lines); 128-byte swizzled, zeros outside the
// matrix
inline bool gw_map(CUtensorMap* map, const float* ptr, long long ld, int rows, int cols,
                   bool krows, int box_rows = kGwM) {
  const TensorMapEncodeFn enc = tensor_map_encode();
  if (enc == nullptr) return false;
  const cuuint64_t ldb = (cuuint64_t)ld * 4;
  if (krows) {
    const cuuint64_t dims[4] = {32, (cuuint64_t)cols / 32, (cuuint64_t)rows, 1};
    const cuuint64_t strides[3] = {128, ldb, ldb * rows};
    const cuuint32_t box[4] = {32, 2, 32, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), dims, strides,
               box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {ldb};
  const cuuint32_t box[2] = {kGwK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A: [M, K] as stored, or K rows of M
template <bool AT_>
bool GwAMatrix<AT_>::map(CUtensorMap* amap, const GemmWgF32& p) {
  return AT ? gw_map(amap, p.a, p.lda, p.k, p.m, true) : gw_map(amap, p.a, p.lda, p.m, p.k, false);
}

template <int P, class A, int EPI>
static cudaError_t launch_gemm_wgmma_f32_p(const GemmWgF32& p, int chunks,
                                           cudaStream_t stream) {
  auto kernel = gemm_wgmma_f32_kernel<P, A, EPI>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGwSmem);
  if (attr != cudaSuccess) return attr;
  // A's map from its policy; B's hi and lo planes [N, K]
  CUtensorMap amap, bmap, blmap;
  const bool ok = A::map(&amap, p) && gw_map(&bmap, p.b, p.ldb, p.n, p.k, false) &&
                  gw_map(&blmap, p.b + (long long)p.n * p.ldb, p.ldb, p.n, p.k, false);
  if (!ok) return cudaErrorInvalidValue;
  const long long tiles = (long long)(p.n / kGwN) * ((p.m + kGwM - 1) / kGwM);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, chunks);
  kernel<<<grid, kGwThreads, kGwSmem, stream>>>(amap, bmap, blmap, p);
  return cudaGetLastError();
}

// C = A B and the epilogue over gridDim.z = ceil(k / kchunk) chunks of K,
// A from policy A, B's planes split by gw_split_b_planes.  PRODUCT: which
// F32Product this is (tf32.cuh products_of).
template <class A, int EPI, int PRODUCT>
static cudaError_t gemm_wgmma_f32_a(const GemmWgF32& p, cudaStream_t stream) {
  // the TMA maps' rows 16-byte aligned
  if (p.m < 1 || p.n < kGwN || p.n % kGwN || p.k < 1 || p.kchunk < kGwK || p.kchunk % kGwK ||
      (p.lda | p.ldb) & 3 || p.ldc & 1 || !A::ok(p))
    return cudaErrorInvalidValue;
  const int chunks = (p.k + p.kchunk - 1) / p.kchunk;
  if (chunks > 65535) return cudaErrorInvalidValue;
  return launch_gemm_wgmma_f32_p<products_of(PRODUCT), A, EPI>(p, chunks, stream);
}

// C = A B with A a matrix: [M, K] as stored (AT false) or read transposed
// from [K, M] in 128-wide tiles (AT true)
template <bool AT, int EPI, int PRODUCT>
static cudaError_t gemm_wgmma_f32(const GemmWgF32& p, cudaStream_t stream) {
  return gemm_wgmma_f32_a<GwAMatrix<AT>, EPI, PRODUCT>(p, stream);
}

// row stride of a B operand's planes of K columns: 16-byte aligned rows
__host__ __device__ inline int gw_planes_ld(int k) { return round_up(k, 4); }

// A B operand's TF32 hi and lo planes [N][K] (row stride gw_planes_ld(K),
// the lo plane N rows after the hi plane; K-major, as gemm_wgmma_f32 takes
// B), split once per call from B [N][K] as stored (TRANS false: a
// torch Linear weight) or [K][N] (TRANS true: a weight read with its rows
// as K, or the batch's rows; through a 32 x 32 tile in shared memory).  N a
// multiple of 32, K any; a CTA per 32 x 32 block, grid (K / 32, N / 32).
template <int P, bool TRANS>
__global__ void __launch_bounds__(256) gw_split_b_kernel(const float* __restrict__ b,
                                                         float* __restrict__ hi, int n, int k) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const long long ldp = gw_planes_ld(k);
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = ty + 8 * j;
    if (TRANS) {  // B[k0 + r][n0 + tx]
      tile[r][tx] = k0 + r < k ? b[(long long)(k0 + r) * n + n0 + tx] : 0.0f;
    } else {  // B[n0 + r][k0 + tx]
      x[j] = k0 + tx < k ? b[(long long)(n0 + r) * k + k0 + tx] : 0.0f;
    }
  }
  if (TRANS) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = tile[tx][ty + 8 * j];  // B[k0 + tx][n0 + ty + 8 j]
  }
  if (k0 + tx >= k) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = (n0 + ty + 8 * j) * ldp + k0 + tx;
    uint32_t h, l;
    split_p<P>(x[j], h, l);
    hi[i] = __uint_as_float(h);
    hi[n * ldp + i] = __uint_as_float(l);
  }
}

// B split into its planes at `planes` (2 N gw_planes_ld(K) floats, work);
// PRODUCT: which F32Product B is an operand of
template <bool TRANS, int PRODUCT>
static cudaError_t gw_split_b_planes(const float* b, float* planes, int n, int k,
                                     cudaStream_t stream) {
  if (n % 32 || n / 32 > 65535 || k < 1) return cudaErrorInvalidValue;
  gw_split_b_kernel<products_of(PRODUCT), TRANS><<<dim3((k + 31) / 32, n / 32), 256, 0, stream>>>(
      b, planes, n, k);
  return cudaGetLastError();
}

// C = A W^T (TRANS false: W [N, K] as stored, a torch Linear weight) or A
// W (TRANS true: W [K, N]) and the epilogue, A [M, K] as stored; W split
// once into its hi and lo planes, `planes` (2 N K floats, work).  PRODUCT:
// which F32Product this is.
template <bool TRANS, int EPI, int PRODUCT>
static cudaError_t gw_weight_gemm(const float* a, long long lda, const float* w, float* planes,
                                  float* c, long long ldc, const float* bias, int m, int n, int k,
                                  Dropout drop, cudaStream_t stream) {
  cudaError_t err = gw_split_b_planes<TRANS, PRODUCT>(w, planes, n, k, stream);
  if (err != cudaSuccess) return err;
  // one chunk over all of K
  const GemmWgF32 p{a, planes, c, bias, lda, gw_planes_ld(k), ldc, 0, m, n, k, round_up(k, kGwK),
                    drop};
  return gemm_wgmma_f32<false, EPI, PRODUCT>(p, stream);
}

// The FFN's hidden h = drop(relu(x W1^T + b1)) [M, F], x [M, D] and W1
// [F, D] as stored, W1's planes in `planes` (2 F D floats): K4-f32's first
// product and K4b-f32's recompute (PRODUCT kProdHidden or kProdRecompute),
// the same kernels, so the two agree bit for bit.
template <int PRODUCT>
static cudaError_t ffn_hidden_f32(const float* x, const float* w1, const float* b1, float* h,
                                  float* planes, int m, int d, int f, Dropout drop,
                                  cudaStream_t stream) {
  return gw_weight_gemm<false, kGwBiasReluDrop, PRODUCT>(x, d, w1, planes, h, f, b1, m, f, d,
                                                         drop, stream);
}

}  // namespace crog
