// Building blocks of the backward kernels, of K4 and of K2/K3's projections:
// a wgmma GEMM mainloop (a CTA tile of 128 rows, A row-major or transposed,
// B row-major or K-major, fed by a cp.async ring), the C fragments out as
// 16-byte bf16 row segments, row sums across a thread-block cluster, the
// input-gradient GEMM of the decoder blocks (several products rounded one
// by one and summed in f32 registers), the weight-gradient (A^T B) row
// reduction in two deterministic passes, and the fixed-order sum of
// per-block partial rows.
//
// The TPU kernels accumulate dW and the bias / LayerNorm column sums across
// their sequential grid in VMEM.  Hopper blocks run in parallel and in no
// order, so every sum over rows here is a first pass that writes one
// partial row (or [N, K] tile) per row chunk, and a second pass that adds
// the partials in index order: the same gradient in every run, no atomics.
//
// The mainloop (K4's and K4b's products, the decoder blocks' projections,
// dX and dW): four warpgroups, 2 (rows) x 2 (columns) of [64, WN] f32
// accumulator tiles in registers, wgmma m64nWNk16 with A from registers
// (ldmatrix, or ldmatrix.trans for a transposed A) and B from shared memory
// through a descriptor, in 128-byte swizzled [KC][64] blocks (B row-major
// [K, N]) or as [2 WN][64] rows of 64 k (BK: B K-major [N, K], a torch
// Linear weight as it is, wgmma's native B layout); KC-deep chunks through a
// 4-stage cp.async ring, one barrier per chunk, loads two chunks ahead, each
// group of two k16 products in flight while the next group's fragments
// load.  KC is 32 in the FFN cluster kernels, whose ring sits beside the
// hidden, and 64 in the stand-alone GEMMs: half the barriers per product,
// which took K4's y GEMM from 0.092 to 0.079 ms on an H100 (an 8-stage ring
// of 32-deep chunks, twice the loads in flight, gained 3%; one CTA per SM
// walking several tiles, so that a tile's epilogue overlaps the next one's
// loads, lost 20-30%, ptxas serializing its products for want of
// registers: PERF.md section 6).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace crog {

constexpr int kGM = 128;            // rows of a CTA tile
constexpr int kGK = 32;             // k of one group of products (two wgmma k16)
constexpr int kGS = 4;              // ring stages
constexpr int kGThreads = 512;      // 4 warpgroups: 2 (rows) x 2 (columns)
constexpr int kGTLd = kGM + 8;      // transposed A chunk [KC][136] (conflict-free .trans)
constexpr int kGKDeep = 64;         // k per ring stage of the stand-alone GEMM kernels

// A ring of kGS stages of KC rows of the reduction, each the A chunk, then
// the B chunk's [KC][64] blocks (or, BK, its [2 WN] rows of 64 k), at
// 1024-byte aligned offsets (the 128-byte swizzle repeats every 8 rows).
template <int WN, bool TA, int KC, bool BK = false>
struct GemmRing {
  static constexpr int kN = 2 * WN;                // CTA tile columns
  static constexpr int kNT = WN / 8;               // 8-column C fragments per warp
  static constexpr int kALd = TA ? kGTLd : KC + 8;  // A chunk row stride (conflict-free)
  static constexpr int kAStage = round_up((TA ? KC : kGM) * kALd * 2, 1024);
  static constexpr int kBlock = KC * 128;          // one swizzled [KC][64] bf16 B block
  static constexpr int kStage = kAStage + (kN / 64) * kBlock;  // BK: kN rows of 128 bytes
  static constexpr size_t kBytes = (size_t)kGS * kStage;
  static constexpr size_t kSmem = 1024 + kBytes;  // + the alignment slack
  static_assert(WN == 64 || WN == 128, "wgmma widths of the mainloop");
  static_assert(KC == 32 || KC == 64, "ring stage depths of the mainloop");
  static_assert(!BK || (KC == 64 && !TA), "a K-major B takes 64-deep stages and a row-major A");
};

// the ring at the first 1024-byte boundary of the dynamic shared memory
__device__ __forceinline__ unsigned char* gemm_smem_base() {
  extern __shared__ unsigned char gemm_smem_raw[];
  return gemm_smem_raw + ((1024 - (smem_u32(gemm_smem_raw) & 1023)) & 1023);
}

template <int NT>
__device__ __forceinline__ void gemm_zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
}

// v summed over the quad's four threads (one row's columns), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v summed over the warp's eight row groups (one column's rows)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

struct NoChunkHook {
  __device__ void operator()(int, const bf16*, const uint32_t (&)[2][4]) const {}
};

// acc += this warp's 16 rows of its warpgroup's 64 (warpgroup / 2) and the
// warpgroup's WN columns (warpgroup % 2) of a CTA's [128, 2 WN] tile, as
// mma.m16n8k16 C fragments.  B [*, N] row-major (ldb), the tile's columns
// n0 .. (BK: B [N, *] K-major, its rows n0 .. n0 + 2 WN - 1, all inside B);
// the sum runs over the KC-row chunks of B's rows [k0, k1) (BK: columns):
//   TA false: A [M, *] row-major (lda), the tile's rows m0 .. (rows >= M
//     read as zeros); B's row k meets A's column k (k1 - k0 a multiple of KC).
//   TA true: the transposed A, whose tile rows are A's columns m0 ..
//     m0 + 127 (all inside A); B's row k meets A's row k, and rows >= k1
//     of both read as zeros.
// Each chunk runs as KC / 32 groups of two wgmma k16 steps, a group's A
// fragments in their own registers; hook(g, A chunk, A fragments) runs once
// group g's fragments are loaded (group g covers rows k0 + 32 g ..).
template <int WN, bool TA, int KC, bool BK = false, typename Hook>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[WN / 8][4], const bf16* __restrict__ A,
                                              long long lda, int m0, int M,
                                              const bf16* __restrict__ B, long long ldb, int n0,
                                              int k0, int k1, unsigned char* ring,
                                              const Hook& hook) {
  using R = GemmRing<WN, TA, KC, BK>;
  constexpr int kG = KC / kGK;     // groups per chunk
  constexpr int kSpr = R::kN / 8;  // 16-byte B segments per row
  constexpr int kAspr = KC / 8;    // 16-byte A segments per row (TA false)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wrow = (wg >> 1) * 64 + ((tid >> 5) & 3) * 16;  // this warp's 16 tile rows
  const int nch = (k1 - k0 + KC - 1) / KC;
  auto load = [&](int c) {
    unsigned char* st = ring + (c % kGS) * R::kStage;
    const int kc = k0 + c * KC;
#pragma unroll
    for (int i = 0; i < KC / 32; ++i) {  // the A chunk: KC / 32 segments per thread
      const int v = tid + i * kGThreads;
      if (TA) {  // [KC rows][128 columns] of A
        const int r = v >> 4, cs = (v & 15) * 8;
        const bool ok = kc + r < k1;
        cp_async16(smem_u32(st) + (r * R::kALd + cs) * 2,
                   ok ? A + (long long)(kc + r) * lda + m0 + cs : A, ok ? 16 : 0);
      } else {  // [128 rows][KC columns] of A
        const int r = v / kAspr, cs = (v % kAspr) * 8;
        const bool ok = m0 + r < M;
        cp_async16(smem_u32(st) + (r * R::kALd + cs) * 2,
                   ok ? A + (long long)(m0 + r) * lda + kc + cs : A, ok ? 16 : 0);
      }
    }
    if constexpr (BK) {
#pragma unroll
      for (int i = 0; i < R::kN * 8 / kGThreads; ++i) {  // [2 WN rows][64 k] of B
        const int v = tid + i * kGThreads;
        const int n = v >> 3, cs = v & 7;
        cp_async16(smem_u32(st + R::kAStage + n * 128 + ((cs ^ (n & 7)) << 4)),
                   B + (long long)(n0 + n) * ldb + kc + cs * 8, 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < KC * kSpr / kGThreads; ++i) {  // [KC rows][2 WN columns] of B
        const int v = tid + i * kGThreads;
        const int k = v / kSpr, cs = v % kSpr;
        const bool ok = !TA || kc + k < k1;
        const uint32_t dst = smem_u32(st + R::kAStage + (cs >> 3) * R::kBlock + k * 128 +
                                      (((cs & 7) ^ (k & 7)) << 4));
        cp_async16(dst, ok ? B + (long long)(kc + k) * ldb + n0 + cs * 8 : B, ok ? 16 : 0);
      }
    }
  };
  // a group's products stay in flight while the next group loads its A
  // fragments, so the stage refilled at chunk c is chunk c - 2's and the
  // loads run kGS - 2 chunks ahead
  constexpr int kAhead = kGS - 2;
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }
  float(&d)[WN / 2] = reinterpret_cast<float(&)[WN / 2]>(acc);
  auto step = [&](int c, uint32_t(&a)[kG][2][4]) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 2's products are done
    if (c + kAhead < nch) load(c + kAhead);
    cp_async_commit();
    const unsigned char* st = ring + (c % kGS) * R::kStage;
    const bf16* as = reinterpret_cast<const bf16*>(st);
    // the warpgroup's WN columns of B: WN / 64 blocks (BK, KC 64: the same
    // bytes, WN rows of 128)
    const uint32_t b0 = smem_u32(st + R::kAStage) + (wg & 1) * (WN / 64) * R::kBlock;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        const int kr = g * kGK + k16 * 16;  // the k16 step's first row in the chunk
        if (TA)  // A^T [16 tile rows, 16 k] from the [k][row] chunk
          ldsm_x4_t(smem_u32(as + (kr + (lane & 7) + ((lane >> 4) & 1) * 8) * R::kALd +
                             wrow + ((lane >> 3) & 1) * 8),
                    a[g][k16]);
        else
          ldsm_x4(smem_u32(as + (wrow + (lane & 15)) * R::kALd + kr + (lane >> 4) * 8),
                  a[g][k16]);
      }
      hook(c * kG + g, as, a[g]);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 2; ++k16) {
        const int kr = g * kGK + k16 * 16;
        // row-major B: the k16 step's rows, 64-column blocks kBlock apart;
        // K-major B: its 32 bytes of every row (the swizzle's 8-row groups
        // 1024 bytes apart; no second stride within a 128-byte row)
        const uint64_t desc = BK ? wgmma_desc_sw128(b0 + kr * 2, 16, 8 * 128)
                                 : wgmma_desc_sw128(b0 + kr * 128, R::kBlock, 8 * 128);
        if constexpr (WN == 128)
          wgmma_m64n128k16_rs<BK ? 0 : 1>(d, a[g][k16], desc);
        else
          wgmma_m64n64k16_rs<BK ? 0 : 1>(d, a[g][k16], desc);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before is done: its A registers are free
    }
  };
  // A fragments: one set per group of a chunk; one chunk has a single group
  // (KC 32), so sets alternate between even and odd chunks
  uint32_t a0[kG][2][4], a1[kG][2][4];
  int c = 0;
#pragma unroll 1
  for (; c + 1 < nch; c += 2) {
    step(c, a0);
    if constexpr (kG == 1)
      step(c + 1, a1);
    else
      step(c + 1, a0);
  }
  if (c < nch) step(c, a0);  // an odd count's last chunk (not a branch
                             // inside the loop: ptxas would then see a0
                             // rewritten under a pending wgmma and
                             // serialize every product)
  wgmma_wait_all();
  __syncthreads();  // every warp is done with the ring
}

// This thread's first row of C fragments in its CTA's [128, 2 WN] tile (the
// second is 8 below) and its first column in its warpgroup's WN columns:
// element e of fragment nt lies at row frag_row() + 8 (e / 2), column
// (warpgroup % 2) WN + 8 nt + frag_col() + e % 2.
__device__ __forceinline__ int frag_row() {
  const int t = threadIdx.x;
  return (((t >> 7) >> 1) * 4 + ((t >> 5) & 3)) * 16 + ((t & 31) >> 2);
}

__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }

// pair(nt, hf), this thread's C fragment elements (nt, 2 hf) and (nt, 2 hf +
// 1) of its warpgroup's NT fragments as a packed bf16 pair, out to C in
// 16-byte row segments: C points at the warpgroup's first column, row0 is
// the global row of frag_row(), and rows >= M are not written.  Per pair of
// fragments the quad holds four 16-byte row segments (rows g, g + 8 of
// each); quad_gather16 gives each thread one.
template <int NT, typename Pair>
__device__ __forceinline__ void store_pairs_bf16(const Pair& pair, bf16* __restrict__ C,
                                                 long long ldc, int row0, int M) {
  const int qd = threadIdx.x & 3;
  const int row = row0 + 8 * (qd & 1);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    const uint32_t v[4] = {pair(j, 0), pair(j, 1), pair(j + 1, 0), pair(j + 1, 1)};
    const uint4 seg = quad_gather16(v);
    if (row < M) *reinterpret_cast<uint4*>(C + (long long)row * ldc + (j + (qd >> 1)) * 8) = seg;
  }
}

// the same from value(nt, e), each element rounded once to bf16 (nearest even)
template <int NT, typename Value>
__device__ __forceinline__ void store_frags_bf16(const Value& value, bf16* __restrict__ C,
                                                 long long ldc, int row0, int M) {
  store_pairs_bf16<NT>(
      [&](int nt, int hf) { return pack_bf16(value(nt, 2 * hf), value(nt, 2 * hf + 1)); }, C,
      ldc, row0, M);
}

// Row sums across a cluster of `cl` CTAs that each own a column slice of the
// same kGM rows: this CTA's two per-row partials (over its columns) from the
// two column warpgroups' partials in `red` ([warpgroup % 2][row][2]),
// published in `xch` ([2][row]); after the cluster barrier every CTA adds
// the cl CTAs' in rank order (from 0.0f, so the sum is the same at any
// cl).  Threads < kGM return the totals of row threadIdx.x.
__device__ __forceinline__ float2 cluster_row_sums(const float* red, float* xch, int cl) {
  const int t = threadIdx.x;
  if (t < kGM) {
    xch[t] = red[t * 2] + red[(kGM + t) * 2];
    xch[kGM + t] = red[t * 2 + 1] + red[(kGM + t) * 2 + 1];
  }
  cluster_arrive();
  cluster_wait();
  float2 tot = make_float2(0.0f, 0.0f);
  if (t < kGM) {
#pragma unroll 4
    for (int r = 0; r < cl; ++r) {
      tot.x += ld_dsmem_f32(xch + t, r);
      tot.y += ld_dsmem_f32(xch + kGM + t, r);
    }
  }
  return tot;
}

// ------------------------------------------------------------- gemm_tile
// C = sum over p < NP of bf16(A_p B_p), as the TPU kernels' `_dense_t`
// (dX = dY W for a torch-layout weight W [out, in]) sums input gradients:
// each product in f32, rounded to bf16, the rounded products added in f32
// in order p = 0, 1, ...; then C = bf16(that sum) or, with F32OUT, the f32
// sum itself.  One product (NP = 1) may add an f32 bias row before its one
// rounding (K4's y = bf16(hn W2^T + b2)).  A_p [M, K] (lda), B_p [K, N]
// row-major (ldb), K % 64 == 0, N a multiple of the tile's 2 WN columns,
// lda, ldb, ldc % 8 == 0; a [128, 2 WN] tile per CTA (blockIdx.x columns,
// blockIdx.y rows).  The rounded products' sum stays in registers beside
// the accumulators: no f32 round trip through device memory per product.
struct GemmArgs {
  const bf16* a[3];
  const bf16* b[3];
  const float* bias;  // [N] f32 (NP = 1 only) or null
  bf16* cb;           // the bf16 output, or
  float* cf;          // the f32 output (F32OUT)
  int lda, ldb, ldc, M, K;
};

template <int WN, int NP, bool F32OUT>
__device__ __forceinline__ void gemm_tile(const GemmArgs& g) {
  static_assert(NP >= 1 && NP <= 3, "one to three products");
  constexpr int NT = WN / 8;
  unsigned char* ring = gemm_smem_base();
  const int m0 = blockIdx.y * kGM;
  const int n0 = blockIdx.x * 2 * WN;
  float acc[NT][4], sum[NT][4];
#pragma unroll 1
  for (int p = 0; p < NP; ++p) {
    const bf16* A = p == 0 ? g.a[0] : p == 1 ? g.a[1] : g.a[2];
    const bf16* B = p == 0 ? g.b[0] : p == 1 ? g.b[1] : g.b[2];
    gemm_zero(acc);
    gemm_mainloop<WN, false, kGKDeep>(acc, A, g.lda, m0, g.M, B, g.ldb, n0, 0, g.K,
                                               ring, NoChunkHook());
    if constexpr (NP > 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float r = bf2f(f2bf(acc[nt][e]));
          sum[nt][e] = p == 0 ? r : sum[nt][e] + r;
        }
    }
  }
  const int row0 = m0 + frag_row();
  const int cbase = n0 + ((threadIdx.x >> 7) & 1) * WN;  // the warpgroup's columns
  const int col0 = cbase + frag_col();
  // the value of fragment element (nt, e): rows row0 + 8 (e / 2), column
  // col0 + 8 nt + e % 2
  auto value = [&](int nt, int e) -> float {
    if constexpr (NP > 1) return sum[nt][e];
    float v = acc[nt][e];
    if (!F32OUT && g.bias) v += g.bias[col0 + nt * 8 + (e & 1)];
    return F32OUT ? bf2f(f2bf(v)) : v;
  };
  if (F32OUT) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        if (row < g.M)
          *reinterpret_cast<float2*>(g.cf + (long long)row * g.ldc + col0 + nt * 8) =
              make_float2(value(nt, 2 * hf), value(nt, 2 * hf + 1));
      }
  } else {
    store_frags_bf16<NT>(value, g.cb + cbase, g.ldc, row0, g.M);
  }
}

// The decoder blocks' dO and dX GEMMs: [128, 128] tiles (WN 64 keeps the
// rounded products' f32 sum in registers beside the accumulators).
template <int NP, bool F32OUT>
__global__ void __launch_bounds__(kGThreads, 1) gemm_nn_kernel(GemmArgs g) {
  gemm_tile<64, NP, F32OUT>(g);
}

// the kernel's dynamic shared memory limit, set once per library and card
template <int NP, bool F32OUT>
static cudaError_t gemm_nn_smem_once() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_nn_kernel<NP, F32OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GemmRing<64, false, kGKDeep>::kSmem);
  return attr;
}

// C [M, N] = gemm_tile's sum of NP products (see GemmArgs), N % 128 == 0
template <int NP, bool F32OUT>
static cudaError_t launch_gemm_nn(const GemmArgs& g, int N, cudaStream_t st) {
  if (N % 128 || g.K % kGKDeep || g.K < kGKDeep || g.lda % 8 || g.ldb % 8 || g.ldc % 8 || g.M < 1)
    return cudaErrorInvalidValue;
  const cudaError_t err = gemm_nn_smem_once<NP, F32OUT>();
  if (err != cudaSuccess) return err;
  gemm_nn_kernel<NP, F32OUT><<<dim3(N / 128, (g.M + kGM - 1) / kGM), kGThreads,
                               GemmRing<64, false, kGKDeep>::kSmem, st>>>(g);
  return cudaGetLastError();
}

// -------------------------------------------------------------- wgrad
// First pass of dW = A^T B over M rows: part[s, n, k] = sum over row chunk s
// of A[m, n] B[m, k], for A [M, N] (lda), B [M, K] (ldb), N % 128 == 0,
// K % 256 == 0; chunk s holds rows [s chunk, (s + 1) chunk) below M (empty
// past M: its partial is zeros).  A CTA takes a [128, 256] tile of one
// chunk: A^T from the [64 rows][128 columns] A chunks by ldmatrix.trans,
// B's chunks as wgmma's N-major operand.  With `cpart` set, the CTAs of the
// first k tile also write the chunk's column sums of A, cpart[s, n] (a bias
// gradient, sum_m dY[m, n]), from the A fragments as they pass: each
// thread's values in chunk order, then its quad in a fixed order.
using WgradRing = GemmRing<128, true, kGKDeep>;

__global__ void __launch_bounds__(kGThreads, 1) wgrad_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    float* __restrict__ part, float* __restrict__ cpart, int M, int N, int K, int chunk) {
  unsigned char* ring = gemm_smem_base();
  const int k0 = blockIdx.x * WgradRing::kN;
  const int n0 = blockIdx.y * kGM;
  const int s = blockIdx.z;
  const int r0 = min(M, s * chunk);
  const int r1 = min(M, r0 + chunk);
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int qd = lane & 3;
  const bool colsum = cpart != nullptr && blockIdx.x == 0 && (wg & 1) == 0;
  float acc[WgradRing::kNT][4];
  gemm_zero(acc);
  float cs[2] = {0.0f, 0.0f};  // column sums of A at this thread's rows g, g + 8
  gemm_mainloop<128, true, kGKDeep>(acc, A, lda, n0, N, B, ldb, k0, r0, r1, ring,
                           [&](int, const bf16*, const uint32_t (&a)[2][4]) {
                             if (!colsum) return;
#pragma unroll
                             for (int k16 = 0; k16 < 2; ++k16) {
                               const float2 v0 = unpack_bf16(a[k16][0]);
                               const float2 v1 = unpack_bf16(a[k16][1]);
                               const float2 v2 = unpack_bf16(a[k16][2]);
                               const float2 v3 = unpack_bf16(a[k16][3]);
                               cs[0] += v0.x + v0.y + v2.x + v2.y;
                               cs[1] += v1.x + v1.y + v3.x + v3.y;
                             }
                           });
  const int row0 = n0 + ((wg >> 1) * 4 + ((threadIdx.x >> 5) & 3)) * 16 + (lane >> 2);
  const int col0 = k0 + (wg & 1) * 128 + 2 * qd;
  float* out = part + (long long)s * N * K;
#pragma unroll
  for (int nt = 0; nt < WgradRing::kNT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(out + (long long)(row0 + 8 * hf) * K + col0 + nt * 8) =
          make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  if (colsum) {
    const float t0 = quad_sum(cs[0]), t1 = quad_sum(cs[1]);
    if (qd == 0) {
      cpart[(long long)s * N + row0] = t0;
      cpart[(long long)s * N + row0 + 8] = t1;
    }
  }
}

// Second pass: out[i] = sum_{p < P} part[p * stride + i] for i < n, in p
// order, to f32 (outf) or bf16 (outb).
__global__ void __launch_bounds__(256) reduce_rows_kernel(
    const float* __restrict__ part, int P, long long stride, long long n,
    float* outf, bf16* outb) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += part[p * stride + i];
  if (outf) outf[i] = s;
  if (outb) outb[i] = f2bf(s);
}

inline cudaError_t launch_reduce(const float* part, int P, long long stride, long long n,
                                 float* outf, bf16* outb, cudaStream_t st) {
  reduce_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, P, stride, n,
                                                                  outf, outb);
  return cudaGetLastError();
}

static cudaError_t wgrad_smem_once() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WgradRing::kSmem);
  return attr;
}

// dW [N, K] bf16 (and optionally the column sums of A, f32 [N]) over M rows
// in `splits` chunks of a multiple of 32 rows; part [splits, N, K] and
// cpart [splits, N] f32 scratch.
static cudaError_t launch_wgrad(const bf16* A, int lda, const bf16* B, int ldb, bf16* dw,
                                float* dcol, float* part, float* cpart, int M, int N, int K,
                                int splits, cudaStream_t st) {
  if (N % kGM || K % WgradRing::kN || lda % 8 || ldb % 8 || splits < 1 || M < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = wgrad_smem_once();
  if (err != cudaSuccess) return err;
  const int chunk = round_up((M + splits - 1) / splits, kGK);
  wgrad_kernel<<<dim3(K / WgradRing::kN, N / kGM, splits), kGThreads, WgradRing::kSmem, st>>>(
      A, lda, B, ldb, part, dcol ? cpart : nullptr, M, N, K, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce(part, splits, (long long)N * K, (long long)N * K, nullptr, dw, st);
  if (err != cudaSuccess || !dcol) return err;
  return launch_reduce(cpart, splits, N, N, dcol, nullptr, st);
}

}  // namespace crog
