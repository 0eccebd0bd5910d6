// The fp32 backward kernels' products and sums: C = A B with B read [K, N]
// as stored (the input gradient dY W of a torch-layout weight W [out, in],
// whose rows are the K index), either with A [M, K] as stored (dX) or with
// A read transposed from a [K, M] matrix (dW = dY^T X, K the rows of the
// batch), split over K in fixed chunks; a fixed-order sum of such partials;
// fixed-order column sums over rows; and the LayerNorm backward of a row
// block.  The GEMM (kn_mainloop, gemm_kn_f32_kernel) is K2b-f32's and
// K3b-f32's (decoder_blocks_bwd_f32.cu); the fixed-order sums and the
// LayerNorm rows also serve K4b-f32 (ffn_bwd_f32.cu), and reduce_parts
// K6b-f32 (s2dconv_f32.cu), whose products, like K4-f32's and K4b-f32's,
// run on gemm_wgmma_f32.cuh.
//
// Every product is mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32.cuh)
// and each 32-deep K slice accumulates into fresh registers that an IEEE
// f32 add joins to the running sum, as gemm_wgmma_f32.cuh does: the tensor cores'
// truncating accumulation then sees 12 additions, not one per 8 of K (a dW
// sums over 16224 rows).  A split writes its partial [M, N]; the partials
// are summed in split order by `reduce_parts_kernel`, and a column sum adds
// its rows in order within fixed row blocks, then the blocks in order: two
// calls give the same bits.
//
// Design: right and simple first.  A CTA of 8 warps computes a 128 x 128
// tile (a 64 x 32 block per warp) over 32-deep K slices that a two-stage
// cp.async ring brings into shared memory; A's tile is held [128 m][36]
// when stored [M, K] and [32 k][136] when read transposed, B's [32 k][136]:
// every fragment load is free of bank conflicts (row strides of 4 and 8
// mod 32 words).  Rows of A past M, columns past N and K past the split's
// end load zeros; C past M or N is not stored.
#pragma once

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace crog {

constexpr int kGKM = 128, kGKN = 128, kGKK = 32;
constexpr int kGKLdRow = kGKK + 4;    // A held [m][k]
constexpr int kGKLdCol = kGKM + 8;    // A held [k][m], B held [k][n]
constexpr int kGKThreads = 256;
constexpr int kGKATile = kGKM * kGKLdRow;  // >= kGKK * kGKLdCol
constexpr int kGKStage = kGKATile + kGKK * kGKLdCol;

struct GemmKN {
  const float* a;  // ATRANS false: A[m][k] at a + m lda + k; true: at a + k lda + m
  const float* b;  // B[k][n] at b + k ldb + n
  float* c;        // C[m][n] of split z at c + z c_zs + m ldc + n
  long long lda, ldb, ldc, c_zs;
  int m, n, k;
  int kchunk;  // K rows per split, a multiple of kGKK; gridDim.z splits
};

inline size_t gemm_kn_smem_bytes() { return 2u * kGKStage * sizeof(float); }

// acc += A B over one kGKK-deep slice held in shared memory (A's tile at
// `as`, [m][kGKLdRow] or, ATRANS, [k][kGKLdCol]; B's at `bs`, [k][kGKLdCol]),
// for the warp's 64 x 32 block at (wm, wn): the slice's products sum in
// fresh registers that one f32 add then joins to acc.
template <int P, bool ATRANS>
__device__ __forceinline__ void kn_slice_products(const float* as, const float* bs, int wm,
                                                  int wn, float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float part[4][4][4];  // this K slice's products
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kGKK; kk += 8) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + 16 * i + g;
      if (ATRANS) {
        const float* ar = as + (kk + t) * kGKLdCol + r;
        split_p<P>(ar[0], ah[i][0], al[i][0]);                     // (g, t)
        split_p<P>(ar[8], ah[i][1], al[i][1]);                     // (g + 8, t)
        split_p<P>(ar[4 * kGKLdCol], ah[i][2], al[i][2]);          // (g, t + 4)
        split_p<P>(ar[4 * kGKLdCol + 8], ah[i][3], al[i][3]);      // (g + 8, t + 4)
      } else {
        const float* ar = as + r * kGKLdRow + kk + t;
        split_p<P>(ar[0], ah[i][0], al[i][0]);
        split_p<P>(ar[8 * kGKLdRow], ah[i][1], al[i][1]);
        split_p<P>(ar[4], ah[i][2], al[i][2]);
        split_p<P>(ar[8 * kGKLdRow + 4], ah[i][3], al[i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* br = bs + (kk + t) * kGKLdCol + wn + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_p<P>(br[0], bh0, bl0);              // (k t, n g)
      split_p<P>(br[4 * kGKLdCol], bh1, bl1);   // (k t + 4, n g)
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_p<P>(part[i][j], ah[i], al[i], bh0, bl0, bh1, bl1);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// C[m0 + wm + .., n0 + wn + ..] = the warp's acc, rows past m and columns
// past n not stored (n even)
__device__ __forceinline__ void store_kn_block(float* c, long long ldc, int m, int n, int row0,
                                               int col0, const float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    if (col >= n) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 16 * i + g + 8 * hr;
        if (row >= m) continue;
        *reinterpret_cast<float2*>(c + (long long)row * ldc + col) =
            make_float2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
      }
  }
}

// acc = A B over `nk` kGKK-deep K slices from k0, for the warp's 64 x 32
// block of the tile: `load(k, stage)` issues and commits the cp.async
// copies of the slice at k into ring stage `stage` (of two at smem,
// kGKStage floats each), one slice in flight while the other's products
// run.
template <int P, bool ATRANS, class Load>
__device__ __forceinline__ void kn_mainloop(const float* smem, int k0, int nk, Load&& load,
                                            float (&acc)[4][4][4]) {
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  if (nk > 0) load(k0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load(k0 + (kt + 1) * kGKK, (kt + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* as = smem + (kt & 1) * kGKStage;
    kn_slice_products<P, ATRANS>(as, as + kGKATile, wm, wn, acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

template <int P, bool ATRANS>
__global__ void __launch_bounds__(kGKThreads) gemm_kn_f32_kernel(const GemmKN p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kGKM, n0 = blockIdx.x * kGKN;
  const int kbeg = blockIdx.z * p.kchunk;
  const int kend = min(p.k, kbeg + p.kchunk);

  auto load = [&](int k0, int stage) {
    float* as = smem + stage * kGKStage;
    float* bs = as + kGKATile;
    for (int i = threadIdx.x; i < kGKM * kGKK / 4; i += kGKThreads) {
      if (ATRANS) {  // 32 k rows of 128 m
        const int r = i >> 5, c = (i & 31) * 4;
        const bool in = k0 + r < kend && m0 + c < p.m;
        cp_async16(smem_u32(as + r * kGKLdCol + c),
                   in ? p.a + (long long)(k0 + r) * p.lda + m0 + c : p.a, in ? 16 : 0);
      } else {  // 128 m rows of 32 k
        const int r = i >> 3, c = (i & 7) * 4;
        const bool in = m0 + r < p.m && k0 + c < kend;
        cp_async16(smem_u32(as + r * kGKLdRow + c),
                   in ? p.a + (long long)(m0 + r) * p.lda + k0 + c : p.a, in ? 16 : 0);
      }
      const int r = i >> 5, c = (i & 31) * 4;  // 32 k rows of 128 n
      const bool in = k0 + r < kend && n0 + c < p.n;
      cp_async16(smem_u32(bs + r * kGKLdCol + c),
                 in ? p.b + (long long)(k0 + r) * p.ldb + n0 + c : p.b, in ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
  kn_mainloop<P, ATRANS>(smem, kbeg, kend > kbeg ? (kend - kbeg + kGKK - 1) / kGKK : 0, load,
                         acc);
  store_kn_block(p.c + blockIdx.z * p.c_zs, p.ldc, p.m, p.n, m0 + wm, n0 + wn, acc);
}

template <int P, bool ATRANS>
static cudaError_t launch_gemm_kn_p(const GemmKN& p, int splits, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_kn_f32_kernel<P, ATRANS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gemm_kn_smem_bytes());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.n + kGKN - 1) / kGKN, (p.m + kGKM - 1) / kGKM, splits);
  gemm_kn_f32_kernel<P, ATRANS><<<grid, kGKThreads, gemm_kn_smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}

// C[M, N] = A[M, K] B[K, N], all row-major (B a torch-layout weight read
// with its rows as K).  PRODUCT: which F32Product this is.
template <int PRODUCT>
static cudaError_t gemm_nn_f32(const float* a, long long lda, const float* b, long long ldb,
                               float* c, long long ldc, int m, int n, int k,
                               cudaStream_t stream) {
  if (m < 1 || n < 2 || n % 4 || k < 1 || k % 4 || (lda | ldb) & 3 || ldc & 1)
    return cudaErrorInvalidValue;
  GemmKN p{a, b, c, lda, ldb, ldc, 0, m, n, k, round_up(k, kGKK)};
  return launch_gemm_kn_p<products_of(PRODUCT), false>(p, 1, stream);
}

// Number of splits `gemm_tn_f32` makes of K rows asked to split `splits`
// ways: chunks of a multiple of kGKK rows, the last one shorter.
inline int tn_chunk(int k, int splits) { return round_up((k + splits - 1) / splits, kGKK); }
inline int tn_splits(int k, int splits) {
  const int c = tn_chunk(k, splits);
  return (k + c - 1) / c;
}

// Fixed-order sum of `parts` partials of `n` floats, `stride` apart:
// out[i] = ((part[0][i] + part[1][i]) + ...) in partial order.
__global__ void __launch_bounds__(256) reduce_parts_kernel(const float* __restrict__ part,
                                                           int parts, long long stride,
                                                           long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += part[p * stride + i];
  out[i] = s;
}

static cudaError_t reduce_parts(const float* part, int parts, long long stride, long long n,
                                float* out, cudaStream_t stream) {
  reduce_parts_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, parts, stride, n,
                                                                      out);
  return cudaGetLastError();
}

// dW[M, N] = A^T B summed over K rows, A [K, M] and B [K, N] row-major,
// in tn_splits(k, splits) row chunks of tn_chunk(k, splits) rows each:
// part [splits, M, N] (work), then their fixed-order sum into dw (row
// stride ldw).
template <int PRODUCT>
static cudaError_t gemm_tn_f32(const float* a, long long lda, const float* b, long long ldb,
                               float* dw, long long ldw, float* part, int m, int n, int k,
                               int splits, cudaStream_t stream) {
  if (m < 4 || m % 4 || n < 4 || n % 4 || k < 1 || splits < 1 || (lda | ldb) & 3 ||
      ldw != n)
    return cudaErrorInvalidValue;
  const long long mn = (long long)m * n;
  GemmKN p{a, b, part, lda, ldb, n, mn, m, n, k, tn_chunk(k, splits)};
  const int z = tn_splits(k, splits);
  cudaError_t err = launch_gemm_kn_p<products_of(PRODUCT), true>(p, z, stream);
  if (err != cudaSuccess) return err;
  return reduce_parts(part, z, mn, mn, dw, stream);
}

// Partial column sums of a [rows, n] matrix (row stride lda) over blocks
// of kColRows rows, each block's rows in order: part [blocks, n].
constexpr int kColRows = 256;

__global__ void __launch_bounds__(256) colsum_part_kernel(const float* __restrict__ a,
                                                          long long lda, int rows, int n,
                                                          float* __restrict__ part) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= n) return;
  const int r0 = blockIdx.y * kColRows, r1 = min(rows, r0 + kColRows);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += a[(long long)r * lda + c];
  part[(long long)blockIdx.y * n + c] = s;
}

inline int colsum_blocks(int rows) { return (rows + kColRows - 1) / kColRows; }

// out[c] = sum over the rows of a[:, c], in a fixed order; part holds
// colsum_blocks(rows) x n floats
static cudaError_t colsum_f32(const float* a, long long lda, int rows, int n, float* part,
                              float* out, cudaStream_t stream) {
  const dim3 grid((n + 255) / 256, colsum_blocks(rows));
  colsum_part_kernel<<<grid, 256, 0, stream>>>(a, lda, rows, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(part, colsum_blocks(rows), n, n, out, stream);
}

// ------------------------------------------------ LayerNorm row blocks
// A CTA of NT = N / 8 threads takes a row at a time; thread i holds the
// float4 column groups i and NT + i of the row (8 columns), and keeps the
// column partials of its 8 columns over the CTA's rows in registers, so no
// shared-memory column reduction is needed.  A row's sums go through a
// warp reduction and then the warps' totals in warp order.
template <int N>
struct RowBlock {
  static constexpr int kThreads = N / 8;
  static constexpr int kWarps = kThreads / 32;
};

template <int N>
__device__ __forceinline__ void rb_load(const float* row, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(row)[threadIdx.x];
  const float4 b = reinterpret_cast<const float4*>(row)[RowBlock<N>::kThreads + threadIdx.x];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int N>
__device__ __forceinline__ void rb_store(float* row, const float (&v)[8]) {
  reinterpret_cast<float4*>(row)[threadIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(row)[RowBlock<N>::kThreads + threadIdx.x] =
      make_float4(v[4], v[5], v[6], v[7]);
}

// column of element e of this thread's 8
template <int N>
__device__ __forceinline__ int rb_col(int e) {
  return 4 * (threadIdx.x + (e >> 2) * RowBlock<N>::kThreads) + (e & 3);
}

// (sum a, sum b) over the CTA's threads; `red` holds 2 kWarps floats, and
// the call begins and ends with a barrier, so it can be called in a loop
template <int N>
__device__ __forceinline__ float2 rb_sum2(float a, float b, float* red) {
  constexpr int W = RowBlock<N>::kWarps;
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[W + warp] = b;
  }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sa += red[w];
    sb += red[W + w];
  }
  return make_float2(sa, sb);
}

// x-hat of the row in v (in place) and its rstd: f32 statistics with flax's
// fast variance E[x^2] - E[x]^2, as ln_f32.cuh and ops/decoder_blocks.py's
// ln_stats
template <int N>
__device__ __forceinline__ float rb_xhat(float (&v)[8], float* red) {
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s += v[e];
    s2 += v[e] * v[e];
  }
  const float2 t = rb_sum2<N>(s, s2, red);
  const float mu = t.x / N;
  const float rstd = rsqrtf(fmaxf(t.y / N - mu * mu, 0.0f) + 1e-5f);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rstd;
  return rstd;
}

// LayerNorm backward of a row (``ln_bwd``): dx = rstd (dy g - mean(dy g) -
// xhat mean(dy g xhat)), into dx
template <int N>
__device__ __forceinline__ void rb_ln_dx(float (&dx)[8], const float (&dy)[8],
                                         const float (&xhat)[8], const float* g, float rstd,
                                         float* red) {
  float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dx[e] = dy[e] * g[rb_col<N>(e)];
    m1 += dx[e];
    m2 += dx[e] * xhat[e];
  }
  const float2 t = rb_sum2<N>(m1, m2, red);
  const float a = t.x / N, b = t.y / N;
#pragma unroll
  for (int e = 0; e < 8; ++e) dx[e] = rstd * (dx[e] - a - xhat[e] * b);
}

// this thread's 8 column partials of Q sums into part[blockIdx.x][q][N]
template <int N, int Q>
__device__ __forceinline__ void rb_store_parts(const float (&acc)[Q][8], float* part) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
    rb_store<N>(part + ((long long)blockIdx.x * Q + q) * N, acc[q]);
}

}  // namespace crog
