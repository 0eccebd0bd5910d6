// K6 / K6b: the gathered blocked 3x3 convolution of the space-to-depth stem.
//
// Replaces crog_tpu/ops/pallas_s2dconv.py:296 `_conv_padded` (pallas_call at
// :348, K6: the forward, and the dgrad with the flipped, ci/co-swapped
// kernel) and :359 `_wgrad` (pallas_call at :373, K6b).  x is a 2x2-blocked
// NHWC tensor [B, H, W, 4ci] (slot (dy*2+dx)*ci + c), wp the packed weight
// [16ci, 4co] (crog_tpu_torch/ops/s2dconv.py:pack_s1).  For output cell
// (i, j) the gathered patch row is, for slot-row t and slot-column s in 0..3,
//
//   P[(i,j), (t*4+s)*ci + c] = x[i + OFS[t] - 1, j + OFS[s] - 1,
//                                (DY[t]*2 + DY[s])*ci + c]   (0 off the image)
//
// with OFS = (0,1,1,2) and DY = (1,0,1,0), and
//   K6:  y[(i,j), n] = sum_k P[(i,j), k] wp[k, n]          (bf16 out, f32 sums)
//   K6b: dwp[k, n]   = sum_(b,i,j) P[(b,i,j), k] dy[(b,i,j), n]   (f32)
//
// Bound on an H100 at the main path (batch 24, 416^2: 104x104 cells, stem
// conv2 ci = co = 32 and conv3 ci = 32, co = 64): each launch moves its
// activations once (conv2 133 MB, 0.040 ms at 3.35 TB/s; conv3 199 MB,
// 0.060 ms) while its real taps, 9*ci*co per output pixel, take 19.1 and
// 38.3 GFLOP (0.019, 0.039 ms at 989 TFLOP/s): bytes bound every launch.
// The packed product does 16/9 of the real taps (the 4x4 window's corners),
// a quarter of what the zero-embedded [3,3,4ci,4co] conv multiplies.
//
// Design.  A K6 block owns an 8 x 16 tile of output cells and 128 output
// columns.  It loads the tile's 10 x 18 cell halo with 16-byte loads into
// shared memory, writing zeros off the image (so no padded copy of x is
// made), and streams the packed weight in [ci, 128] chunks, one per (t, s).
// The gather costs nothing: a 16-cell row segment of P's (t, s) block is a
// row-major [16, ci] matrix in the halo with the cell stride as its leading
// dimension, so the bf16 tensor-core fragments (wmma 16x16x16, f32
// accumulate) load it straight from the halo.  Eight warps each hold 2 cell
// rows x 64 columns of f32 sums; the epilogue stages them through shared
// memory and writes bf16 with 16-byte stores.
//
// K6b: Hopper's blocks run in parallel and in no order, so the TPU kernel's
// weight gradient carried across its sequential grid becomes, per block
// (128 columns, 128 rows of the packed gradient, split), a loop over the
// split's cell tiles that keeps a [128, 128] f32 partial in registers and
// writes it to part[split]; a second pass adds the splits in index order
// (gemm.cuh:launch_reduce).  The same gradient in every run, no atomics.  A
// block's 128 packed rows lie in one slot-row t, so it loads only the cell
// rows and the slot pair that t reads (A fragments read column-major from
// the halo, B from the dy tile).
//
// Limits: ci, co in {32, 64}, bf16 activations, any B, H, W (edges masked).
#include "gemm.cuh"

namespace crog {

constexpr int kSR = 8;          // cell rows per tile
constexpr int kSW = 16;         // cell columns per tile: one fragment's 16 rows
constexpr int kSHR = kSR + 2;   // halo rows
constexpr int kSHC = kSW + 2;   // halo columns
constexpr int kSN = 128;        // output columns per block
constexpr int kSK = 128;        // K6b: packed-gradient rows per block
constexpr int kSThreads = 256;  // 8 warps
constexpr int kSWLd = kSN + 8;  // row stride of the weight chunk and the dy tile
constexpr int kSCLd = kSN + 4;  // row stride of the f32 staging tile

__host__ __device__ constexpr int ofs(int t) { return (t >> 1) + (t & 1); }
__host__ __device__ constexpr int dslot(int t) { return (t + 1) & 1; }

// cell stride of a halo holding `ch` channels: a multiple of 16 elements
// keeps every fragment pointer 32-byte aligned
__host__ __device__ constexpr int halo_ld(int ch) { return ch + 16; }

template <int CI>
constexpr size_t fwd_smem_bytes() {
  const size_t in = (size_t)(kSHR * kSHC * halo_ld(4 * CI) + CI * kSWLd) * sizeof(bf16);
  const size_t stage = (size_t)kSR * kSW * kSCLd * sizeof(float);
  return in > stage ? in : stage;
}

template <int CI>
constexpr size_t wgrad_smem_bytes() {
  return (size_t)(kSR * kSHC * halo_ld(2 * CI) + kSR * kSW * kSWLd) * sizeof(bf16);
}

template <int CI>
__global__ void __launch_bounds__(kSThreads) s2dconv_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wp, bf16* __restrict__ y, int H,
    int W, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C4 = 4 * CI;
  constexpr int LD = halo_ld(C4);
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kSHR * kSHC][LD]
  bf16* ws = xs + kSHR * kSHC * LD;          // [CI][kSWLd]
  float* cs = reinterpret_cast<float*>(smem);  // epilogue [kSR * kSW][kSCLd]
  const int n0 = blockIdx.x * kSN;
  const int ntx = (W + kSW - 1) / kSW;
  const int r0 = (blockIdx.y / ntx) * kSR;
  const int c0 = (blockIdx.y % ntx) * kSW;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 2;   // the warp's first tile row
  const int wn = (warp % 2) * 64;  // the warp's first column in the block's 128

  constexpr int kVpc = C4 / 8;  // 16-byte vectors per cell
  for (int v = threadIdx.x; v < kSHR * kSHC * kVpc; v += kSThreads) {
    const int cell = v / kVpc;
    const int q = (v % kVpc) * 8;
    const int gr = r0 + cell / kSHC - 1;
    const int gc = c0 + cell % kSHC - 1;
    bf16* dst = xs + cell * LD + q;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      copy8(dst, x + ((b * H + gr) * W + gc) * C4 + q);
    } else {
      zero8(dst);
    }
  }

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll 1
  for (int ts = 0; ts < 16; ++ts) {
    const int t = ts >> 2;
    const int s = ts & 3;
    __syncthreads();  // the halo is in; the previous chunk's readers are done
    for (int v = threadIdx.x; v < CI * (kSN / 8); v += kSThreads) {
      const int r = v / (kSN / 8);
      const int c = (v % (kSN / 8)) * 8;
      copy8(ws + r * kSWLd + c, wp + (long long)(ts * CI + r) * N + n0 + c);
    }
    __syncthreads();
    // block (t, s) of the patch for the warp's first cell row: row m of the
    // fragment is halo cell (wr + OFS[t], OFS[s] + m)
    const bf16* xa =
        xs + ((wr + ofs(t)) * kSHC + ofs(s)) * LD + (dslot(t) * 2 + dslot(s)) * CI;
#pragma unroll
    for (int kk = 0; kk < CI; kk += 16) {
      FragA fa[2];
      FragBRow fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], xa + i * kSHC * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * kSWLd + wn + j * 16, kSWLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (wr + i) * kSW * kSCLd + wn + j * 16, acc[i][j], kSCLd,
                              wmma::mem_row_major);
  __syncthreads();
  for (int v = threadIdx.x; v < kSR * kSW * (kSN / 8); v += kSThreads) {
    const int cell = v / (kSN / 8);
    const int q = (v % (kSN / 8)) * 8;
    const int gr = r0 + cell / kSW;
    const int gc = c0 + cell % kSW;
    if (gr >= H || gc >= W) continue;
    const float4 lo = *reinterpret_cast<const float4*>(cs + cell * kSCLd + q);
    const float4 hi = *reinterpret_cast<const float4*>(cs + cell * kSCLd + q + 4);
    __align__(16) bf16 out[8] = {f2bf(lo.x), f2bf(lo.y), f2bf(lo.z), f2bf(lo.w),
                                 f2bf(hi.x), f2bf(hi.y), f2bf(hi.z), f2bf(hi.w)};
    copy8(y + ((b * H + gr) * W + gc) * N + n0 + q, out);
  }
}

template <int CI>
__global__ void __launch_bounds__(kSThreads) s2dconv_wgrad_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ part,
    int B, int H, int W, int N, int per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C4 = 4 * CI;
  constexpr int C2 = 2 * CI;
  constexpr int LD = halo_ld(C2);
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kSR * kSHC][LD]: slot-row t's pair
  bf16* ds = xs + kSR * kSHC * LD;           // [kSR * kSW][kSWLd]
  const int n0 = blockIdx.x * kSN;
  const int kb = blockIdx.y;  // rows kb*128 .. +128 of the packed gradient
  const int split = blockIdx.z;
  const int t = kb * kSK / C4;
  const int k0 = kb * kSK - t * C4;  // the block's first row within slot-row t
  const int warp = threadIdx.x / 32;
  const int wk = (warp / 2) * 32;
  const int wn = (warp % 2) * 64;
  const int ntx = (W + kSW - 1) / kSW;
  const int nty = (H + kSR - 1) / kSR;
  const int tiles = B * nty * ntx;
  const int tb = split * per_split;
  const int te = min(tiles, tb + per_split);

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // the rows of the warp's two A fragments: slot-column s, channel c
  int aoff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kk = k0 + wk + i * 16;
    const int s = kk / CI;
    aoff[i] = ofs(s) * LD + dslot(s) * CI + kk % CI;
  }

  constexpr int kVx = C2 / 8;
#pragma unroll 1
  for (int tile = tb; tile < te; ++tile) {
    const long long bi = tile / (nty * ntx);
    const int rem = tile % (nty * ntx);
    const int r0 = (rem / ntx) * kSR;
    const int c0 = (rem % ntx) * kSW;
    __syncthreads();  // the previous tile's readers are done
    for (int v = threadIdx.x; v < kSR * kSHC * kVx; v += kSThreads) {
      const int cell = v / kVx;
      const int q = (v % kVx) * 8;
      const int gr = r0 + cell / kSHC + ofs(t) - 1;
      const int gc = c0 + cell % kSHC - 1;
      bf16* dst = xs + cell * LD + q;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        copy8(dst, x + ((bi * H + gr) * W + gc) * C4 + dslot(t) * C2 + q);
      } else {
        zero8(dst);
      }
    }
    for (int v = threadIdx.x; v < kSR * kSW * (kSN / 8); v += kSThreads) {
      const int cell = v / (kSN / 8);
      const int q = (v % (kSN / 8)) * 8;
      const int gr = r0 + cell / kSW;
      const int gc = c0 + cell % kSW;
      bf16* dst = ds + cell * kSWLd + q;
      if (gr < H && gc < W) {
        copy8(dst, dy + ((bi * H + gr) * W + gc) * N + n0 + q);
      } else {
        zero8(dst);  // cells off the image add nothing
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int rl = 0; rl < kSR; ++rl) {
      FragACol fa[2];  // element (k, m) at xs[(rl, OFS[s] + m) cell + channel k]
      FragBRow fb[4];  // element (m, n) at ds[(rl, m) cell + n]
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + rl * kSHC * LD + aoff[i], LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], ds + rl * kSW * kSWLd + wn + j * 16, kSWLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  float* out = part + (long long)split * 16 * CI * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + (long long)(kb * kSK + wk + i * 16) * N + n0 + wn + j * 16,
                              acc[i][j], N, wmma::mem_row_major);
}

template <int CI>
cudaError_t launch_s2dconv_fwd(const bf16* x, const bf16* wp, bf16* y, int B, int H, int W,
                               int N, cudaStream_t st) {
  constexpr size_t smem = fwd_smem_bytes<CI>();
  cudaError_t err = cudaFuncSetAttribute(
      s2dconv_fwd_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kSN, ((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW), B);
  s2dconv_fwd_kernel<CI><<<grid, kSThreads, smem, st>>>(x, wp, y, H, W, N);
  return cudaGetLastError();
}

template <int CI>
cudaError_t launch_s2dconv_wgrad(const bf16* x, const bf16* dy, float* part, float* dwp,
                                 int B, int H, int W, int N, int splits, int per_split,
                                 cudaStream_t st) {
  constexpr size_t smem = wgrad_smem_bytes<CI>();
  cudaError_t err = cudaFuncSetAttribute(
      s2dconv_wgrad_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kSN, 16 * CI / kSK, splits);
  s2dconv_wgrad_kernel<CI><<<grid, kSThreads, smem, st>>>(x, dy, part, B, H, W, N, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 16LL * CI * N;
  return launch_reduce(part, splits, n, n, dwp, nullptr, st);
}

inline bool s2d_width_ok(int c) { return c == 32 || c == 64; }

inline bool s2d_grid_ok(int B, int H, int W) {
  const long long cells = (long long)((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW);
  return B >= 1 && H >= 1 && W >= 1 && B <= 65535 && cells <= 65535;
}

}  // namespace crog

// K6: y [B, H, W, 4co] bf16 = blocked conv of x [B, H, W, 4ci] bf16 with the
// packed weight wp [16ci, 4co] bf16.
extern "C" int crog_s2dconv_fwd(const void* x, const void* wp, void* y, int B, int H, int W,
                                int ci, int co, void* stream) {
  using namespace crog;
  if (!s2d_width_ok(ci) || !s2d_width_ok(co) || !s2d_grid_ok(B, H, W))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(wp);
  auto* yb = static_cast<bf16*>(y);
  return ci == 32 ? launch_s2dconv_fwd<32>(xb, wb, yb, B, H, W, 4 * co, st)
                  : launch_s2dconv_fwd<64>(xb, wb, yb, B, H, W, 4 * co, st);
}

// K6b: dwp [16ci, 4co] f32 = P(x)^T dy over every cell, through the split
// partials part [splits, 16ci, 4co] f32 (splits * per_split >= the number of
// 8 x 16 cell tiles).
extern "C" int crog_s2dconv_wgrad(const void* x, const void* dy, void* part, void* dwp, int B,
                                  int H, int W, int ci, int co, int splits, int per_split,
                                  void* stream) {
  using namespace crog;
  if (!s2d_width_ok(ci) || !s2d_width_ok(co) || B < 1 || H < 1 || W < 1 || splits < 1 ||
      splits > 65535 || per_split < 1)
    return cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW);
  if ((long long)splits * per_split < tiles || tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* db = static_cast<const bf16*>(dy);
  auto* pf = static_cast<float*>(part);
  auto* wf = static_cast<float*>(dwp);
  return ci == 32
             ? launch_s2dconv_wgrad<32>(xb, db, pf, wf, B, H, W, 4 * co, splits, per_split, st)
             : launch_s2dconv_wgrad<64>(xb, db, pf, wf, B, H, W, 4 * co, splits, per_split, st);
}
