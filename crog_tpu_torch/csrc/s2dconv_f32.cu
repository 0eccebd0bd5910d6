// K6-f32 / K6b-f32: the space-to-depth stem's gathered blocked 3x3 conv and
// its weight gradient on fp32 operands, all in f32 (3xTF32 products), C
// interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_s2dconv.py:296 `_conv_padded` (pallas_call at
// :348: the forward, and the dgrad with the flipped, ci/co-swapped kernel)
// and :359 `_wgrad` (pallas_call at :373) where the model computes in fp32.
// x is a 2x2-blocked NHWC tensor [B, H, W, 4ci], wp the packed weight
// [16ci, 4co] (ops/s2dconv.py:pack_s1).  The gathered patch row of cell
// (b, i, j) is, for slot-row t and slot-column s in 0..3,
//
//   P[(b,i,j), (t*4+s)*ci + c] = x[b, i + OFS[t] - 1, j + OFS[s] - 1,
//                                  (DY[t]*2 + DY[s])*ci + c]   (0 off the image)
//
// with OFS = (0,1,1,2) and DY = (1,0,1,0), and
//   K6-f32:  y[(b,i,j), n] = sum_k P[(b,i,j), k] wp[k, n]
//   K6b-f32: dwp[k, n]     = sum_(b,i,j) P[(b,i,j), k] dy[(b,i,j), n]
// The twins are ops/s2dconv.py:conv_padded_plain and wgrad_plain.  (On a TPU
// at 416^2 the fp32 stem does not fit the Pallas kernel's VMEM plan and runs
// XLA's conv of the same function, pallas_s2dconv.py:405-417.)
//
// Bound on an H100 at the main path (batch 24, 104x104 cells): the real
// taps, 2*9*ci*co per original output pixel, are 19.14 GFLOP for conv2 (ci =
// co = 32) and 38.28 for conv3 (ci 32, co 64) and for its dgrad, 0.116 and
// 0.232 ms at 3xTF32's 165 TFLOP/s, while their fp32 activations move in
// 0.079 and 0.119 ms at 3.35 TB/s: operations bound every launch (bf16 K6
// is bound by its bytes).
//
// Design: right and simple first.  Both kernels are grad_f32.cuh's GEMM (8
// warps on a 128 x 128 tile, 32-deep K slices through a two-stage cp.async
// ring, mma.sync m16n8k8 with the 3xTF32 split, each slice summed in fresh
// registers that one f32 add joins to the running sum: kn_mainloop)
// with loaders that gather the patch from x instead of reading a stored
// matrix, so no patch goes through device memory:
//   K6-f32: A = P [cells, 16ci] held [m][k], B = wp held [k][n]; a CTA per
//     128 cells and 128 output columns.  A 32-deep K slice is one (t, s)
//     block of ci channels (ci 32) or half of one (ci 64), so each tile row
//     reads 32 contiguous floats of one neighbouring cell, zero-filled where
//     that cell is off the image.  Each thread keeps the cells of its four
//     tile rows in registers.
//   K6b-f32: A = P read transposed, held [k = cell][m = patch channel], B
//     = dy held [k = cell][n]; a CTA per 128 x 128 block of dwp and chunk of
//     cells (ops/s2dconv.py:wgrad_f32_schedule, from the shapes alone)
//     writes one f32 partial, and reduce_parts adds the partials in chunk
//     order: no atomics, two runs give equal bits.
// Each output element of either sums its K slices in one fixed order.  The
// packed weight's structural zeros are multiplied as in the twin (16/9 of
// the real taps; K6b-f32's gradient there is nonzero and unused).  x is
// read once per 4x4 window that covers it, up to 4 times, mostly from L2.
//
// Limits: ci, co in {32, 64}; fp32 x, wp, dy; any B, H, W with B*H*W
// below 2^31 (rows past the last cell load zeros and are not stored).
#include "grad_f32.cuh"

namespace crog {

// padded-input cell offset of slot-row t, less the padding: OFS[t] - 1
__device__ __forceinline__ int s2d_shift(int t) { return (t >> 1) + (t & 1) - 1; }
// block slot (dy*2 + dx) that the (t, s) block of the patch reads
__device__ __forceinline__ int s2d_slot(int t, int s) {
  return ((t + 1) & 1) * 2 + ((s + 1) & 1);
}

// y [cells, n] = P(x) wp, n = 4co; grid (cell tiles, n / kGKN)
template <int P, int CI>
__global__ void __launch_bounds__(kGKThreads) s2dconv_f32_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ wp, float* __restrict__ y, int B,
    int H, int W, int n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int cells = B * H * W;
  const int m0 = blockIdx.x * kGKM, n0 = blockIdx.y * kGKN;
  // this thread's tile rows r = threadIdx.x / 8 + 32 q read 4 floats at c4
  const int c4 = (threadIdx.x & 7) * 4;
  int cy[4], cx[4];
  long long cbase[4];  // the cell's first float in x
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cell = m0 + (threadIdx.x >> 3) + 32 * q;
    cx[q] = cell % W;
    cy[q] = cell < cells ? (cell / W) % H : -(1 << 20);  // past the last cell: never inside
    cbase[q] = (long long)cell * (4 * CI);
  }

  auto load = [&](int k0, int stage) {
    float* as = smem + stage * kGKStage;
    float* bs = as + kGKATile;
    const int blk = k0 / CI, t = blk >> 2, s = blk & 3;
    const int dyo = s2d_shift(t), dxo = s2d_shift(s);
    const long long shift =
        ((long long)dyo * W + dxo) * (4 * CI) + s2d_slot(t, s) * CI + k0 % CI + c4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (threadIdx.x >> 3) + 32 * q;
      const bool in =
          (unsigned)(cy[q] + dyo) < (unsigned)H && (unsigned)(cx[q] + dxo) < (unsigned)W;
      cp_async16(smem_u32(as + r * kGKLdRow + c4), in ? x + cbase[q] + shift : x, in ? 16 : 0);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // 32 k rows of 128 n
      const int i = threadIdx.x + kGKThreads * q;
      const int r = i >> 5, c = (i & 31) * 4;
      cp_async16(smem_u32(bs + r * kGKLdCol + c), wp + (long long)(k0 + r) * n + n0 + c, 16);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
  kn_mainloop<P, false>(smem, 0, 16 * CI / kGKK, load, acc);
  store_kn_block(y, n, cells, n, m0 + wm, n0 + wn, acc);
}

// part[z] [16CI, n] = P(x)^T dy over cells [z chunk, (z + 1) chunk), n =
// 4co; grid (n / kGKN, 16CI / kGKM, chunks)
template <int P, int CI>
__global__ void __launch_bounds__(kGKThreads) s2dconv_f32_wgrad_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ part, int B,
    int H, int W, int n, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int cells = B * H * W;
  const int m0 = blockIdx.y * kGKM, n0 = blockIdx.x * kGKN;
  const int kbeg = blockIdx.z * chunk, kend = min(cells, kbeg + chunk);
  // this thread's 4 patch channels m0 + c4 .. lie in one (t, s) block, read
  // for cells k0 + threadIdx.x / 32 + 8 q
  const int c4 = (threadIdx.x & 31) * 4;
  const int blk = (m0 + c4) / CI, t = blk >> 2, s = blk & 3;
  const int dyo = s2d_shift(t), dxo = s2d_shift(s);
  const long long shift =
      ((long long)dyo * W + dxo) * (4 * CI) + s2d_slot(t, s) * CI + (m0 + c4) % CI;

  auto load = [&](int k0, int stage) {
    float* as = smem + stage * kGKStage;
    float* bs = as + kGKATile;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = (threadIdx.x >> 5) + 8 * q, cell = k0 + r;
      const bool row = cell < kend;
      const int yy = (cell / W) % H + dyo, xx = cell % W + dxo;
      const bool in = row && (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W;
      cp_async16(smem_u32(as + r * kGKLdCol + c4),
                 in ? x + (long long)cell * (4 * CI) + shift : x, in ? 16 : 0);
      cp_async16(smem_u32(bs + r * kGKLdCol + c4),
                 row ? dy + (long long)cell * n + n0 + c4 : dy, row ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
  kn_mainloop<P, true>(smem, kbeg, kend > kbeg ? (kend - kbeg + kGKK - 1) / kGKK : 0, load,
                       acc);
  store_kn_block(part + (long long)blockIdx.z * (16 * CI) * n, n, 16 * CI, n, m0 + wm, n0 + wn,
                 acc);
}

template <int CI>
static cudaError_t launch_s2dconv_f32_fwd(const float* x, const float* wp, float* y, int B, int H,
                                          int W, int n, cudaStream_t stream) {
  constexpr int P = products_of(kProdS2dConv);
  static const cudaError_t attr =
      cudaFuncSetAttribute(s2dconv_f32_fwd_kernel<P, CI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gemm_kn_smem_bytes());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)(((long long)B * H * W + kGKM - 1) / kGKM), n / kGKN);
  s2dconv_f32_fwd_kernel<P, CI><<<grid, kGKThreads, gemm_kn_smem_bytes(), stream>>>(x, wp, y, B, H,
                                                                                   W, n);
  return cudaGetLastError();
}

template <int CI>
static cudaError_t launch_s2dconv_f32_wgrad(const float* x, const float* dy, float* part,
                                            float* dwp, int B, int H, int W, int n, int chunks,
                                            int chunk, cudaStream_t stream) {
  constexpr int P = products_of(kProdS2dWgrad);
  static const cudaError_t attr =
      cudaFuncSetAttribute(s2dconv_f32_wgrad_kernel<P, CI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gemm_kn_smem_bytes());
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n / kGKN, 16 * CI / kGKM, chunks);
  s2dconv_f32_wgrad_kernel<P, CI><<<grid, kGKThreads, gemm_kn_smem_bytes(), stream>>>(
      x, dy, part, B, H, W, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long mn = 16LL * CI * n;
  return reduce_parts(part, chunks, mn, mn, dwp, stream);
}

template <int CI>
static int s2dconv_f32_attrs(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err =
      cudaFuncGetAttributes(&fa, s2dconv_f32_fwd_kernel<products_of(kProdS2dConv), CI>);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + gemm_kn_smem_bytes());
  out[2] = (int)fa.localSizeBytes;
  err = cudaFuncGetAttributes(&fa, s2dconv_f32_wgrad_kernel<products_of(kProdS2dWgrad), CI>);
  if (err != cudaSuccess) return (int)err;
  out[3] = fa.numRegs;
  out[4] = (int)(fa.sharedSizeBytes + gemm_kn_smem_bytes());
  out[5] = (int)fa.localSizeBytes;
  return 0;
}

inline bool s2d_f32_shape_ok(int ci, int co, int B, int H, int W) {
  return (ci == 32 || ci == 64) && (co == 32 || co == 64) && B >= 1 && H >= 1 && W >= 1 &&
         (long long)B * H * W < 0x7fffffffLL - kGKM;
}

}  // namespace crog

// K6-f32: y [B, H, W, 4co] f32 = blocked conv of x [B, H, W, 4ci] f32 with the
// packed weight wp [16ci, 4co] f32.
extern "C" int crog_s2dconv_f32_fwd(const void* x, const void* wp, void* y, int B, int H, int W,
                                    int ci, int co, void* stream) {
  using namespace crog;
  if (!s2d_f32_shape_ok(ci, co, B, H, W)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wp);
  auto* yf = static_cast<float*>(y);
  return (int)(ci == 32 ? launch_s2dconv_f32_fwd<32>(xf, wf, yf, B, H, W, 4 * co, st)
                        : launch_s2dconv_f32_fwd<64>(xf, wf, yf, B, H, W, 4 * co, st));
}

// K6b-f32: dwp [16ci, 4co] f32 = P(x)^T dy over every cell, through one f32
// partial per chunk of `chunk` cells, part [chunks, 16ci, 4co], added in
// chunk order; chunk a multiple of 32, and no chunk empty.
extern "C" int crog_s2dconv_f32_wgrad(const void* x, const void* dy, void* part, void* dwp,
                                      int B, int H, int W, int ci, int co, int chunks, int chunk,
                                      void* stream) {
  using namespace crog;
  if (!s2d_f32_shape_ok(ci, co, B, H, W) || chunks < 1 || chunks > 65535 || chunk < kGKK ||
      chunk % kGKK)
    return (int)cudaErrorInvalidValue;
  const long long cells = (long long)B * H * W;
  if ((long long)chunks * chunk < cells || (long long)(chunks - 1) * chunk >= cells)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dy);
  auto* pf = static_cast<float*>(part);
  auto* wf = static_cast<float*>(dwp);
  const int n = 4 * co;
  return (int)(ci == 32
                   ? launch_s2dconv_f32_wgrad<32>(xf, df, pf, wf, B, H, W, n, chunks, chunk, st)
                   : launch_s2dconv_f32_wgrad<64>(xf, df, pf, wf, B, H, W, n, chunks, chunk, st));
}

// out[6]: K6-f32's registers per thread, shared memory per CTA and spill
// bytes per thread, then K6b-f32's, for input width ci
extern "C" int crog_s2dconv_f32_attrs(int ci, int* out) {
  using namespace crog;
  if (ci != 32 && ci != 64) return (int)cudaErrorInvalidValue;
  return ci == 32 ? s2dconv_f32_attrs<32>(out) : s2dconv_f32_attrs<64>(out);
}
