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
// Design: both kernels are gemm_wgmma_f32.cuh's GEMM (two warpgroups on a
// 128 x 128 tile, wgmma m64n128k8 .tf32 with the 3xTF32 split, a four-stage
// TMA ring of 32-deep K slices, A split in registers, B split once per call
// into TF32 hi / lo planes, each slice summed in fresh registers), with an
// A policy that gathers the patch from x instead of reading a stored
// matrix, so no patch goes through device memory.  A 32-deep K slice of
// the patch is one (t, s) block of 32 channels (ci 32) or half of one (ci
// 64): 32 contiguous floats of each cell's neighbour at the block's shift
// (OFS[t] - 1, OFS[s] - 1).  TMA lands it as a shifted 2-D box of x viewed
// flat as [B*H*W, 4ci], 128-byte swizzled (zeros above the first row and
// past the last); the rows whose neighbour lies off the image (across an
// image's edge, into the row or image before or after) are zeroed in
// registers where the fragments are split (GwKeep).  TMA's im2col mode
// would zero-fill those in the load, but a box of 128 cells x 32 channels
// at a shift is all this needs, so the one tiled map of x serves every
// slice, and the mask costs a select per fragment value.
//   K6-f32 (S2dPatch): A = P [cells, 16ci] held [m][k], B = wp's planes
//     [4co][16ci] (gw_split_b_planes from wp as [K, N], 1 MB at most); a
//     CTA per 128 cells and 128 output columns.  Each thread's two tile
//     rows are fixed, so their (i, j) are worked out once per CTA.  A wp
//     block (t, s) x (dy', dx') is zero unless t - dy' and s - dx' lie in
//     0..2: where every column of the CTA's tile has the same dy' (co 64),
//     the slices of t = dy' + 3 or t = dy' - 1 are skipped.  That is the
//     CTA's K range (k_range), a uniform decision; the sum changes by no
//     bit but the sign of a zero.  At co 32 a tile holds both dy' and
//     multiplies every block.
//   K6b-f32 (S2dPatchT): A = P read transposed, [k = cell][m = patch
//     channel]: a slice is 32 cells x 128 patch channels, four (t, s)
//     blocks of 32 channels at ci 32 (two halves of two at ci 64), each its
//     own box of 32 cells at its own shift.  Each warp's 16 patch channels
//     lie in one block, so a warp masks its slice's cells with one ballot
//     (each lane steps its cell on by 32 a slice); the tile rows take each
//     group's channels permuted, so that the fragment loads from a group's
//     [32 k][32] box hit 32 banks (S2dPatchT::row).
//     B = dy's planes [4co][cells] (gw_split_b_planes from dy as [K, N]:
//     266 MB at conv2, 532 MB at conv3, the wrapper's workspace); a CTA per
//     128 x 128 block of dwp and chunk of cells (ops/s2dconv.py:
//     wgrad_f32_schedule, from the shapes alone) writes one f32 partial,
//     and reduce_parts adds the partials in chunk order: no atomics, two
//     runs give equal bits.  Every block of dwp is formed, the structural
//     zeros' too, as the twin and the TPU kernel form them.
// Each output element sums its K slices in one fixed order.  x is read
// once per (t, s) block that covers it, 4 times, mostly from L2.
//
// Limits: ci, co in {32, 64}; fp32 x, wp, dy; any B, H, W with B*H*W
// below 2^31 - 128 (rows past the last cell load zeros and are not stored).
#include "gemm_wgmma_f32.cuh"
#include "grad_f32.cuh"

namespace crog {

// padded-input cell offset of slot-row t, less the padding: OFS[t] - 1
__device__ __forceinline__ int s2d_shift(int t) { return (t >> 1) + (t & 1) - 1; }
// block slot (dy*2 + dx) that the (t, s) block of the patch reads
__device__ __forceinline__ int s2d_slot(int t, int s) {
  return ((t + 1) & 1) * 2 + ((s + 1) & 1);
}

// (row, column) of `cell` in its image; the row far outside past the last
// cell, so that no shift brings it in
__device__ __forceinline__ void s2d_cell(const GemmWgF32& p, int cells, int cell, int& i,
                                         int& j) {
  const int q = cell / p.img_w;
  j = cell - q * p.img_w;
  i = cell < cells ? q % p.img_h : -(1 << 20);
}

__device__ __forceinline__ bool s2d_inside(const GemmWgF32& p, int i, int j) {
  return (unsigned)i < (unsigned)p.img_h && (unsigned)j < (unsigned)p.img_w;
}

// K6-f32's A: the patch P [cells, 16CI] of x [cells, 4CI] (p.a, p.m = cells),
// K slice k0 in (t, s) block k0 / CI
template <int CI>
struct S2dPatch {
  struct Rows {
    int i0, j0, i1, j1;  // the thread's tile rows' cells (s2d_cell)
  };
  __device__ __forceinline__ static Rows rows(const GemmWgF32& p, int m0, int) {
    const int r = m0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
    Rows o;
    s2d_cell(p, p.m, r, o.i0, o.j0);
    s2d_cell(p, p.m, r + 8, o.i1, o.j1);
    return o;
  }
  // the slot-rows t whose block of wp is nonzero in some column of the
  // tile at n0: t - dy' in 0..2 for a dy' = n / (2 co) of the tile
  __device__ __forceinline__ static void k_range(const GemmWgF32& p, int n0, int& kbeg,
                                                 int& kend) {
    const int half = p.n / 2;  // 2 co columns a dy'
    const int dlo = n0 / half, dhi = (n0 + kGwN - 1) / half;
    kbeg = max(kbeg, dlo * 4 * CI);
    kend = min(kend, min(4, dhi + 3) * 4 * CI);
  }
  __device__ __forceinline__ static int row(int r) { return r; }
  __device__ __forceinline__ static void load(const CUtensorMap* map, uint32_t dst,
                                              uint64_t* bar, const GemmWgF32& p, int m0,
                                              int k0) {
    const int blk = k0 / CI, t = blk >> 2, s = blk & 3;
    tma_load_2d(map, dst, bar, s2d_slot(t, s) * CI + k0 % CI,
                m0 + s2d_shift(t) * p.img_w + s2d_shift(s));
  }
  __device__ __forceinline__ static uint32_t off(int r, int k) {
    return gw_kmajor_off(r, k >> 2) + (k & 3) * 4;
  }
  __device__ __forceinline__ static GwKeep keep(const GemmWgF32& p, Rows& o, int k0) {
    const int blk = k0 / CI, dy = s2d_shift(blk >> 2), dx = s2d_shift(blk & 3);
    return {s2d_inside(p, o.i0 + dy, o.j0 + dx), s2d_inside(p, o.i1 + dy, o.j1 + dx),
            0xffffffffu};
  }
  static bool map(CUtensorMap* amap, const GemmWgF32& p) {
    return gw_map(amap, p.a, 4 * CI, p.m, 4 * CI, false);
  }
  static bool ok(const GemmWgF32& p) {
    return p.lda == 4 * CI && p.k == 16 * CI && p.img_h > 0 && p.img_w > 0;
  }
};

// K6b-f32's A: P read transposed, [k = cell][m = patch channel] of x [cells,
// 4CI] (p.a, p.k = cells); a slice's four 32-channel groups land as four
// boxes of [32 cells][32 channels], group q at q kGwTile / 4.  In a group's
// box, a fragment load (k = t, and rows 16-byte chunks apart) would meet
// 2-way bank conflicts, so the wgmma's tile rows take the group's channels
// permuted (row): warp half h of the group (tile rows 16 h..16 h + 15) holds
// channels 4 h + (0..3, 16.., 8.., 24..), whose chunks XOR-ed with t fill
// 32 banks.
template <int CI>
struct S2dPatchT {
  struct Rows {
    int dy, dx;  // the shift of the warp's (t, s) block
    int i, j;    // lane l's cell k0 + l of the next slice (s2d_cell)
  };
  __device__ __forceinline__ static void k_range(const GemmWgF32&, int, int&, int&) {}
  __device__ __forceinline__ static Rows rows(const GemmWgF32& p, int m0, int kbeg) {
    const int blk = (m0 + (threadIdx.x >> 5) * 16) / CI;
    Rows o{s2d_shift(blk >> 2), s2d_shift(blk & 3), 0, 0};
    s2d_cell(p, p.k, kbeg + (threadIdx.x & 31), o.i, o.j);
    return o;
  }
  __device__ __forceinline__ static int row(int r) {
    const int q = r & 15;
    return (r & ~31) + ((q >> 2) & 1) * 16 + (q >> 3) * 8 + ((r >> 4) & 1) * 4 + (q & 3);
  }
  __device__ __forceinline__ static void load(const CUtensorMap* map, uint32_t dst,
                                              uint64_t* bar, const GemmWgF32& p, int m0,
                                              int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mq = m0 + 32 * q, blk = mq / CI, t = blk >> 2, s = blk & 3;
      tma_load_2d(map, dst + q * (kGwTile / 4), bar, s2d_slot(t, s) * CI + mq % CI,
                  k0 + s2d_shift(t) * p.img_w + s2d_shift(s));
    }
  }
  __device__ __forceinline__ static uint32_t off(int r, int k) {
    const int ch = row(r) & 31;
    return (r >> 5) * (kGwTile / 4) + gw_kmajor_off(k, ch >> 2) + (ch & 3) * 4;
  }
  // lane l: is cell k0 + l's neighbour at the warp's shift inside?  Then
  // the lane's cell steps 32 on (no division a slice)
  __device__ __forceinline__ static GwKeep keep(const GemmWgF32& p, Rows& o, int k0) {
    const bool in = k0 + (int)(threadIdx.x & 31) < p.k && s2d_inside(p, o.i + o.dy, o.j + o.dx);
    o.j += kGwK;
    while (o.j >= p.img_w) {
      o.j -= p.img_w;
      if (++o.i == p.img_h) o.i = 0;
    }
    return {true, true, __ballot_sync(0xffffffffu, in)};
  }
  static bool map(CUtensorMap* amap, const GemmWgF32& p) {
    return gw_map(amap, p.a, 4 * CI, p.k, 4 * CI, false, kGwK);
  }
  static bool ok(const GemmWgF32& p) {
    return p.lda == 4 * CI && p.m == 16 * CI && p.img_h > 0 && p.img_w > 0;
  }
};

// y [cells, n] = P(x) wp, n = 4co; wp's planes into `planes` (2 n 16CI floats)
template <int CI>
static cudaError_t launch_s2dconv_f32_fwd(const float* x, const float* wp, float* planes,
                                          float* y, int B, int H, int W, int n,
                                          cudaStream_t stream) {
  const int k = 16 * CI;
  cudaError_t err = gw_split_b_planes<true, kProdS2dConv>(wp, planes, n, k, stream);
  if (err != cudaSuccess) return err;
  const GemmWgF32 p{x,    planes, y, nullptr, 4 * CI, gw_planes_ld(k), n, 0, B * H * W, n, k,
                    k, Dropout{0u, 0u, 1.0f}, H, W};
  return gemm_wgmma_f32_a<S2dPatch<CI>, kGwStore, kProdS2dConv>(p, stream);
}

// dwp [16CI, n] = P(x)^T dy through part [chunks, 16CI, n] (a partial per
// `chunk` cells), dy's planes into `planes` (2 n gw_planes_ld(cells) floats)
template <int CI>
static cudaError_t launch_s2dconv_f32_wgrad(const float* x, const float* dy, float* planes,
                                            float* part, float* dwp, int B, int H, int W, int n,
                                            int chunks, int chunk, cudaStream_t stream) {
  const int cells = B * H * W, m = 16 * CI;
  cudaError_t err = gw_split_b_planes<true, kProdS2dWgrad>(dy, planes, n, cells, stream);
  if (err != cudaSuccess) return err;
  const long long mn = (long long)m * n;
  const GemmWgF32 p{x,     planes, part, nullptr, 4 * CI, gw_planes_ld(cells), n, mn, m, n,
                    cells, chunk,  Dropout{0u, 0u, 1.0f}, H, W};
  err = gemm_wgmma_f32_a<S2dPatchT<CI>, kGwStore, kProdS2dWgrad>(p, stream);
  if (err != cudaSuccess) return err;
  return reduce_parts(part, chunks, mn, mn, dwp, stream);
}

template <int CI>
static int s2dconv_f32_attrs(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(
      &fa, gemm_wgmma_f32_kernel<products_of(kProdS2dConv), S2dPatch<CI>, kGwStore>);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + kGwSmem);
  out[2] = (int)fa.localSizeBytes;
  err = cudaFuncGetAttributes(
      &fa, gemm_wgmma_f32_kernel<products_of(kProdS2dWgrad), S2dPatchT<CI>, kGwStore>);
  if (err != cudaSuccess) return (int)err;
  out[3] = fa.numRegs;
  out[4] = (int)(fa.sharedSizeBytes + kGwSmem);
  out[5] = (int)fa.localSizeBytes;
  return 0;
}

inline bool s2d_f32_shape_ok(int ci, int co, int B, int H, int W) {
  return (ci == 32 || ci == 64) && (co == 32 || co == 64) && B >= 1 && H >= 1 && W >= 1 &&
         (long long)B * H * W < 0x7fffffffLL - kGwM;
}

}  // namespace crog

// K6-f32: y [B, H, W, 4co] f32 = blocked conv of x [B, H, W, 4ci] f32 with the
// packed weight wp [16ci, 4co] f32 (pack_s1's layout: its structural zeros
// are skipped where a tile's columns allow), wp's TF32 planes split into
// `planes` (2 * 4co * 16ci floats, work).
extern "C" int crog_s2dconv_f32_fwd(const void* x, const void* wp, void* planes, void* y, int B,
                                    int H, int W, int ci, int co, void* stream) {
  using namespace crog;
  if (!s2d_f32_shape_ok(ci, co, B, H, W)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wp);
  auto* pf = static_cast<float*>(planes);
  auto* yf = static_cast<float*>(y);
  return (int)(ci == 32 ? launch_s2dconv_f32_fwd<32>(xf, wf, pf, yf, B, H, W, 4 * co, st)
                        : launch_s2dconv_f32_fwd<64>(xf, wf, pf, yf, B, H, W, 4 * co, st));
}

// K6b-f32: dwp [16ci, 4co] f32 = P(x)^T dy over every cell, dy's TF32 planes
// split into `planes` (2 * 4co * round_up(B*H*W, 4) floats, work), through
// one f32 partial per chunk of `chunk` cells, part [chunks, 16ci, 4co],
// added in chunk order; chunk a multiple of 32, and no chunk empty.
extern "C" int crog_s2dconv_f32_wgrad(const void* x, const void* dy, void* planes, void* part,
                                      void* dwp, int B, int H, int W, int ci, int co, int chunks,
                                      int chunk, void* stream) {
  using namespace crog;
  if (!s2d_f32_shape_ok(ci, co, B, H, W) || chunks < 1 || chunks > 65535 || chunk < kGwK ||
      chunk % kGwK)
    return (int)cudaErrorInvalidValue;
  const long long cells = (long long)B * H * W;
  if ((long long)chunks * chunk < cells || (long long)(chunks - 1) * chunk >= cells)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dy);
  auto* lf = static_cast<float*>(planes);
  auto* pf = static_cast<float*>(part);
  auto* wf = static_cast<float*>(dwp);
  const int n = 4 * co;
  return (int)(ci == 32 ? launch_s2dconv_f32_wgrad<32>(xf, df, lf, pf, wf, B, H, W, n, chunks,
                                                       chunk, st)
                        : launch_s2dconv_f32_wgrad<64>(xf, df, lf, pf, wf, B, H, W, n, chunks,
                                                       chunk, st));
}

// out[6]: K6-f32's registers per thread, shared memory per CTA and spill
// bytes per thread, then K6b-f32's (gemm_wgmma_f32_kernel with the
// S2dPatch and S2dPatchT policies), for input width ci
extern "C" int crog_s2dconv_f32_attrs(int ci, int* out) {
  using namespace crog;
  if (ci != 32 && ci != 64) return (int)cudaErrorInvalidValue;
  return ci == 32 ? s2dconv_f32_attrs<32>(out) : s2dconv_f32_attrs<64>(out);
}
