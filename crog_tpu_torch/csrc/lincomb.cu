// K5 / K5b: SSG's prototype-combination loss sums and their gradients.
//
// Replaces crog_tpu/ops/pallas_lincomb.py:223 `make_lincomb_sums._fwd_call`
// (pallas_call at :225, K5) and :245 `sums_bwd` (pallas_call at :252, K5b).
// For each image b, selected column col = j*T + t (anchor j, task t) and
// pixel p of the ph x pw prototype grid:
//
//   pred = sum_c coef[b, col, c] * protos[b, p, c]
//   s    = sigmoid(pred)
//   m    = inside(box[b, j], p) ? s : outside_t    (1 for the cos task, else 0)
//   gt   = ds[b, idx[b, col], p]                   (a row gather: exact)
//   sums[b, col] = sum_p loss(m, gt)               (BCE with a 1e-7 log clip,
//                                                   or smooth-L1)
//
// and the backward, by recompute, dcoef = dpred . protos and dprotos =
// dpred^T . coef with dpred = where(inside, g[b, col] * dloss/dm, 0) * s(1-s).
// Everything is f32, products as FFMA on the CUDA cores, as the TPU kernel
// keeps f32 operands with an f32 result.
//
// Bound on an H100 at SSG's main path (batch 8, 544^2: HW = 136^2 = 18496,
// C = 32, k = 100): the grasp launch (T = 4, 400 columns, 96 GT rows) does
// 2*B*KT*HW*C = 3.79 GFLOP, 0.057 ms at the 67 TFLOP/s f32 peak, over about
// 76 MB (0.023 ms at 3.35 TB/s): operations bound it.  The backward needs the
// recompute and two products of the same size, three times that.
//
// Design.  Tiles of 32 columns x 128 pixels; a block of 8 warps computes a
// tile's [32, 128] pred with each thread holding 4 columns x 4 pixels in
// registers, reading the tile's prototypes ([128, 32], contiguous in the
// channels-last layout the model emits, so 16-byte coalesced loads) and its
// coefficients from shared memory.  The GT value of (col, p) is read straight
// from row idx[col] of ds, 32 neighbouring pixels per warp: no one-hot
// product and no padding; the column and pixel edges are masked.  Hopper's
// blocks run in no order, so no sum is carried across blocks:
//   K5:  block (column tile, pixel split, b) sums its pixel chunks into a
//        partial row; a second pass adds the splits in index order.
//   K5b: block (pixel chunk, b) walks every column tile and owns its
//        dprotos rows (no reduction across blocks); block (column tile,
//        pixel split, b) forms dcoef partials, added in index order by a
//        second pass.
// So the results are the same in every run, without atomics.
#include "common.cuh"

namespace crog {

constexpr int kLC = 32;          // prototypes per pixel (the coefficient width)
constexpr int kLCols = 32;       // columns per tile
constexpr int kLPix = 128;       // pixels per chunk
constexpr int kLThreads = 256;   // 8 warps: 4 columns each, 4 pixels per lane
constexpr int kPLd = kLC + 1;    // prototype tile row stride (conflict-free)
constexpr int kDLd = kLPix + 1;  // dpred tile row stride (conflict-free)

struct Lincomb {
  const float* protos;  // [B, HW, C]
  const float* coef;    // [B, KT, C]
  const float* ds;      // [B, TM, HW]
  const int* idx;       // [B, KT]: GT row of each column
  const float* boxes;   // [B, KT / T, 4]: sanitized x1, x2, y1, y2
  int B, HW, pw, KT, TM, T, cos_idx, kind;  // kind 0: BCE, 1: smooth-L1
};

// What a thread needs of its 4 columns.
struct Cols {
  float x1[4], x2[4], y1[4], y2[4], outside[4], g[4];
  int row[4];
  bool valid[4];
};

__device__ __forceinline__ void load_cols(const Lincomb& a, int b, int col0,
                                          const float* g, Cols& st) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + warp * 4 + j;
    st.valid[j] = col < a.KT;
    st.x1[j] = st.x2[j] = st.y1[j] = st.y2[j] = 0.0f;
    st.row[j] = 0;
    st.g[j] = 0.0f;
    st.outside[j] = 0.0f;
    if (!st.valid[j]) continue;
    const float* bx = a.boxes + ((long long)b * (a.KT / a.T) + col / a.T) * 4;
    st.x1[j] = bx[0];
    st.x2[j] = bx[1];
    st.y1[j] = bx[2];
    st.y2[j] = bx[3];
    st.row[j] = a.idx[(long long)b * a.KT + col];
    st.outside[j] = (a.T > 1 && col % a.T == a.cos_idx) ? 1.0f : 0.0f;
    if (g != nullptr) st.g[j] = g[(long long)b * a.KT + col];
  }
}

// sc[32][32] <- coef rows col0.. of image b (0 past the column edge)
__device__ __forceinline__ void load_coef(const Lincomb& a, int b, int col0, float* sc) {
  for (int e = threadIdx.x; e < kLCols * kLC; e += kLThreads) {
    const int col = col0 + e / kLC;
    sc[e] = col < a.KT ? a.coef[((long long)b * a.KT + col) * kLC + e % kLC] : 0.0f;
  }
}

// sp[128][33] <- prototypes of pixels p0.. of image b (0 past the edge)
__device__ __forceinline__ void load_protos(const Lincomb& a, int b, int p0, float* sp) {
  for (int e = threadIdx.x; e < kLPix * kLC / 4; e += kLThreads) {
    const int px = e / (kLC / 4);
    const int c = (e % (kLC / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p0 + px < a.HW)
      v = *reinterpret_cast<const float4*>(
          a.protos + ((long long)b * a.HW + p0 + px) * kLC + c);
    float* d = sp + px * kPLd + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// acc[j][i] = pred of column (warp*4 + j), pixel (lane + 32 i) of the tile
__device__ __forceinline__ void tile_pred(const float* sp, const float* sc,
                                          float acc[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kLC; ++c) {
    float pa[4], cb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = sp[(lane + 32 * i) * kPLd + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) cb[j] = sc[(warp * 4 + j) * kLC + c];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(cb[j], pa[i], acc[j][i]);
  }
}

struct Point {
  float s, m, gt;
  bool inside;
};

__device__ __forceinline__ Point point(const Lincomb& a, int b, const Cols& st, int j,
                                       int px, float pred) {
  Point q;
  q.s = 1.0f / (1.0f + expf(-pred));
  const float xf = (float)(px % a.pw);
  const float yf = (float)(px / a.pw);
  q.inside = xf >= st.x1[j] && xf < st.x2[j] && yf >= st.y1[j] && yf < st.y2[j];
  q.m = q.inside ? q.s : st.outside[j];
  q.gt = a.ds[((long long)b * a.TM + st.row[j]) * a.HW + px];
  return q;
}

__device__ __forceinline__ float point_loss(int kind, float m, float gt) {
  if (kind == 0)
    return -(gt * logf(fmaxf(m, 1e-7f)) + (1.0f - gt) * logf(fmaxf(1.0f - m, 1e-7f)));
  const float d = fabsf(m - gt);
  return d < 1.0f ? 0.5f * d * d : d - 0.5f;
}

// d loss / d pred at one point; 0 outside the box, and 0 where the BCE log
// clip saturates (jnp.maximum's VJP there)
__device__ __forceinline__ float point_dpred(int kind, const Point& q, float g) {
  if (!q.inside) return 0.0f;
  float dldm;
  if (kind == 0) {
    const float m = q.m, gt = q.gt;
    const float up = m > 1e-7f ? gt / fmaxf(m, 1e-7f) : 0.0f;
    const float dn = (1.0f - m) > 1e-7f ? (1.0f - gt) / fmaxf(1.0f - m, 1e-7f) : 0.0f;
    dldm = -(up - dn);
  } else {
    dldm = fminf(fmaxf(q.m - q.gt, -1.0f), 1.0f);
  }
  return g * dldm * q.s * (1.0f - q.s);
}

// K5: grid (column tiles, pixel splits, B); part [splits, B, KT]
__global__ void __launch_bounds__(kLThreads) lincomb_fwd_kernel(Lincomb a, int cps,
                                                                float* part) {
  __shared__ float sp[kLPix * kPLd];
  __shared__ float sc[kLCols * kLC];
  const int col0 = blockIdx.x * kLCols, split = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_coef(a, b, col0, sc);
  Cols st;
  load_cols(a, b, col0, nullptr, st);
  float lsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int nch = (a.HW + kLPix - 1) / kLPix;
  const int ch1 = min((split + 1) * cps, nch);
  for (int ch = split * cps; ch < ch1; ++ch) {
    const int p0 = ch * kLPix;
    __syncthreads();
    load_protos(a, b, p0, sp);
    __syncthreads();
    float acc[4][4];
    tile_pred(sp, sc, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!st.valid[j]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int px = p0 + lane + 32 * i;
        if (px >= a.HW) continue;
        const Point q = point(a, b, st, j, px, acc[j][i]);
        lsum[j] += point_loss(a.kind, q.m, q.gt);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = warp_sum(lsum[j]);
    if (lane == 0 && st.valid[j])
      part[((long long)split * a.B + b) * a.KT + col0 + warp * 4 + j] = v;
  }
}

// K5b, dcoef: grid (column tiles, pixel splits, B); part [splits, B, KT, C]
__global__ void __launch_bounds__(kLThreads) lincomb_dcoef_kernel(Lincomb a,
                                                                  const float* g,
                                                                  int cps, float* part) {
  __shared__ float sp[kLPix * kPLd];
  __shared__ float sc[kLCols * kLC];
  __shared__ float sd[kLCols * kDLd];
  const int col0 = blockIdx.x * kLCols, split = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tc = threadIdx.x / 8, c0 = (threadIdx.x % 8) * 4;  // dcoef outputs
  load_coef(a, b, col0, sc);
  Cols st;
  load_cols(a, b, col0, g, st);
  float dacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int nch = (a.HW + kLPix - 1) / kLPix;
  const int ch1 = min((split + 1) * cps, nch);
  for (int ch = split * cps; ch < ch1; ++ch) {
    const int p0 = ch * kLPix;
    __syncthreads();
    load_protos(a, b, p0, sp);
    __syncthreads();
    float acc[4][4];
    tile_pred(sp, sc, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int px = p0 + lane + 32 * i;
        float dp = 0.0f;
        if (st.valid[j] && px < a.HW)
          dp = point_dpred(a.kind, point(a, b, st, j, px, acc[j][i]), st.g[j]);
        sd[(warp * 4 + j) * kDLd + lane + 32 * i] = dp;
      }
    __syncthreads();
#pragma unroll 4
    for (int px = 0; px < kLPix; ++px) {
      const float d = sd[tc * kDLd + px];
#pragma unroll
      for (int q = 0; q < 4; ++q) dacc[q] = fmaf(d, sp[px * kPLd + c0 + q], dacc[q]);
    }
  }
  if (col0 + tc < a.KT) {
    float* dst = part + (((long long)split * a.B + b) * a.KT + col0 + tc) * kLC + c0;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = dacc[q];
  }
}

// K5b, dprotos: grid (pixel chunks, B); each block owns its dprotos rows
__global__ void __launch_bounds__(kLThreads) lincomb_dprotos_kernel(Lincomb a,
                                                                    const float* g,
                                                                    float* dprotos) {
  __shared__ float sp[kLPix * kPLd];
  __shared__ float sc[kLCols * kLC];
  __shared__ float sd[kLCols * kDLd];
  const int p0 = blockIdx.x * kLPix, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_protos(a, b, p0, sp);
  float out[4][4];  // channel warp*4 + j, pixel lane + 32 i
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[j][i] = 0.0f;
  for (int col0 = 0; col0 < a.KT; col0 += kLCols) {
    __syncthreads();
    load_coef(a, b, col0, sc);
    __syncthreads();
    Cols st;
    load_cols(a, b, col0, g, st);
    float acc[4][4];
    tile_pred(sp, sc, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int px = p0 + lane + 32 * i;
        float dp = 0.0f;
        if (st.valid[j] && px < a.HW)
          dp = point_dpred(a.kind, point(a, b, st, j, px, acc[j][i]), st.g[j]);
        sd[(warp * 4 + j) * kDLd + lane + 32 * i] = dp;
      }
    __syncthreads();
#pragma unroll 4
    for (int col = 0; col < kLCols; ++col) {
      float da[4], cb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sd[col * kDLd + lane + 32 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[j] = sc[col * kLC + warp * 4 + j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) out[j][i] = fmaf(da[i], cb[j], out[j][i]);
    }
  }
  // stage through the prototype tile for coalesced row writes
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sp[(lane + 32 * i) * kPLd + warp * 4 + j] = out[j][i];
  __syncthreads();
  for (int e = threadIdx.x; e < kLPix * kLC; e += kLThreads) {
    const int px = e / kLC;
    if (p0 + px < a.HW)
      dprotos[((long long)b * a.HW + p0 + px) * kLC + e % kLC] = sp[px * kPLd + e % kLC];
  }
}

// out[i] = sum over s of part[s, i], s in index order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int splits, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[(long long)s * n + i];
  out[i] = acc;
}

__host__ int check_args(int B, int HW, int pw, int KT, int TM, int T, int cos_idx,
                        int kind, int splits) {
  if (B < 1 || HW < 1 || pw < 1 || HW % pw || KT < 1 || TM < 1 || T < 1 || KT % T ||
      cos_idx < 0 || kind < 0 || kind > 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

__host__ int sum_splits(const float* part, float* out, int splits, long long n,
                        cudaStream_t stream) {
  const int threads = 256;
  sum_splits_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, out, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace crog

// protos [B, HW, C=32], coef [B, KT, 32], ds [B, TM, HW], boxes [B, KT/T, 4]
// f32; idx [B, KT] int32; part [splits, B, KT] scratch; sums [B, KT].
// kind 0: BCE, 1: smooth-L1.  Each pixel split covers ceil(chunks / splits)
// chunks of 128 pixels.
extern "C" int crog_lincomb_fwd(const float* protos, const float* coef, const float* ds,
                                const int* idx, const float* boxes, float* part,
                                float* sums, int B, int HW, int pw, int KT, int TM,
                                int T, int cos_idx, int kind, int splits, void* stream) {
  using namespace crog;
  int err = check_args(B, HW, pw, KT, TM, T, cos_idx, kind, splits);
  if (err) return err;
  const Lincomb a{protos, coef, ds, idx, boxes, B, HW, pw, KT, TM, T, cos_idx, kind};
  const int nch = (HW + kLPix - 1) / kLPix;
  const int cps = (nch + splits - 1) / splits;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((KT + kLCols - 1) / kLCols, splits, B);
  lincomb_fwd_kernel<<<grid, kLThreads, 0, st>>>(a, cps, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sum_splits(part, sums, splits, (long long)B * KT, st);
}

// As crog_lincomb_fwd, with g [B, KT] the gradient of the sums; part
// [splits, B, KT, 32] scratch; dcoef [B, KT, 32], dprotos [B, HW, 32].
extern "C" int crog_lincomb_bwd(const float* protos, const float* coef, const float* ds,
                                const int* idx, const float* boxes, const float* g,
                                float* part, float* dcoef, float* dprotos, int B, int HW,
                                int pw, int KT, int TM, int T, int cos_idx, int kind,
                                int splits, void* stream) {
  using namespace crog;
  int err = check_args(B, HW, pw, KT, TM, T, cos_idx, kind, splits);
  if (err) return err;
  const Lincomb a{protos, coef, ds, idx, boxes, B, HW, pw, KT, TM, T, cos_idx, kind};
  const int nch = (HW + kLPix - 1) / kLPix;
  const int cps = (nch + splits - 1) / splits;
  auto st = static_cast<cudaStream_t>(stream);
  lincomb_dprotos_kernel<<<dim3(nch, B), kLThreads, 0, st>>>(a, g, dprotos);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((KT + kLCols - 1) / kLCols, splits, B);
  lincomb_dcoef_kernel<<<grid, kLThreads, 0, st>>>(a, g, cps, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sum_splits(part, dcoef, splits, (long long)B * KT * kLC, st);
}
