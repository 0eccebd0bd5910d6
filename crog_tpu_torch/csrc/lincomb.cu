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
//
// What the function needs.  Outside its column's box a point's loss is
// loss(outside_t, gt), which depends on the GT row alone, and its gradient
// is 0.  So
//
//   sums[col] = L[idx[col], outside_t] + sum over inside p of
//               (loss(s, gt) - loss(outside_t, gt))
//
// with L[row, o] = sum over every pixel of loss(o, gt) (one pass over the
// GT rows), and only the points inside a box need the product, the sigmoid
// and the GT value, in the forward and in the backward.  In SSG's train step
// (batch 8, 136^2 prototypes, 100 anchors of an image sharing its 2-4
// objects' boxes) that is about 5% of the points, and bytes bound both
// kernels (the prototypes, the named GT rows, dprotos).  With every box over
// the whole map (the dense case) the grasp launch's backward is
// 3 * 2*B*KT*HW*C = 11.4 GFLOP and operations bound it.
//
// Design.  The map is cut into regions of rh x rw pixels (about 112 for K5,
// 224 for K5b: ops/lincomb.py:region_plan); block (region, b) stages the
// region's prototypes in shared memory once, lists in index order the
// anchors whose box reaches the region, and walks their columns 16 at a
// time (an m-tile: 4 anchors x 4 tasks, or 16 anchors of the mask launch).
// A (16-column, 8-pixel) tile that holds no inside point is skipped before
// any product; the others are taken two at a time, their GT values loaded
// before the product.  Products run on the tensor cores as mma.sync
// m16n8k8 TF32 with the 3xTF32 split (a = hi + lo, hi = cvt.rna.tf32(a);
// hi*hi + hi*lo + lo*hi in f32), which keeps f32 accuracy:
//   pred[16 cols x 8 px] = coef . protos^T          (coef fragments in registers)
//   dcoef[16 x 32]      += dpred . protos            (dpred from the accumulators;
//                                                     the k order is relabelled)
//   dprotos^T[32 x 8]   += coef^T . dpred            (dpred transposed through a
//                                                     16 x 8 tile of shared memory)
// In K5 each warp takes whole m-tiles, so a column's partial is one warp's.
// K5b is one kernel that computes pred and dpred once per point and forms
// both products; its warps split the region's tiles, and the block owns
// the region's dprotos rows, accumulated in shared memory across its
// columns.  Hopper's blocks run in no order, so no sum is carried across
// blocks: each block writes its columns' partial sums (K5) or dcoef
// partials (K5b) for its region, and a second pass adds, for each column,
// the partials of the regions its box reaches in region order.  So the
// results are the same bits in every run, without atomics.  At SSG's main
// path K5 holds 5 blocks per SM (96 registers) and K5b 3 (168 registers, 75
// KB of shared memory): K5's 1360 blocks run in a little over two waves,
// K5b's 680 in one.
#include "common.cuh"
#include "tf32.cuh"  // to_tf32, split_tf32, mma_tf32, mma_3xtf32

namespace crog {

constexpr int kLC = 32;                  // prototypes per pixel (the coefficient width)
constexpr int kLWarps = 4;
constexpr int kLThreads = kLWarps * 32;
constexpr int kLPS = kLC + 4;            // smem row stride of a pixel (conflict-free fragments)
constexpr int kLMT = 16;                 // columns per m-tile

struct Lincomb {
  const float* protos;  // [B, HW, C]
  const float* coef;    // [B, KT, C]
  const float* ds;      // [B, TM, HW]
  const int* idx;       // [B, KT]: GT row of each column
  const float* boxes;   // [B, KT / T, 4]: sanitized x1, x2, y1, y2
  int B, HW, ph, pw, KT, TM, T, cos_idx, kind;  // kind 0: BCE, 1: smooth-L1
  int rh, rw, nrx, nry;                         // regions of rh x rw pixels
};

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], h[i], l[i]);
}

__device__ __forceinline__ float point_loss(int kind, float m, float gt) {
  if (kind == 0)
    return -(gt * logf(fmaxf(m, 1e-7f)) + (1.0f - gt) * logf(fmaxf(1.0f - m, 1e-7f)));
  const float d = fabsf(m - gt);
  return d < 1.0f ? 0.5f * d * d : d - 0.5f;
}

// point_loss(kind, m, gt) with BCE's two logs of m taken beforehand (the
// same operations, so the same bits): for the constant outside_t of a column
__device__ __forceinline__ float point_loss_logs(int kind, float m, float log_m,
                                                 float log_1m, float gt) {
  if (kind == 0) return -(gt * log_m + (1.0f - gt) * log_1m);
  return point_loss(kind, m, gt);
}

// d loss / d pred at an inside point; 0 where the BCE log clip saturates
// (jnp.maximum's VJP there)
__device__ __forceinline__ float point_dpred(int kind, float s, float gt, float g) {
  float dldm;
  if (kind == 0) {
    const float up = s > 1e-7f ? gt / fmaxf(s, 1e-7f) : 0.0f;
    const float dn = (1.0f - s) > 1e-7f ? (1.0f - gt) / fmaxf(1.0f - s, 1e-7f) : 0.0f;
    dldm = -(up - dn);
  } else {
    dldm = fminf(fmaxf(s - gt, -1.0f), 1.0f);
  }
  return g * dldm * s * (1.0f - s);
}

// First pixel index at or past v along an axis of ``size`` pixels: the
// integer pixels p with v1 <= p < v2 are [cell(v1), cell(v2)).  A NaN bound
// maps to ``size``.
__device__ __forceinline__ int cell(float v, int size) {
  return (int)ceilf(fmaxf(fminf(v, (float)size), 0.0f));
}

// Integer pixel rectangle [x1, x2) x [y1, y2) of anchor j's box
struct Cells {
  int x1, x2, y1, y2;
  __device__ bool empty() const { return x1 >= x2 || y1 >= y2; }
};

__device__ __forceinline__ Cells box_cells(const Lincomb& a, int b, int j) {
  const float4 bx = __ldg(reinterpret_cast<const float4*>(a.boxes) +
                          (long long)b * (a.KT / a.T) + j);
  return Cells{cell(bx.x, a.pw), cell(bx.y, a.pw), cell(bx.z, a.ph), cell(bx.w, a.ph)};
}

struct Region {
  int x0, y0, w, h, n;
};

__device__ __forceinline__ Region region_of(const Lincomb& a, int r) {
  Region g;
  g.x0 = (r % a.nrx) * a.rw;
  g.y0 = (r / a.nrx) * a.rh;
  g.w = min(a.rw, a.pw - g.x0);
  g.h = min(a.rh, a.ph - g.y0);
  g.n = g.w * g.h;
  return g;
}

__device__ __forceinline__ bool reaches(const Cells& c, const Region& g) {
  return !c.empty() && c.x1 < g.x0 + g.w && c.x2 > g.x0 && c.y1 < g.y0 + g.h && c.y2 > g.y0;
}

// Shared memory of a region block, carved from the dynamic buffer.
struct RegionSmem {
  float* sp;      // [npad][kLPS] prototypes
  float2* sxy;    // [npad] pixel (x, y); (-1, -1) past the region
  int* spix;      // [npad] pixel index in the map
  int* slist;     // [KT / T] anchors that reach the region, in index order
  int* scount;    // their number
  float* extra;   // what the kernel adds
};

__host__ __device__ inline int region_pad(int rh, int rw) { return round_up(rh * rw, 8); }

__host__ __device__ inline size_t region_smem_base(int rh, int rw, int anchors) {
  const int npad = region_pad(rh, rw);
  return (size_t)npad * kLPS * 4 + (size_t)npad * 12 + (size_t)round_up(anchors + 1, 4) * 4;
}

__device__ __forceinline__ RegionSmem carve(const Lincomb& a, char* buf) {
  const int npad = region_pad(a.rh, a.rw);
  RegionSmem s;
  s.sp = reinterpret_cast<float*>(buf);
  s.sxy = reinterpret_cast<float2*>(s.sp + npad * kLPS);
  s.spix = reinterpret_cast<int*>(s.sxy + npad);
  s.slist = s.spix + npad;
  s.scount = s.slist + a.KT / a.T;
  s.extra = reinterpret_cast<float*>(s.slist + round_up(a.KT / a.T + 1, 4));
  return s;
}

// Warp 0 lists the anchors whose box reaches the region, in index order.
__device__ void list_anchors(const Lincomb& a, int b, const Region& g, const RegionSmem& s) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, anchors = a.KT / a.T;
  int n = 0;
  for (int j0 = 0; j0 < anchors; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < anchors && reaches(box_cells(a, b, j), g);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (hit) s.slist[n + __popc(m & ((1u << lane) - 1u))] = j;
    n += __popc(m);
  }
  if (lane == 0) *s.scount = n;
}

// The region's pixel table and prototypes ([npad][kLPS], 0 past the region)
__device__ void load_region(const Lincomb& a, int b, const Region& g, const RegionSmem& s) {
  const int npad = region_pad(a.rh, a.rw);
  for (int q = threadIdx.x; q < npad; q += kLThreads) {
    if (q < g.n) {
      const int x = g.x0 + q % g.w, y = g.y0 + q / g.w;
      s.spix[q] = y * a.pw + x;
      s.sxy[q] = make_float2((float)x, (float)y);
    } else {
      s.spix[q] = 0;
      s.sxy[q] = make_float2(-1.0f, -1.0f);
    }
  }
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(a.protos) + (long long)b * a.HW * (kLC / 4);
  for (int e = threadIdx.x; e < npad * (kLC / 4); e += kLThreads) {
    const int q = e / (kLC / 4), c = e % (kLC / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q < g.n) v = __ldg(src + (long long)s.spix[q] * (kLC / 4) + c);
    *reinterpret_cast<float4*>(s.sp + q * kLPS + 4 * c) = v;
  }
}

// Column of list position i (anchor slist[i / T], task i % T); -1 past the list
__device__ __forceinline__ int col_at(const Lincomb& a, const RegionSmem& s, int i, int ncol) {
  return i < ncol ? s.slist[i / a.T] * a.T + i % a.T : -1;
}

// What a thread needs of its two columns (m-tile rows g and g + 8).
struct MCols {
  int col[2], row[2];
  float x1[2], x2[2], y1[2], y2[2], out[2], g[2];
};

__device__ __forceinline__ void load_mcols(const Lincomb& a, int b, const RegionSmem& s,
                                           int m0, int ncol, const float* g, MCols& mc) {
  const int gid = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = col_at(a, s, m0 + gid + 8 * h, ncol);
    mc.col[h] = col;
    mc.x1[h] = mc.y1[h] = 1e30f;  // nothing is inside a missing column
    mc.x2[h] = mc.y2[h] = -1e30f;
    mc.row[h] = 0;
    mc.out[h] = mc.g[h] = 0.0f;
    if (col < 0) continue;
    const float4 bx = __ldg(reinterpret_cast<const float4*>(a.boxes) +
                            (long long)b * (a.KT / a.T) + col / a.T);
    mc.x1[h] = bx.x;
    mc.x2[h] = bx.y;
    mc.y1[h] = bx.z;
    mc.y2[h] = bx.w;
    mc.row[h] = __ldg(a.idx + (long long)b * a.KT + col);
    mc.out[h] = (a.T > 1 && col % a.T == a.cos_idx) ? 1.0f : 0.0f;
    if (g != nullptr) mc.g[h] = __ldg(g + (long long)b * a.KT + col);
  }
}

__device__ __forceinline__ float coef_at(const Lincomb& a, int b, int col, int c) {
  return col < 0 ? 0.0f : __ldg(a.coef + ((long long)b * a.KT + col) * kLC + c);
}

// A fragments of pred = coef . protos^T: rows the m-tile's columns, k the
// channels (4 k8 steps), split hi / lo
__device__ __forceinline__ void load_pred_frags(const Lincomb& a, int b, const MCols& mc,
                                                uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v[4] = {coef_at(a, b, mc.col[0], 8 * k + t), coef_at(a, b, mc.col[1], 8 * k + t),
                        coef_at(a, b, mc.col[0], 8 * k + t + 4),
                        coef_at(a, b, mc.col[1], 8 * k + t + 4)};
    split4(v, ah[k], al[k]);
  }
}

__device__ __forceinline__ float gt_at(const Lincomb& a, int b, int row, int pix) {
  return __ldg(a.ds + ((long long)b * a.TM + row) * a.HW + pix);
}

__device__ __forceinline__ bool inside(const MCols& mc, int h, float2 xy) {
  return xy.x >= mc.x1[h] && xy.x < mc.x2[h] && xy.y >= mc.y1[h] && xy.y < mc.y2[h];
}

// Whether the warp's (16-column, 8-pixel) tile at region pixel n0 holds an
// inside point; the thread tests its four points (column g + 8h, pixel
// n0 + 2t + e).
__device__ __forceinline__ bool tile_any(const RegionSmem& s, const MCols& mc, int n0) {
  const int t = threadIdx.x & 3;
  bool any = false;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float2 xy = s.sxy[n0 + 2 * t + e];
    any |= inside(mc, 0, xy) || inside(mc, 1, xy);
  }
  return __any_sync(0xffffffffu, any);
}

// The warp's tiles (first + i * stride) that hold an inside point, as bits i
__device__ __forceinline__ unsigned active_tiles(const RegionSmem& s, const MCols& mc,
                                                 int ntiles, int first, int stride) {
  unsigned m = 0;
  for (int i = 0, nt = first; nt < ntiles; ++i, nt += stride)
    if (tile_any(s, mc, 8 * nt)) m |= 1u << i;
  return m;
}

__device__ __forceinline__ int pop_tile(unsigned& m) {
  const int i = __ffs(m) - 1;
  m &= m - 1;
  return i;
}

// The thread's four points of a tile: inside or not, and the GT value of
// each inside point, loaded before the product so that its latency
// overlaps it.  A tile that is not ``live`` has no inside point.
struct Tile {
  int n0;
  bool in[2][2];
  float gt[2][2];
};

__device__ __forceinline__ void tile_load(const Lincomb& a, int b, const RegionSmem& s,
                                          const MCols& mc, int n0, bool live, Tile& tl) {
  const int t = threadIdx.x & 3;
  tl.n0 = n0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float2 xy = s.sxy[n0 + 2 * t + e];
    const int pix = s.spix[n0 + 2 * t + e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tl.in[h][e] = live && inside(mc, h, xy);
      tl.gt[h][e] = tl.in[h][e] ? gt_at(a, b, mc.row[h], pix) : 0.0f;
    }
  }
}

// pred of two tiles' points, d[u][2h + e] for column g + 8h, pixel 2t + e
// of tile u: the hi*hi, hi*lo and lo*hi terms in separate accumulators, six
// independent mma chains
__device__ __forceinline__ void pair_pred(const RegionSmem& s, const Tile (&tl)[2],
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4], float (&d)[2][4]) {
  const int gid = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float x[2][4], y[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[u][i] = x[u][i] = y[u][i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* p = s.sp + (tl[u].n0 + gid) * kLPS + 8 * k + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(p[0], bh0, bl0);
      split_tf32(p[4], bh1, bl1);
      mma_tf32(x[u], al[k], bh0, bh1);
      mma_tf32(y[u], ah[k], bl0, bl1);
      mma_tf32(d[u], ah[k], bh0, bh1);
    }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[u][i] += x[u][i] + y[u][i];
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The warp's next one or two active tiles, the second a dead copy of the
// first when none is left; returns whether there are two.
__device__ __forceinline__ bool next_pair(const Lincomb& a, int b, const RegionSmem& s,
                                          const MCols& mc, int first, int stride, unsigned& act,
                                          Tile (&tl)[2]) {
  const int i0 = pop_tile(act);
  const bool two = act != 0u;
  const int i1 = two ? pop_tile(act) : i0;
  tile_load(a, b, s, mc, 8 * (first + i0 * stride), true, tl[0]);
  tile_load(a, b, s, mc, 8 * (first + i1 * stride), two, tl[1]);
  return two;
}

// K5 per region: grid (regions, B); part [B, regions, KT]: each listed
// column's sum over its inside points of loss(s, gt) - loss(outside_t, gt).
// Warp w takes the m-tiles w, w + kLWarps, ... over the whole region, so a
// column's sum is one warp's and the warps never wait for each other.
__global__ void __launch_bounds__(kLThreads, 5) lincomb_region_fwd_kernel(Lincomb a, float* part) {
  extern __shared__ __align__(16) char smem[];
  const RegionSmem s = carve(a, smem);
  const int r = blockIdx.x, b = blockIdx.y;
  const Region g = region_of(a, r);
  list_anchors(a, b, g, s);
  __syncthreads();
  const int ncol = *s.scount * a.T;
  if (ncol == 0) return;
  load_region(a, b, g, s);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (g.n + 7) / 8;
  for (int m0 = warp * kLMT; m0 < ncol; m0 += kLWarps * kLMT) {
    MCols mc;
    load_mcols(a, b, s, m0, ncol, nullptr, mc);
    uint32_t ah[4][4], al[4][4];
    load_pred_frags(a, b, mc, ah, al);
    float acc[2] = {0.0f, 0.0f}, log_m[2], log_1m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      log_m[h] = logf(fmaxf(mc.out[h], 1e-7f));
      log_1m[h] = logf(fmaxf(1.0f - mc.out[h], 1e-7f));
    }
    unsigned act = active_tiles(s, mc, ntiles, 0, 1);
    while (act) {
      Tile tl[2];
      next_pair(a, b, s, mc, 0, 1, act, tl);
      float d[2][4];
      pair_pred(s, tl, ah, al, d);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!tl[u].in[h][e]) continue;
            const float gt = tl[u].gt[h][e];
            acc[h] += point_loss(a.kind, sigmoid(d[u][2 * h + e]), gt) -
                      point_loss_logs(a.kind, mc.out[h], log_m[h], log_1m[h], gt);
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], 1);
      acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], 2);
    }
    float* dst = part + ((long long)b * gridDim.x + r) * a.KT;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if ((lane & 3) == 0 && mc.col[h] >= 0) dst[mc.col[h]] = acc[h];
  }
}

// K5b per region: grid (regions, B).  part [B, regions, KT, C]: each listed
// column's dcoef over the region's pixels; dprotos rows of the region,
// every column's share added in list order.
__global__ void __launch_bounds__(kLThreads, 3) lincomb_region_bwd_kernel(Lincomb a,
                                                                       const float* gsum,
                                                                       float* part,
                                                                       float* dprotos) {
  extern __shared__ __align__(16) char smem[];
  const RegionSmem s = carve(a, smem);
  const int r = blockIdx.x, b = blockIdx.y;
  const int npad = region_pad(a.rh, a.rw);
  float* sacc = s.extra;            // [npad][kLPS] dprotos of the region
  float* sred = sacc + npad * kLPS;  // [kLWarps][16][32] dcoef, after a warp's tiles
  // [16 cols][8 px] dpred transposed, during them: the start of the warp's sred
  float* tb = sred + (threadIdx.x >> 5) * kLMT * kLC;
  const Region g = region_of(a, r);
  list_anchors(a, b, g, s);
  for (int e = threadIdx.x; e < npad * kLPS; e += kLThreads) sacc[e] = 0.0f;
  load_region(a, b, g, s);
  __syncthreads();
  const int ncol = *s.scount * a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, t = lane & 3;
  const int ntiles = (g.n + 7) / 8;
  for (int m0 = 0; m0 < ncol; m0 += kLMT) {
    MCols mc;
    load_mcols(a, b, s, m0, ncol, gsum, mc);
    uint32_t ah[4][4], al[4][4];
    load_pred_frags(a, b, mc, ah, al);
    // A fragments of dprotos^T = coef^T . dpred: rows the channels (two m16),
    // k the m-tile's columns (two k8)
    uint32_t ch[2][2][4], cl[2][2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c0 = col_at(a, s, m0 + 8 * kk + t, ncol);
      const int c1 = col_at(a, s, m0 + 8 * kk + t + 4, ncol);
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const float v[4] = {coef_at(a, b, c0, 16 * mm + gid), coef_at(a, b, c0, 16 * mm + gid + 8),
                            coef_at(a, b, c1, 16 * mm + gid), coef_at(a, b, c1, 16 * mm + gid + 8)};
        split4(v, ch[mm][kk], cl[mm][kk]);
      }
    }
    float dc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dc[j][0] = dc[j][1] = dc[j][2] = dc[j][3] = 0.0f;
    unsigned act = active_tiles(s, mc, ntiles, warp, kLWarps);
    while (act) {
      Tile tl[2];
      const bool two = next_pair(a, b, s, mc, warp, kLWarps, act, tl);
      float d[2][4], dp[2][4];
      pair_pred(s, tl, ah, al, d);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dp[u][2 * h + e] = tl[u].in[h][e] ? point_dpred(a.kind, sigmoid(d[u][2 * h + e]),
                                                            tl[u].gt[h][e], mc.g[h])
                                              : 0.0f;
      // dcoef += dpred . protos, k the tile's pixels relabelled: k = t is
      // pixel 2t, k = t + 4 pixel 2t + 1 (the accumulator layout)
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float av[4] = {dp[u][0], dp[u][2], dp[u][1], dp[u][3]};
        split4(av, ph[u], pl[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* p0 = s.sp + (tl[u].n0 + 2 * t) * kLPS + 8 * j + gid;
          mma_3xtf32(dc[j], ph[u], pl[u], p0[0], p0[kLPS]);
        }
      // dprotos^T += coef^T . dpred, dpred transposed through tb; the second
      // tile after the first, which may be the same rows
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
        __syncwarp();
        *reinterpret_cast<float2*>(tb + gid * 8 + 2 * t) = make_float2(dp[u][0], dp[u][1]);
        *reinterpret_cast<float2*>(tb + (gid + 8) * 8 + 2 * t) = make_float2(dp[u][2], dp[u][3]);
        __syncwarp();
        const float bv[2][2] = {{tb[t * 8 + gid], tb[(t + 4) * 8 + gid]},
                                {tb[(t + 8) * 8 + gid], tb[(t + 12) * 8 + gid]}};
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          float* q0 = sacc + (tl[u].n0 + 2 * t) * kLPS + 16 * mm + gid;
          float acc[4] = {q0[0], q0[kLPS], q0[8], q0[kLPS + 8]};
          float xs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bv[kk][0], bh0, bl0);
            split_tf32(bv[kk][1], bh1, bl1);
            mma_tf32(xs, cl[mm][kk], bh0, bh1);
            mma_tf32(xs, ch[mm][kk], bl0, bl1);
            mma_tf32(acc, ch[mm][kk], bh0, bh1);
          }
          q0[0] = acc[0] + xs[0];
          q0[kLPS] = acc[1] + xs[1];
          q0[8] = acc[2] + xs[2];
          q0[kLPS + 8] = acc[3] + xs[3];
        }
      }
    }
    float* red = sred + warp * kLMT * kLC;
    __syncwarp();  // the warp's last reads of tb, which red overlaps
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(red + gid * kLC + 8 * j + 2 * t) = make_float2(dc[j][0], dc[j][1]);
      *reinterpret_cast<float2*>(red + (gid + 8) * kLC + 8 * j + 2 * t) =
          make_float2(dc[j][2], dc[j][3]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kLMT * kLC; e += kLThreads) {
      const int col = col_at(a, s, m0 + e / kLC, ncol);
      if (col < 0) continue;
      float v = sred[e];
#pragma unroll
      for (int w = 1; w < kLWarps; ++w) v += sred[w * kLMT * kLC + e];
      part[(((long long)b * gridDim.x + r) * a.KT + col) * kLC + e % kLC] = v;
    }
    __syncthreads();
  }
  float4* dst = reinterpret_cast<float4*>(dprotos) + (long long)b * a.HW * (kLC / 4);
  for (int e = threadIdx.x; e < g.n * (kLC / 4); e += kLThreads) {
    const int q = e / (kLC / 4), c = e % (kLC / 4);
    dst[(long long)s.spix[q] * (kLC / 4) + c] =
        *reinterpret_cast<const float4*>(sacc + q * kLPS + 4 * c);
  }
}

// L[b, row, o] = sum over the row's pixels of loss(o, gt), o = 0 and 1:
// grid (TM, B), the same order in every run
__global__ void __launch_bounds__(256) lincomb_rowsum_kernel(const float* ds, int HW, int kind,
                                                             float* L) {
  __shared__ float red[2][8];
  const long long row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const float* src = ds + row * HW;
  float l0 = 0.0f, l1 = 0.0f;
  int p0 = 0;
  if ((HW & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int p = threadIdx.x; p < HW / 4; p += 256) {
      const float4 v = __ldg(src4 + p);
      l0 += point_loss(kind, 0.0f, v.x) + point_loss(kind, 0.0f, v.y) +
            point_loss(kind, 0.0f, v.z) + point_loss(kind, 0.0f, v.w);
      l1 += point_loss(kind, 1.0f, v.x) + point_loss(kind, 1.0f, v.y) +
            point_loss(kind, 1.0f, v.z) + point_loss(kind, 1.0f, v.w);
    }
    p0 = HW;
  }
  for (int p = p0 + threadIdx.x; p < HW; p += 256) {
    const float gt = __ldg(src + p);
    l0 += point_loss(kind, 0.0f, gt);
    l1 += point_loss(kind, 1.0f, gt);
  }
  l0 = warp_sum(l0);
  l1 = warp_sum(l1);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = l0;
    red[1][threadIdx.x >> 5] = l1;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = red[threadIdx.x][0];
    for (int w = 1; w < 8; ++w) v += red[threadIdx.x][w];
    L[row * 2 + threadIdx.x] = v;
  }
}

// The regions a column's box reaches, [rx0, rx1] x [ry0, ry1]: exactly the
// regions whose block lists it (reaches()); none for an empty box
struct RegionRange {
  int rx0, rx1, ry0, ry1;
};

__device__ __forceinline__ RegionRange region_range(const Lincomb& a, const Cells& c) {
  if (c.empty()) return RegionRange{0, -1, 0, -1};
  return RegionRange{c.x1 / a.rw, (c.x2 - 1) / a.rw, c.y1 / a.rh, (c.y2 - 1) / a.rh};
}

// sums[b, col] = L[b, idx, outside_t] + the column's region partials, in
// region order: one thread per (b, col)
__global__ void lincomb_sums_kernel(Lincomb a, const float* L, const float* part, float* sums) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.B * a.KT) return;
  const int b = (int)(i / a.KT), col = (int)(i % a.KT);
  const int out = (a.T > 1 && col % a.T == a.cos_idx) ? 1 : 0;
  float v = L[((long long)b * a.TM + a.idx[i]) * 2 + out];
  const RegionRange rr = region_range(a, box_cells(a, b, col / a.T));
  const long long base = (long long)b * a.nrx * a.nry;
  for (int ry = rr.ry0; ry <= rr.ry1; ++ry)
    for (int rx = rr.rx0; rx <= rr.rx1; ++rx)
      v += part[(base + ry * a.nrx + rx) * a.KT + col];
  sums[i] = v;
}

// dcoef[b, col, c] = the column's region partials, in region order: one
// thread per element
__global__ void lincomb_dcoef_sum_kernel(Lincomb a, const float* part, float* dcoef) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.B * a.KT * kLC) return;
  const int c = (int)(i % kLC);
  const long long bc = i / kLC;
  const int b = (int)(bc / a.KT), col = (int)(bc % a.KT);
  const RegionRange rr = region_range(a, box_cells(a, b, col / a.T));
  const long long base = (long long)b * a.nrx * a.nry;
  float v = 0.0f;
  for (int ry = rr.ry0; ry <= rr.ry1; ++ry)
    for (int rx = rr.rx0; rx <= rr.rx1; ++rx)
      v += part[((base + ry * a.nrx + rx) * a.KT + col) * kLC + c];
  dcoef[i] = v;
}

__host__ int make_args(Lincomb& a, int B, int HW, int pw, int KT, int TM, int T, int cos_idx,
                       int kind, int rh, int rw) {
  if (B < 1 || HW < 1 || pw < 1 || HW % pw || KT < 1 || TM < 1 || T < 1 || KT % T ||
      cos_idx < 0 || kind < 0 || kind > 1 || rh < 1 || rw < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // a warp's tiles of a region are the bits of one word (active_tiles);
  // K5's warps each take every tile of the region
  if (region_pad(rh < HW / pw ? rh : HW / pw, rw < pw ? rw : pw) > 8 * 32)
    return (int)cudaErrorInvalidValue;
  a.B = B;
  a.HW = HW;
  a.ph = HW / pw;
  a.pw = pw;
  a.KT = KT;
  a.TM = TM;
  a.T = T;
  a.cos_idx = cos_idx;
  a.kind = kind;
  a.rh = rh < a.ph ? rh : a.ph;
  a.rw = rw < pw ? rw : pw;
  a.nrx = (pw + a.rw - 1) / a.rw;
  a.nry = (a.ph + a.rh - 1) / a.rh;
  return 0;
}

// dynamic shared memory of the region kernels: the region's part, then
// K5b's dprotos rows and [kLWarps][16][32] dcoef
__host__ inline size_t fwd_smem_bytes(int rh, int rw, int anchors) {
  return region_smem_base(rh, rw, anchors);
}

__host__ inline size_t bwd_smem_bytes(int rh, int rw, int anchors) {
  return region_smem_base(rh, rw, anchors) + (size_t)region_pad(rh, rw) * kLPS * 4 +
         (size_t)kLWarps * kLMT * kLC * 4;
}

template <typename K>
__host__ int set_smem(K kernel, size_t bytes) {
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace crog

// protos [B, HW, C=32], coef [B, KT, 32], ds [B, TM, HW], boxes [B, KT/T, 4]
// f32; idx [B, KT] int32; rowsum [B, TM, 2] and part [B, regions, KT]
// scratch; sums [B, KT].  kind 0: BCE, 1: smooth-L1.  Regions of rh x rw
// pixels (ops/lincomb.py:region_plan), ceil(pw / rw) x ceil(ph / rh) of them.
extern "C" int crog_lincomb_fwd(const float* protos, const float* coef, const float* ds,
                                const int* idx, const float* boxes, float* rowsum, float* part,
                                float* sums, int B, int HW, int pw, int KT, int TM, int T,
                                int cos_idx, int kind, int rh, int rw, void* stream) {
  using namespace crog;
  Lincomb a{protos, coef, ds, idx, boxes};
  int err = make_args(a, B, HW, pw, KT, TM, T, cos_idx, kind, rh, rw);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem_bytes(a.rh, a.rw, KT / T);
  err = set_smem(lincomb_region_fwd_kernel, smem);
  if (err) return err;
  lincomb_rowsum_kernel<<<dim3(TM, B), 256, 0, st>>>(ds, HW, kind, rowsum);
  err = (int)cudaGetLastError();
  if (err) return err;
  lincomb_region_fwd_kernel<<<dim3(a.nrx * a.nry, B), kLThreads, smem, st>>>(a, part);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)B * KT;
  lincomb_sums_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, rowsum, part, sums);
  return (int)cudaGetLastError();
}

// As crog_lincomb_fwd, with g [B, KT] the gradient of the sums; part
// [B, regions, KT, 32] scratch; dcoef [B, KT, 32], dprotos [B, HW, 32].
extern "C" int crog_lincomb_bwd(const float* protos, const float* coef, const float* ds,
                                const int* idx, const float* boxes, const float* g,
                                float* part, float* dcoef, float* dprotos, int B, int HW,
                                int pw, int KT, int TM, int T, int cos_idx, int kind, int rh,
                                int rw, void* stream) {
  using namespace crog;
  Lincomb a{protos, coef, ds, idx, boxes};
  int err = make_args(a, B, HW, pw, KT, TM, T, cos_idx, kind, rh, rw);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(a.rh, a.rw, KT / T);
  err = set_smem(lincomb_region_bwd_kernel, smem);
  if (err) return err;
  lincomb_region_bwd_kernel<<<dim3(a.nrx * a.nry, B), kLThreads, smem, st>>>(a, g, part,
                                                                              dprotos);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)B * KT * kLC;
  lincomb_dcoef_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, part, dcoef);
  return (int)cudaGetLastError();
}

// Resources of the two region kernels as the runtime loads them, for
// regions of fwd_rh x fwd_rw and bwd_rh x bwd_rw pixels and ``anchors``
// anchors: out[0..3] K5's registers, shared memory per CTA (static +
// dynamic), local bytes per thread, CTAs per SM; out[4..7] K5b's.
extern "C" int crog_lincomb_attrs(int anchors, int fwd_rh, int fwd_rw, int bwd_rh, int bwd_rw,
                                  int* out) {
  using namespace crog;
  const size_t fwd = fwd_smem_bytes(fwd_rh, fwd_rw, anchors);
  const size_t bwd = bwd_smem_bytes(bwd_rh, bwd_rw, anchors);
  int err = set_smem(lincomb_region_fwd_kernel, fwd);
  if (!err) err = set_smem(lincomb_region_bwd_kernel, bwd);
  for (int i = 0; i < 2 && !err; ++i) {
    cudaFuncAttributes fa;
    const void* k =
        i ? (const void*)lincomb_region_bwd_kernel : (const void*)lincomb_region_fwd_kernel;
    const size_t dyn = i ? bwd : fwd;
    err = (int)cudaFuncGetAttributes(&fa, k);
    int blocks = 0;
    if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kLThreads, dyn);
    out[4 * i] = fa.numRegs;
    out[4 * i + 1] = (int)(fa.sharedSizeBytes + dyn);
    out[4 * i + 2] = (int)fa.localSizeBytes;
    out[4 * i + 3] = blocks;
  }
  return err;
}
