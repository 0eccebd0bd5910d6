// K4b: the CROG decoder FFN backward, one kernel plus two fixed-order sums.
//
// Replaces crog_tpu/ops/pallas_ffn.py:226 `_fused_ffn_bwd_vjp` (pallas_call
// at :234, kernel `_bwd_kernel` :97): per row tile it regenerates the
// dropout mask and recomputes the hidden from x (FLOPs are cheap, bytes are
// not), then
//   dhn = bf16(dy) W2                                (f32 sums)
//   dh  = LN backward of dhn; dh = drop(dh); dh = dh * (h > 0); dh = bf16(dh)
//   dx  = bf16(dh W1)
// and emits dx, dh and hn = bf16(LN(h)) (both read by the weight-gradient
// products dW1 = dh^T x and dW2 = dy^T hn, which stay library GEMMs outside
// the kernel, bf16 with f32 results, as the JAX package leaves them to XLA),
// plus per-block partial column sums of db1 (of the rounded dh), dgamma,
// dbeta and db2 (of dy in f32), summed in a fixed order by a second pass:
// the same gradient in every run.
//
// Bound on an H100 at M = 24*676 = 16224: 3 products of 2*M*512*2048 flops
// (the hidden recompute, dhn, dx) = 102 GFLOP, over 2 x 66 MB of dh and hn
// written plus 50 MB in: about 0.10 ms, limited by the tensor cores.
//
// Design: one block of 8 warps takes 32 rows and keeps their [32, 2048]
// hidden in shared memory (128 KB), as the forward (ffn.cu) does.  The LN
// backward needs two row means over all 2048 columns of dhn before any dh,
// and [32, 2048] f32 does not fit beside the hidden, so dhn is produced 256
// columns at a time twice: the first sweep takes the row means and the
// dgamma/dbeta partials, the second forms dh and writes it over the hidden
// column chunk it came from; dx then streams W1 against the resident dh.
#include "gemm.cuh"

namespace crog {

constexpr int kBD = 512;    // model width
constexpr int kBF = 2048;   // hidden width
constexpr int kBM = 32;     // rows per block
constexpr int kBK = 32;     // K step
constexpr int kBN = 256;    // column chunk of the hidden
constexpr int kBXLd = kBD + 8;
constexpr int kBHLd = kBF + 8;
constexpr int kBW1Ld = kBK + 8;   // recompute: W1 tile [256, 32]
constexpr int kBW2Ld = kBN + 8;   // dhn: W2 tile [32, 256]
constexpr int kBWxLd = kBD + 8;   // dx: W1 tile [32, 512]
constexpr int kBSLd = kBN + 4;    // f32 staging of a chunk
constexpr int kBOLd = kBD + 4;    // f32 staging of dx
constexpr float kBEps = 1e-5f;

constexpr size_t kBXBytes = (size_t)kBM * kBXLd * sizeof(bf16);
constexpr size_t kBHBytes = (size_t)kBM * kBHLd * sizeof(bf16);
constexpr size_t kBRBytes = (size_t)kBM * kBWxLd * sizeof(bf16);
constexpr size_t kFfnBwdSmem = kBXBytes + kBHBytes + kBRBytes + 4 * kBM * sizeof(float);

static_assert((size_t)kBN * kBW1Ld * sizeof(bf16) <= kBRBytes, "w1 tile");
static_assert((size_t)kBK * kBW2Ld * sizeof(bf16) <= kBRBytes, "w2 tile");
static_assert((size_t)kBM * kBSLd * sizeof(float) <= kBRBytes, "chunk staging");
static_assert((size_t)kBM * kBOLd * sizeof(float) <= kBHBytes, "dx staging");
static_assert(kBXBytes % 128 == 0 && kBHBytes % 128 == 0 && kBRBytes % 128 == 0,
              "region alignment");

// dhn[:, n0:n0+256] = dy_tile W2[:, n0:n0+256] into st (f32, ld kBSLd)
__device__ __forceinline__ void ffn_dhn_chunk(const bf16* xs, const bf16* __restrict__ w2,
                                              bf16* wt, float* st, int n0, int warp) {
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < kBD; k0 += kBK) {
    for (int v = threadIdx.x; v < kBK * (kBN / 8); v += 256) {
      const int r = v / (kBN / 8);
      const int c = (v % (kBN / 8)) * 8;
      copy8(wt + r * kBW2Ld + c, w2 + (long long)(k0 + r) * kBF + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (i * 16) * kBXLd + k0 + kk, kBXLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], wt + kk * kBW2Ld + warp * 32 + j * 16, kBW2Ld);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(st + (i * 16) * kBSLd + warp * 32 + j * 16, acc[i][j],
                              kBSLd, wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(256) ffn_bwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ g, const float* __restrict__ be,
    const bf16* __restrict__ w2, const bf16* __restrict__ dy, bf16* __restrict__ dx,
    bf16* __restrict__ dh_out, bf16* __restrict__ hn_out, float* __restrict__ part,
    int M, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // x tile, then dy tile
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + kBXBytes);  // h, then dh
  unsigned char* region = smem_raw + kBXBytes + kBHBytes;
  bf16* wt = reinterpret_cast<bf16*>(region);
  float* st = reinterpret_cast<float*>(region);
  float* rs = reinterpret_cast<float*>(region + kBRBytes);  // mu, rstd, m1, m2
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* prow = part + (long long)blockIdx.x * (3 * kBF + kBD);

  // ---- recompute h = drop(relu(bf16(x W1^T + b1))) into hs (as ffn.cu)
  for (int v = threadIdx.x; v < kBM * (kBD / 8); v += 256) {
    const int r = v / (kBD / 8);
    const int c = (v % (kBD / 8)) * 8;
    if (m0 + r < M) {
      copy8(xs + r * kBXLd + c, x + (long long)(m0 + r) * kBD + c);
    } else {
      zero8(xs + r * kBXLd + c);
    }
  }
  for (int n0 = 0; n0 < kBF; n0 += kBN) {
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < kBD; k0 += kBK) {
      for (int v = threadIdx.x; v < kBN * (kBK / 8); v += 256) {
        const int r = v / (kBK / 8);
        const int c = (v % (kBK / 8)) * 8;
        copy8(wt + r * kBW1Ld + c, w1 + (long long)(n0 + r) * kBD + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        FragA fa[2];
        FragBCol fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], xs + (i * 16) * kBXLd + k0 + kk, kBXLd);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], wt + (warp * 32 + j * 16) * kBW1Ld + kk, kBW1Ld);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(st + (i * 16) * kBSLd + warp * 32 + j * 16, acc[i][j],
                                kBSLd, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < kBM * kBN; e += 256) {
      const int r = e / kBN;
      const int c = e % kBN;
      const float h = bf2f(f2bf(st[r * kBSLd + c] + b1[n0 + c]));
      hs[r * kBHLd + n0 + c] = f2bf(dropout_apply(drop, m0 + r, n0 + c, fmaxf(h, 0.0f)));
    }
    __syncthreads();
  }

  // ---- LN statistics per row; hn = bf16(LN(h)) out
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    const bf16* hr = hs + r * kBHLd;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < kBF; c += 32) {
      const float h = bf2f(hr[c]);
      s += h;
      ss += h * h;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / kBF;
    const float rstd = rsqrtf(fmaxf(0.f, ss / kBF - mu * mu) + kBEps);
    if (lane == 0) {
      rs[r] = mu;
      rs[kBM + r] = rstd;
    }
    if (m0 + r < M) {
      bf16* out = hn_out + (long long)(m0 + r) * kBF;
      for (int c = lane; c < kBF; c += 32)
        out[c] = f2bf((bf2f(hr[c]) - mu) * rstd * g[c] + be[c]);
    }
  }

  // ---- dy tile over the x tile; db2 partial (dy in f32)
  __syncthreads();
  for (int v = threadIdx.x; v < kBM * (kBD / 8); v += 256) {
    const int r = v / (kBD / 8);
    const int c = (v % (kBD / 8)) * 8;
    if (m0 + r < M) {
      copy8(xs + r * kBXLd + c, dy + (long long)(m0 + r) * kBD + c);
    } else {
      zero8(xs + r * kBXLd + c);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kBD; c += 256) {
    float s = 0.f;
    for (int r = 0; r < kBM; ++r) s += bf2f(xs[r * kBXLd + c]);
    prow[3 * kBF + c] = s;
  }

  // ---- sweep 1: row means m1 = mean(dhn g), m2 = mean(dhn g hhat); the
  // dgamma / dbeta partials
  float m1a[4] = {0.f, 0.f, 0.f, 0.f}, m2a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < kBF; n0 += kBN) {
    ffn_dhn_chunk(xs, w2, wt, st, n0, warp);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = warp * 4 + q;
      const float mu = rs[r], rstd = rs[kBM + r];
      float a1 = 0.f, a2 = 0.f;
      for (int c = lane; c < kBN; c += 32) {
        const float hh = (bf2f(hs[r * kBHLd + n0 + c]) - mu) * rstd;
        const float dhh = st[r * kBSLd + c] * g[n0 + c];
        a1 += dhh;
        a2 += dhh * hh;
      }
      m1a[q] += warp_sum(a1);
      m2a[q] += warp_sum(a2);
    }
    {
      const int c = threadIdx.x;  // 256 threads, 256 columns
      float dg = 0.f, dbe = 0.f;
      for (int r = 0; r < kBM; ++r) {
        const float dhn = st[r * kBSLd + c];
        const float hh = (bf2f(hs[r * kBHLd + n0 + c]) - rs[r]) * rs[kBM + r];
        dg += dhn * hh;
        dbe += dhn;
      }
      prow[kBF + n0 + c] = dg;
      prow[2 * kBF + n0 + c] = dbe;
    }
    __syncthreads();
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rs[2 * kBM + warp * 4 + q] = m1a[q] / kBF;
      rs[3 * kBM + warp * 4 + q] = m2a[q] / kBF;
    }
  }
  __syncthreads();

  // ---- sweep 2: dh over the hidden, chunk by chunk; db1 partial
  for (int n0 = 0; n0 < kBF; n0 += kBN) {
    ffn_dhn_chunk(xs, w2, wt, st, n0, warp);
    for (int e = threadIdx.x; e < kBM * kBN; e += 256) {
      const int r = e / kBN;
      const int c = e % kBN;
      bf16* hp = hs + r * kBHLd + n0 + c;
      const float h = bf2f(*hp);
      const float hh = (h - rs[r]) * rs[kBM + r];
      float d = rs[kBM + r] * (st[r * kBSLd + c] * g[n0 + c] - rs[2 * kBM + r] -
                               hh * rs[3 * kBM + r]);
      if (drop.thresh) d = dropout_keep(drop, m0 + r, n0 + c) ? d * drop.scale : 0.f;
      const bf16 db = f2bf(h > 0.f ? d : 0.f);
      *hp = db;
      if (m0 + r < M) dh_out[(long long)(m0 + r) * kBF + n0 + c] = db;
    }
    __syncthreads();
    {
      const int c = threadIdx.x;
      float s = 0.f;
      for (int r = 0; r < kBM; ++r) s += bf2f(hs[r * kBHLd + n0 + c]);
      prow[n0 + c] = s;
    }
  }
  __syncthreads();

  // ---- dx = bf16(dh W1); warp w owns columns [64w, 64w+64)
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < kBF; k0 += kBK) {
    for (int v = threadIdx.x; v < kBK * (kBD / 8); v += 256) {
      const int r = v / (kBD / 8);
      const int c = (v % (kBD / 8)) * 8;
      copy8(wt + r * kBWxLd + c, w1 + (long long)(k0 + r) * kBD + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], hs + (i * 16) * kBHLd + k0 + kk, kBHLd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBRow fb;
        wmma::load_matrix_sync(fb, wt + kk * kBWxLd + warp * 64 + j * 16, kBWxLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* st2 = reinterpret_cast<float*>(hs);  // dh is consumed
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(st2 + (i * 16) * kBOLd + warp * 64 + j * 16, acc[i][j],
                              kBOLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBD; e += 256) {
    const int r = e / kBD;
    const int c = e % kBD;
    if (m0 + r < M) dx[(long long)(m0 + r) * kBD + c] = f2bf(st2[r * kBOLd + c]);
  }
}

}  // namespace crog

// t: table of device pointers, in order
//   0 x [M, 512] bf16, 1 w1 [2048, 512] bf16, 2 b1, 3 gamma, 4 beta [2048]
//   f32, 5 w2 [512, 2048] bf16, 6 dy [M, 512] bf16;
//   outputs 7 dx [M, 512], 8 dh [M, 2048], 9 hn [M, 2048] bf16,
//   10 rows f32 [3, 2048] (db1, dgamma, dbeta), 11 db2 f32 [512];
//   workspace 12 part f32 [ceil(M/32), 3*2048 + 512].
extern "C" int crog_ffn_bwd(void* const* t, int M, int D, int F, unsigned seed,
                            unsigned thresh, float scale, void* stream) {
  using crog::bf16;
  if (D != crog::kBD || F != crog::kBF || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      crog::ffn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)crog::kFfnBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + crog::kBM - 1) / crog::kBM;
  float* part = static_cast<float*>(t[12]);
  crog::ffn_bwd_kernel<<<blocks, 256, crog::kFfnBwdSmem, st>>>(
      static_cast<const bf16*>(t[0]), static_cast<const bf16*>(t[1]),
      static_cast<const float*>(t[2]), static_cast<const float*>(t[3]),
      static_cast<const float*>(t[4]), static_cast<const bf16*>(t[5]),
      static_cast<const bf16*>(t[6]), static_cast<bf16*>(t[7]), static_cast<bf16*>(t[8]),
      static_cast<bf16*>(t[9]), part, M, crog::Dropout{seed, thresh, scale});
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long stride = 3LL * F + D;
  err = crog::launch_reduce(part, blocks, stride, 3LL * F, static_cast<float*>(t[10]),
                            nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)crog::launch_reduce(part + 3LL * F, blocks, stride, D,
                                  static_cast<float*>(t[11]), nullptr, st);
}
