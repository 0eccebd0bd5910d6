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
// K6 design.  Its bound is its bytes, so each CTA keeps the tensor cores
// fed from loads that run behind the products:
//   - The grid is persistent: about one CTA per SM (ops/s2dconv.py:
//     fwd_schedule, a function of the shapes alone), each walking a fixed
//     contiguous range of 8 x 16 cell tiles for one column slice of the
//     output.  Each output element is summed by one CTA in a fixed order,
//     so every run gives the same bits.
//   - The CTA's slice of the packed weight stays resident in shared memory
//     for its whole range, loaded once by TMA (128-byte swizzled [16ci][64]
//     column chunks).  The slice is 128 KB: 128 columns at ci = 32 (the
//     whole weight of conv2, half of conv3's forward) and 64 columns at ci
//     = 64 (half of conv3's dgrad), whose full [1024, 128] weight (256 KB)
//     cannot sit beside a ring.  Halving N was chosen over streaming the
//     weight through the ring (256 KB per tile through shared memory, five
//     times the halo) and over a cluster sharing the halo by multicast (the
//     two CTAs of a tile range read the same halo boxes at the same time,
//     so the second read comes from L2, not device memory).
//   - The halo streams through a ring of 4 stages, each one 64-channel TMA
//     box of a tile's 10 x 18 cell halo (23 KB; coordinates off the image
//     read zeros: no padded copy, no masking), with a `full` mbarrier (its
//     bytes) and an `empty` one (every warp has read it): 2 boxes per tile
//     at ci = 32, 4 at ci = 64, so the loads run one or two tiles ahead.
//     One thread refills a stage while the products of the next run.
//   - The products run on wgmma m64nNk16 with A from registers: warp w
//     holds tile row w's 16 cells, and a 16-cell row segment of the patch's
//     (t, s) block is a row-major [16, 16] matrix in the halo, so one
//     ldmatrix per k-step gathers it (the swizzle keeps it conflict-free).
//     The k-steps run chunk by chunk: the 16 that read a chunk (the (t, s)
//     blocks whose slot it holds), B the weight rows through a descriptor.
//   - The epilogue rounds to bf16 in registers; four shuffles per quad turn
//     the fragments into 16-byte row segments, stored straight to y.
// The dgrad is the same kernel on dy with the flipped, ci/co-swapped
// weight.  Shared memory: 128 KB of weight + 4 x 23 KB of ring, one CTA
// per SM.
//
// K6b: the packed gradient is [16ci, 4co] = KB x NB blocks of [128, 128]
// (KB = ci/8 row blocks, each within one slot-row t; NB = co/32 column
// blocks), and every block sums over every cell of the batch.  Its bound is
// its bytes, so the design first makes each activation byte cross device
// memory once, with the loads behind the products:
//   - A thread-block cluster holds all KB x NB blocks (4 CTAs for conv2, 8
//     for conv3; at most 8, so ci = co = 64 takes two clusters per tile
//     column pair).  For each 8 x 16 cell tile the cluster's CTAs issue
//     between them one TMA load of each 64-channel chunk of the tile's
//     10 x 18 cell halo (coordinates off the image read zeros: no padded
//     copy, no masking) and of the dy tile, each multicast to the CTAs that
//     read it (the slot pair of their t; the dy columns of their block):
//     each activation byte leaves device memory once per tile.
//   - The loads land in a ring of 3 stages (2 for ci = 64), each with a
//     `full` mbarrier (the TMA bytes) and an `empty` one: a CTA that has
//     read a stage arrives remotely on the `empty` barrier of each CTA whose
//     chunks it receives, and a CTA refills a stage (tile m + 2, issued
//     while tile m's products run) once every CTA it feeds has released
//     it.  No CTA waits for the whole cluster inside the loop: a cluster
//     barrier per tile held every CTA to the slowest one.
//   - The products run on wgmma: two warpgroups, each [64 packed rows,
//     128 columns] of f32 sums in registers, one m64n128k16 per cell row of
//     the tile.  A (channel x cell) is read from the halo with
//     ldmatrix.trans into registers: the gather costs nothing, and the
//     128-byte swizzle of the TMA boxes keeps it conflict-free.  B (cell x
//     column) is the dy stage itself, read by the tensor cores through a
//     descriptor of the swizzled, column-major box (mma.sync, with B
//     through ldmatrix too, was slower per tile).
//   - The grid is persistent: as many clusters as 120 SMs hold at one CTA
//     per SM (an H100 holds 30 clusters of 4 or 15 of 8 at once), each
//     walking a fixed contiguous range of tiles (a function of the shapes
//     alone, ops/s2dconv.py:wgrad_schedule) and writing one f32 partial of
//     the packed gradient; a second pass adds the partials in index order
//     (gemm.cuh:launch_reduce): 30 partials for conv2 and 15 for conv3
//     (the split design wrote 65 and 33), the same bits in every run, no
//     atomics.
// The structural zeros of the packed weight get their (nonzero, unused)
// gradient as in the twin, so the products are 16/9 of the real taps.  On
// an H100 it takes about as long as cuDNN's conv2d_weight of the blocked
// conv, several times its byte bound (PERF.md, PR 5): the loads' latency
// through the ring, not the products, sets its pace.
//
// Limits: ci, co in {32, 64}, bf16 activations, any B, H, W (edges masked).
#include "gemm.cuh"
#include "sm90.cuh"

namespace crog {

constexpr int kSR = 8;          // cell rows per tile
constexpr int kSW = 16;         // cell columns per tile: one fragment's 16 rows
constexpr int kSHR = kSR + 2;   // halo rows
constexpr int kSHC = kSW + 2;   // halo columns
constexpr int kSN = 128;        // K6b: packed-gradient columns per CTA
constexpr int kSThreads = 256;  // K6: 8 warps, two warpgroups

__host__ __device__ constexpr int ofs(int t) { return (t >> 1) + (t & 1); }
__host__ __device__ constexpr int dslot(int t) { return (t + 1) & 1; }

// K6's and K6b's TMA boxes: a 64-channel chunk of a tile's halo [10][18][64] and of
// its dy tile [8][16][64], each at a 1024-byte aligned offset (the 128-byte
// swizzle repeats every 8 rows of 128 bytes)
constexpr int kWxBox = 23552;  // 10 * 18 * 128 bytes, rounded up to 1024
constexpr int kWxBoxTx = kSHR * kSHC * 128;
constexpr int kWdBox = kSR * kSW * 128;  // 16384
constexpr int kWThreads = 256;
template <int CI>
__host__ __device__ constexpr int wg_stages() { return CI == 32 ? 3 : 2; }
template <int CI>
__host__ __device__ constexpr int wg_stage_bytes() { return (CI / 32) * kWxBox + 2 * kWdBox; }
template <int CI>
__host__ __device__ constexpr size_t wgrad_smem_bytes() {
  return (size_t)wg_stages<CI>() * wg_stage_bytes<CI>() + 1024 + 16 * wg_stages<CI>();
}

// K6's shared memory: the CTA's resident weight slice (kFwN columns of the
// packed [16ci, 4co] weight: kFwN / 64 column chunks of [16ci][64], each
// 128-byte swizzled, 128 KB for either ci), then a ring of kFwStages halo
// chunks (one 64-channel TMA box of a tile's 10 x 18 cell halo each), then
// the ring's full and empty mbarriers and the weight's
template <int CI>
__host__ __device__ constexpr int fwd_cols() { return CI == 32 ? 128 : 64; }
constexpr int kFwWBytes = 131072;
constexpr int kFwStages = 4;
constexpr size_t kFwSmem = kFwWBytes + kFwStages * kWxBox + 1024 + 8 * (2 * kFwStages + 1);

// k-step i (0..15) of halo chunk q, i.e. 16 packed rows that read chunk q:
// slot-row t, slot-column s, the first channel within the chunk and the
// first packed weight row.  ci = 32: chunk q holds slots (q, 0) and (q, 1),
// read by the 8 blocks (t, s) with DY[t] = q, two k-steps each; ci = 64:
// chunk q is slot (q >> 1, q & 1), read by 4 blocks, four k-steps each.
template <int CI>
__device__ __forceinline__ void fwd_kstep(int q, int i, int& t, int& s, int& ch, int& row) {
  if (CI == 32) {
    t = 2 * (i >> 3) + 1 - q;
    s = (i >> 1) & 3;
    ch = dslot(s) * 32 + (i & 1) * 16;
    row = (t * 4 + s) * 32 + (i & 1) * 16;
  } else {
    t = 2 * (i >> 3) + 1 - (q >> 1);
    s = 2 * ((i >> 2) & 1) + 1 - (q & 1);
    ch = (i & 3) * 16;
    row = (t * 4 + s) * 64 + (i & 3) * 16;
  }
}

template <int NC>
__device__ __forceinline__ void fwd_wgmma(float (&acc)[NC / 2], const uint32_t (&a)[4],
                                          uint64_t desc) {
  if constexpr (NC == 128) {
    wgmma_m64n128k16_rs(acc, a, desc);
  } else {
    wgmma_m64n64k16_rs(acc, a, desc);
  }
}

template <int CI>
__global__ void __launch_bounds__(kSThreads, 1) s2dconv_fwd_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    bf16* __restrict__ y, int H, int W, int N, int tiles, int per) {
  constexpr int NC = fwd_cols<CI>();
  constexpr int CPT = CI / 16;  // 64-channel halo chunks per tile (4ci / 64)
  constexpr int S = kFwStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm + kFwWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kWxBox);  // a chunk has landed
  uint64_t* empty = full + S;  // every warp has read a chunk into registers
  uint64_t* wbar = empty + S;  // the weight slice has landed

  const int nh = N / NC;  // CTAs per tile range, one per column slice
  const int col0 = (blockIdx.x % nh) * NC;
  const int tb = (blockIdx.x / nh) * per;
  const int count = min(tiles, tb + per) - tb;
  const int total = count * CPT;
  const int ntx = (W + kSW - 1) / kSW;
  const int nty = (H + kSR - 1) / kSR;
  const CUtensorMap* xm = &xmap;
  auto fetch = [&](int c) {  // chunk c: tile tb + c / CPT, channels (c % CPT) * 64..
    const int tile = tb + c / CPT;
    const int bi = tile / (nty * ntx);
    const int rem = tile % (nty * ntx);
    uint64_t* bar = &full[c % S];
    mbar_arrive_expect_tx(bar, kWxBoxTx);
    tma_load_4d(xm, smem_u32(ring + (c % S) * kWxBox), bar, (c % CPT) * 64,
                (rem % ntx) * kSW - 1, (rem / ntx) * kSR - 1, bi);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSThreads / 32);
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(wbar, kFwWBytes);
    for (int wc = 0; wc < NC / 64; ++wc)
      for (int r = 0; r < 16 * CI; r += 256)
        tma_load_2d(&wmap, smem_u32(sm + wc * (16 * CI * 128) + r * 128), wbar,
                    col0 + wc * 64, r);
    for (int c = 0; c < min(S, total); ++c) fetch(c);
  }

  // warp w (warpgroup w / 4) holds the 16 cells of tile row w: its A rows
  // are halo cells (w + OFS[t], OFS[s] + m), m = 0..15
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a_cell = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_hi = lane >> 4;
  const uint32_t wbase = smem_u32(sm);
  float acc[NC / 2];
#pragma unroll
  for (int e = 0; e < NC / 2; ++e) acc[e] = 0.0f;
  mbar_wait(wbar, 0);

#pragma unroll 1
  for (int c = 0; c < total; ++c) {
    const int q = c % CPT;
    mbar_wait(&full[c % S], (c / S) & 1);
    const uint32_t st = smem_u32(ring + (c % S) * kWxBox);
    uint32_t a[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int t, s, ch, row;
      fwd_kstep<CI>(q, i, t, s, ch, row);
      const int la = (warp + ofs(t)) * kSHC + ofs(s) + a_cell;  // halo cell: 128-byte line
      ldsm_x4(st + la * 128 + ((((ch >> 3) + a_hi) ^ (la & 7)) << 4), a[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[c % S]);  // the chunk is in registers
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int t, s, ch, row;
      fwd_kstep<CI>(q, i, t, s, ch, row);
      fwd_wgmma<NC>(acc, a[i], wgmma_desc_sw128(wbase + row * 128, 16 * CI * 128, 8 * 128));
    }
    wgmma_commit();
    // while the products run: refill chunk c - 1's stage with chunk c - 1 + S
    // once every warp has read it
    if (threadIdx.x == 0 && c > 0 && c - 1 + S < total) {
      mbar_wait(&empty[(c - 1) % S], ((c - 1) / S) & 1);
      fetch(c - 1 + S);
    }
    __syncwarp();
    wgmma_wait_all();
    if (q != CPT - 1) continue;

    // epilogue of tile tb + c / CPT: bf16, 16-byte stores.  Per pair of 8-column
    // fragments a quad holds four 16-byte row segments (rows g, g + 8 of each
    // fragment); four shuffles give each of its threads one whole segment.
    const int tile = tb + c / CPT;
    const int bi = tile / (nty * ntx);
    const int rem = tile % (nty * ntx);
    const int gr = (rem / ntx) * kSR + warp;
    const int qi = lane & 3;
    const int cell = (rem % ntx) * kSW + (lane >> 2) + 8 * (qi & 1);
    bf16* out = y + (((long long)bi * H + gr) * W + cell) * N + col0;
    const bool ok = gr < H && cell < W;
#pragma unroll
    for (int j = 0; j < NC / 8; j += 2) {
      const uint32_t v[4] = {pack_bf16(acc[4 * j], acc[4 * j + 1]),
                             pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                             pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                             pack_bf16(acc[4 * j + 6], acc[4 * j + 7])};
      const uint4 seg = quad_gather16(v);
      if (ok) *reinterpret_cast<uint4*>(out + (j + (qi >> 1)) * 8) = seg;
    }
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) acc[e] = 0.0f;
  }
}

// The cluster of K6b: KB row blocks x NBC column blocks of the packed
// gradient, rank r = kb + KB * nbl.
template <int CI>
struct WgCluster {
  static constexpr int KB = CI / 8;     // [128, .] row blocks of the packed gradient
  static constexpr int XB = CI / 32;    // 64-channel halo chunks of one slot pair
  static constexpr int XQ = 2 * XB;     // 64-channel chunks of a whole cell (4ci)
  int nbc;                              // column blocks per cluster
  __host__ __device__ explicit WgCluster(int nb) : nbc(nb < 8 / KB ? nb : 8 / KB) {}
  __host__ __device__ int size() const { return KB * nbc; }
  __host__ __device__ static int slot_row(int kb) { return kb * 128 / (4 * CI); }
};

template <int CI>
__global__ void __launch_bounds__(kWThreads, 1) s2dconv_wgrad_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
    float* __restrict__ part, int H, int W, int N, int tiles, int clusters, int per) {
  using C = WgCluster<CI>;
  constexpr int S = wg_stages<CI>();
  constexpr int STAGE = wg_stage_bytes<CI>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * STAGE);  // a stage has landed
  uint64_t* empty = full + S;  // every CTA this one feeds is done with a stage

  const C cl(N / kSN);
  const int R = cl.size();
  const int rank = (int)cluster_rank();
  const int cid = blockIdx.x / R;
  const int g = cid % clusters;  // the partial this cluster writes
  const int ng = cid / clusters; // its column group (ci = co = 64 only)
  const int kb = rank % C::KB;
  const int nbl = rank / C::KB;
  const int nb = ng * cl.nbc + nbl;
  const int t = C::slot_row(kb);
  const int k0 = kb * 128 - t * 4 * CI;  // first packed row within slot-row t
  const int tb = g * per;
  const int count = min(tiles, tb + per) - tb;
  const int ntx = (W + kSW - 1) / kSW;
  const int nty = (H + kSR - 1) / kSR;

  // multicast masks: the halo chunks of slot pair p go to the CTAs whose t
  // reads p; the dy chunks of column block nbl to that block's CTAs
  uint16_t xmask[2] = {0, 0}, dmask[2] = {0, 0};
  for (int r = 0; r < R; ++r) {
    xmask[dslot(C::slot_row(r % C::KB))] |= (uint16_t)(1u << r);
    dmask[r / C::KB] |= (uint16_t)(1u << r);
  }
  const int nq = C::XQ + 2 * cl.nbc;  // chunks per tile, issued round-robin by rank
  auto chunk_mask = [&](int q) -> uint32_t {
    return q < C::XQ ? xmask[q / C::XB] : dmask[(q - C::XQ) / 2];
  };
  uint32_t feeds = 0, fed_by = 0;  // the CTAs this one's chunks go to; whose come here
  for (int q = 0; q < nq; ++q) {
    if (q % R == rank) feeds |= chunk_mask(q);
    if ((chunk_mask(q) >> rank) & 1) fed_by |= 1u << (q % R);
  }
  const CUtensorMap* xm = &xmap;
  const CUtensorMap* dm = &dymap;
  auto issue = [&](int m) {  // tile tb + m into stage m % S (one thread)
    unsigned char* stage = sm + (m % S) * STAGE;
    uint64_t* bar = &full[m % S];
    mbar_arrive_expect_tx(bar, C::XB * kWxBoxTx + 2 * kWdBox);
    const int tile = tb + m;
    const int bi = tile / (nty * ntx);
    const int rem = tile % (nty * ntx);
    const int r0 = (rem / ntx) * kSR;
    const int c0 = (rem % ntx) * kSW;
    for (int q = rank; q < nq; q += R) {
      if (q < C::XQ) {
        tma_load_4d_multicast(xm, smem_u32(stage + (q % C::XB) * kWxBox), bar, q * 64,
                              c0 - 1, r0 - 1, bi, xmask[q / C::XB]);
      } else {
        const int j = q - C::XQ;
        tma_load_4d_multicast(dm, smem_u32(stage + C::XB * kWxBox + (j % 2) * kWdBox), bar,
                              (ng * cl.nbc * 2 + j) * 64, c0, r0, bi, dmask[j / 2]);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], feeds ? __popc(feeds) : 1);
    }
    fence_barrier_init();
  }
  __syncwarp();
  cluster_arrive();  // every CTA's barriers exist before any multicast lands
  cluster_wait();
  if (threadIdx.x == 0)
    for (int m = 0; m < min(S, count); ++m) issue(m);
  __syncwarp();

  // warpgroup wg takes packed rows wg*64.. x all 128 columns; its warp w
  // the A rows wg*64 + w*16.. (slot-column s, channels ch..)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int kl = k0 + wg * 64 + (warp & 3) * 16;
  const int s = kl / CI;
  const int ch = dslot(s) * CI + kl % CI;  // channel within t's slot pair
  const int a_off = (ch / 64) * kWxBox;
  const int a_cell = ofs(s) + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_chunk = (ch % 64) / 8 + ((lane >> 3) & 1);

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

#pragma unroll 1
  for (int m = 0; m < count; ++m) {
    mbar_wait(&full[m % S], (m / S) & 1);
    const uint32_t st = smem_u32(sm + (m % S) * STAGE);
    // per cell row rl: A [16 rows, 16 cells] from the halo (ldmatrix.trans:
    // the gather), B [16 cells, 128 columns] = dy lines rl*16.., its two
    // 64-column chunks kWdBox apart, 8-cell groups 1024 bytes apart
    uint32_t a[kSR][4];
#pragma unroll
    for (int rl = 0; rl < kSR; ++rl) {
      const int la = (rl + ofs(t)) * kSHC + a_cell;  // halo cell: 128-byte line
      ldsm_x4_t(st + a_off + la * 128 + ((a_chunk ^ (la & 7)) << 4), a[rl]);
    }
    wgmma_fence();
#pragma unroll
    for (int rl = 0; rl < kSR; ++rl)
      wgmma_m64n128k16_rs(
          acc, a[rl],
          wgmma_desc_sw128(st + C::XB * kWxBox + rl * kSW * 128, kWdBox, 8 * 128));
    wgmma_commit();
    // while the products run: refill tile m - 1's stage with tile m + 2 once
    // every CTA this one feeds has released it
    if (threadIdx.x == 0 && m > 0 && m - 1 + S < count) {
      if (feeds) mbar_wait(&empty[(m - 1) % S], ((m - 1) / S) & 1);
      issue(m - 1 + S);
    }
    __syncwarp();
    wgmma_wait_all();
    __syncthreads();  // both warpgroups are done with tile m's stage: release it
    if (threadIdx.x < R && ((fed_by >> threadIdx.x) & 1))
      mbar_arrive_cluster(&empty[m % S], threadIdx.x);
  }
  cluster_arrive();  // no CTA leaves while a peer may still signal it
  cluster_wait();

  // the cluster's partial of rows kb*128.., columns nb*128..
  const int gq = lane >> 2;
  const int qd = lane & 3;
  const int row = kb * 128 + wg * 64 + (warp & 3) * 16;
  float* out = part + (long long)g * 16 * CI * N + (long long)row * N + nb * kSN + 2 * qd;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (long long)(gq + 8 * h) * N + j * 8) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// a [B, H, W, C] bf16 tensor read in boxes of 64 channels x bw cells x bh
// rows, 128-byte swizzled, zeros outside the tensor
inline bool nhwc_box_map(CUtensorMap* map, const bf16* ptr, int B, int H, int W, int C, int bw,
                         int bh) {
  const TensorMapEncodeFn enc = tensor_map_encode();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major [rows, cols] bf16 matrix read in boxes of 64 columns x 256
// rows, 128-byte swizzled
inline bool matrix_box_map(CUtensorMap* map, const bf16* ptr, int rows, int cols) {
  const TensorMapEncodeFn enc = tensor_map_encode();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 256};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CI>
cudaError_t fwd_set_smem_once() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      s2dconv_fwd_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwSmem);
  return attr;
}

template <int CI>
cudaError_t launch_s2dconv_fwd(const bf16* x, const bf16* wp, bf16* y, int B, int H, int W,
                               int N, int ctas, int per, cudaStream_t st) {
  cudaError_t err = fwd_set_smem_once<CI>();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  if (!nhwc_box_map(&xmap, x, B, H, W, 4 * CI, kSHC, kSHR) ||
      !matrix_box_map(&wmap, wp, 16 * CI, N))
    return cudaErrorInvalidValue;
  const int tiles = B * ((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW);
  s2dconv_fwd_kernel<CI><<<ctas, kSThreads, kFwSmem, st>>>(xmap, wmap, y, H, W, N, tiles, per);
  return cudaGetLastError();
}

// out[3]: K6's registers per thread, shared memory bytes per CTA and spill
// bytes per thread
template <int CI>
cudaError_t fwd_attrs(int* out) {
  cudaError_t err = fwd_set_smem_once<CI>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, s2dconv_fwd_kernel<CI>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + kFwSmem);
  out[2] = (int)fa.localSizeBytes;
  return cudaSuccess;
}

template <int CI>
cudaError_t wgrad_set_smem_once() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(s2dconv_wgrad_kernel<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wgrad_smem_bytes<CI>());
  return attr;
}

template <int CI>
cudaLaunchConfig_t wgrad_config(int N, int clusters, cudaLaunchAttribute* attr,
                                cudaStream_t st) {
  const WgCluster<CI> cl(N / kSN);
  const int groups = (N / kSN) / cl.nbc;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl.size();
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl.size() * clusters * groups);
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = wgrad_smem_bytes<CI>();
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CI>
cudaError_t launch_s2dconv_wgrad(const bf16* x, const bf16* dy, float* part, float* dwp,
                                 int B, int H, int W, int N, int clusters, int per,
                                 cudaStream_t st) {
  cudaError_t err = wgrad_set_smem_once<CI>();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, dymap;
  if (!nhwc_box_map(&xmap, x, B, H, W, 4 * CI, kSHC, kSHR) ||
      !nhwc_box_map(&dymap, dy, B, H, W, N, kSW, kSR))
    return cudaErrorInvalidValue;
  const int tiles = B * ((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgrad_config<CI>(N, clusters, &attr, st);
  err = cudaLaunchKernelEx(&cfg, s2dconv_wgrad_kernel<CI>, xmap, dymap, part, H, W, N, tiles,
                           clusters, per);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 16LL * CI * N;
  return launch_reduce(part, clusters, n, n, dwp, nullptr, st);
}

// out[4]: registers per thread, shared memory bytes per CTA, spill bytes per
// thread, and how many clusters of its launch the card holds at once
template <int CI>
cudaError_t wgrad_attrs(int N, int* out) {
  cudaError_t err = wgrad_set_smem_once<CI>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, s2dconv_wgrad_kernel<CI>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + wgrad_smem_bytes<CI>());
  out[2] = (int)fa.localSizeBytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgrad_config<CI>(N, 1, &attr, nullptr);
  return cudaOccupancyMaxActiveClusters(&out[3], s2dconv_wgrad_kernel<CI>, &cfg);
}

inline bool s2d_width_ok(int c) { return c == 32 || c == 64; }

}  // namespace crog

// K6: y [B, H, W, 4co] bf16 = blocked conv of x [B, H, W, 4ci] bf16 with the
// packed weight wp [16ci, 4co] bf16, on `ctas` persistent CTAs: CTA i takes
// column slice i % nh (nh = 4co / fwd_cols) of the 8 x 16 cell tiles
// [(i / nh) * per, (i / nh + 1) * per), and none is empty.
extern "C" int crog_s2dconv_fwd(const void* x, const void* wp, void* y, int B, int H, int W,
                                int ci, int co, int ctas, int per, void* stream) {
  using namespace crog;
  if (!s2d_width_ok(ci) || !s2d_width_ok(co) || B < 1 || H < 1 || W < 1 || per < 1)
    return cudaErrorInvalidValue;
  const int nh = 4 * co / (ci == 32 ? fwd_cols<32>() : fwd_cols<64>());
  const long long tiles = (long long)B * ((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW);
  const long long groups = ctas / nh;
  if (ctas < nh || ctas % nh || groups * per < tiles || (groups - 1) * per >= tiles ||
      tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(wp);
  auto* yb = static_cast<bf16*>(y);
  return ci == 32 ? launch_s2dconv_fwd<32>(xb, wb, yb, B, H, W, 4 * co, ctas, per, st)
                  : launch_s2dconv_fwd<64>(xb, wb, yb, B, H, W, 4 * co, ctas, per, st);
}

// out[3]: K6's registers per thread, shared memory per CTA, spill bytes per
// thread, for input width ci
extern "C" int crog_s2dconv_fwd_attrs(int ci, int* out) {
  using namespace crog;
  if (!s2d_width_ok(ci)) return cudaErrorInvalidValue;
  return ci == 32 ? fwd_attrs<32>(out) : fwd_attrs<64>(out);
}

// K6b: dwp [16ci, 4co] f32 = P(x)^T dy over every cell, through one f32
// partial per cluster, part [clusters, 16ci, 4co]: cluster g sums the 8 x 16
// cell tiles [g * per, (g + 1) * per), and none is empty.
extern "C" int crog_s2dconv_wgrad(const void* x, const void* dy, void* part, void* dwp, int B,
                                  int H, int W, int ci, int co, int clusters, int per,
                                  void* stream) {
  using namespace crog;
  if (!s2d_width_ok(ci) || !s2d_width_ok(co) || B < 1 || H < 1 || W < 1 || clusters < 1 ||
      per < 1)
    return cudaErrorInvalidValue;
  const long long tiles =
      (long long)B * ((H + kSR - 1) / kSR) * ((W + kSW - 1) / kSW);
  if ((long long)clusters * per < tiles || (long long)(clusters - 1) * per >= tiles ||
      tiles > 0x7fffffffLL || clusters * 16 > 0x7fffffff / 8)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* db = static_cast<const bf16*>(dy);
  auto* pf = static_cast<float*>(part);
  auto* wf = static_cast<float*>(dwp);
  return ci == 32 ? launch_s2dconv_wgrad<32>(xb, db, pf, wf, B, H, W, 4 * co, clusters, per, st)
                  : launch_s2dconv_wgrad<64>(xb, db, pf, wf, B, H, W, 4 * co, clusters, per, st);
}

// out[4]: K6b's registers per thread, shared memory per CTA, spill bytes per
// thread, and the clusters of its launch for (ci, co) the card holds at once
extern "C" int crog_s2dconv_wgrad_attrs(int ci, int co, int* out) {
  using namespace crog;
  if (!s2d_width_ok(ci) || !s2d_width_ok(co)) return cudaErrorInvalidValue;
  return ci == 32 ? wgrad_attrs<32>(4 * co, out) : wgrad_attrs<64>(4 * co, out);
}
