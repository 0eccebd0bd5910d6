"""K4/K4b: the decoder FFN, Dense -> ReLU -> Dropout -> LayerNorm -> Dense,
forward and backward.

Counterpart of crog_tpu/ops/pallas_ffn.py ``fused_ffn`` (176) and its custom
VJP.  Weights in torch layout: ``w1`` [F, D], ``w2`` [D, F].  ``fused_ffn``
is an autograd function.  On a CUDA tensor its forward launches csrc/ffn.cu,
whose cluster kernel spreads each 128-row tile's hidden over 8 CTAs
(``fwd_schedule``) and writes hn, and whose second kernel computes y from
hn; its backward launches csrc/ffn_bwd.cu, whose cluster kernel
(``bwd_schedule``) recomputes the hidden with the forward's code
(csrc/ffn.cuh) and the dropout mask from x and the seed and emits dh, hn and
the column sums of db1, dgamma, dbeta, db2, and whose second kernel (the
forward's y kernel) computes dx from dh (or raises);
the two weight gradients dW1 = dh^T x and dW2 =
dy^T hn are library matrix products outside the kernel, as the JAX package
leaves them to XLA: bf16 operands on the tensor cores with f32 sums and an
f32 result, as the JAX einsums with ``preferred_element_type=float32``
compute them.  On a CPU tensor both run the plain twins, which
keep the TPU kernel's cast points: the hidden rounded to x's dtype after the
bias, after the dropout scale and again after the f32-statistics LayerNorm,
one rounding of the output after the bias; in the backward dh rounded
before db1 and dx, dy rounded for dW2 but f32 for db2, the ReLU mask taken
from the post-dropout hidden.

On fp32 x (``compute_dtype: float32``) the forward launches K4-f32
(csrc/ffn_f32.cu: the hidden GEMM with ReLU and dropout in its epilogue,
the LayerNorm over 2048, the output GEMM) and the backward K4b-f32
(csrc/ffn_bwd_f32.cu: the hidden recomputed by K4-f32's own GEMM, dhn,
the LayerNorm backward with the column sums, dx, dW1 and dW2 over row
chunks summed in order), every product 3xTF32 on one wgmma GEMM
(csrc/gemm_wgmma_f32.cuh, ``f32_schedule``) whose B (W1, W2 and, for dW,
x and dy) is split once per call into TF32 planes.

The kernels take D in KERNEL_D (ops/decoder_blocks.py's widths: 256, 512,
768 and 1024, a run-time value of every kernel; the hidden product's K and
the y / dx GEMM's D / OUT_COLS column tiles follow it) and F = KERNEL_F.
"""

from __future__ import annotations

import torch

from crog_tpu_torch.ops import cuda_build, work
from crog_tpu_torch.ops.decoder_blocks import (F32_SLICE, F32_TILE, KERNEL_D, dense, ln_fast,
                                               ln_stats)
from crog_tpu_torch.ops.dropout import apply_dropout, dropout_keep, kernel_args

KERNEL_F = 2048  # the hidden width the FFN kernels take (D: KERNEL_D)
BWD_ROWS = 128  # rows per cluster tile of K4 and K4b (csrc/ffn.cuh kBM)
BWD_CLUSTER = 8  # CTAs per K4 / K4b cluster, each with KERNEL_F // 8 hidden columns
OUT_COLS = 256  # output columns per CTA of K4's y and K4b's dx GEMM (csrc/ffn.cuh)
# K4b-f32's dW rows per chunk at most (csrc/gemm_wgmma_f32.cuh kGwChunkRows;
# the GEMM's tile and K slice: decoder_blocks.F32_TILE, F32_SLICE)
F32_CHUNK_ROWS = 8192


def fwd_schedule(m: int, d: int):
    """K4's work split over ``m`` rows of width ``d``, from the shapes
    alone: the row range [r0, r1) of each cluster tile, the hidden column
    range [c0, c1) that CTA k of every cluster owns (both as
    ``bwd_schedule``: K4b recomputes the same hidden), and the output column
    range [c0, c1) of each CTA of the y GEMM, which runs over the same row
    tiles.  csrc/ffn.cu launches one cluster per tile and the y GEMM over
    len(tiles) x len(out_cols) CTAs."""
    tiles, slices = bwd_schedule(m)
    return tiles, slices, [(c, c + OUT_COLS) for c in range(0, d, OUT_COLS)]


def bwd_schedule(m: int):
    """K4b's work split over ``m`` rows, from the shapes alone: the row
    range [r0, r1) of each cluster tile (one partial row of column sums
    each, summed in this order), and the hidden column range [c0, c1) that
    CTA k of every cluster owns.  csrc/ffn_bwd.cu launches one cluster per
    tile and the dx kernel over the same row tiles."""
    tiles = [(r, min(r + BWD_ROWS, m)) for r in range(0, m, BWD_ROWS)]
    width = KERNEL_F // BWD_CLUSTER
    return tiles, [(k * width, (k + 1) * width) for k in range(BWD_CLUSTER)]


def bwd_db2_cols(d: int):
    """The columns [c0, c1) of db2 = sum(dy) whose partials CTA k of every
    K4b cluster adds, from dy's 32-column chunks as they pass through its
    ring (csrc/ffn_bwd.cu): d / BWD_CLUSTER each, together the whole row."""
    width = d // BWD_CLUSTER
    return [(k * width, (k + 1) * width) for k in range(BWD_CLUSTER)]

def f32_dw_chunks(m: int):
    """The row chunks [r0, r1) over ``m`` rows of K4b-f32's dW1 and dW2
    (csrc/gemm_wgmma_f32.cuh ``gw_dw_chunk``), from m alone: ceil(m /
    F32_CHUNK_ROWS) chunks of equal length rounded up to F32_SLICE, the last
    one shorter.  Each chunk's partial is summed in this order."""
    n = -(-m // F32_CHUNK_ROWS)
    chunk = -(-(-(-m // n)) // F32_SLICE) * F32_SLICE
    return [(r, min(r + chunk, m)) for r in range(0, m, chunk)]


def f32_schedule(m: int, d: int, f: int = KERNEL_F):
    """K4-f32's and K4b-f32's products over ``m`` rows, in launch order:
    {product: ((rows, cols) of its output, its CTAs' output tiles ((r0, r1),
    (c0, c1)) in launch order, its K chunks [k0, k1))}.  A CTA computes one
    tile over one chunk; csrc/gemm_wgmma_f32.cuh launches a grid of column
    tiles (fastest), row tiles and chunks.  dW2's product is its transpose
    hn^T dy, [F, D] as dW1's."""
    def tiles(rows, cols):
        return [((r, min(r + F32_TILE, rows)), (c, c + F32_TILE))
                for r in range(0, rows, F32_TILE) for c in range(0, cols, F32_TILE)]

    dw = f32_dw_chunks(m)
    return {"hidden": ((m, f), tiles(m, f), [(0, d)]),
            "y": ((m, d), tiles(m, d), [(0, f)]),
            "recompute": ((m, f), tiles(m, f), [(0, d)]),
            "dhn": ((m, f), tiles(m, f), [(0, d)]),
            "dx": ((m, d), tiles(m, d), [(0, f)]),
            "dw1": ((f, d), tiles(f, d), dw),
            "dw2": ((f, d), tiles(f, d), dw)}


def f32_bwd_work(m: int, d: int, f: int = KERNEL_F):
    """Floats of K4b-f32's two workspaces: part (the LayerNorm backward's
    column partials, 64 rows a block, 3F each; db2's, 256 rows a block; dW's
    chunk partials, F D each) and planes (the TF32 hi and lo planes of W1,
    W2^T and W1^T, then of x and of dy, rows padded to 4 floats)."""
    part = max(-(-m // 64) * 3 * f, -(-m // 256) * d, len(f32_dw_chunks(m)) * f * d)
    return part, max(6 * f * d, 2 * d * -(-m // 4) * 4)


def ffn_plain(x, w1, b1, gamma, beta, w2, b2, seed: int = 0, rate: float = 0.0,
              eps: float = 1e-5):
    h = apply_dropout(torch.relu(dense(x, w1, b1)), seed, rate)
    return dense(ln_fast(h, gamma, beta, eps), w2, b2)


def ffn_bwd_plain(x, w1, b1, gamma, beta, w2, dy, seed: int = 0, rate: float = 0.0,
                  eps: float = 1e-5, relu_mask=None):
    """Plain twin of K4b (``_bwd_kernel`` of pallas_ffn.py plus the two
    weight-gradient products).  Returns (dx, dw1, db1, dgamma, dbeta, dw2,
    db2), the weight gradients in f32.  ``relu_mask`` [M, F] bool, if
    given, replaces the ReLU's decision h > 0 (a kernel's, where a
    pre-activation within rounding of 0 takes the other sign in another
    order of summation)."""
    dt = x.dtype
    m, _ = x.shape
    f = w1.shape[0]
    h = apply_dropout(torch.relu(dense(x, w1, b1)), seed, rate)
    hf = h.float()
    hhat, rstd = ln_stats(h, eps)
    hn = (hhat * gamma.float() + beta.float()).to(dt)
    dyc = dy.to(dt)
    dhn = torch.matmul(dyc.float(), w2.to(dt).float())
    dgamma, dbeta = (dhn * hhat).sum(0), dhn.sum(0)
    dhhat = dhn * gamma.float()
    m1 = dhhat.mean(-1, keepdim=True)
    m2 = (dhhat * hhat).mean(-1, keepdim=True)
    dh = rstd * (dhhat - m1 - hhat * m2)
    if rate > 0.0:
        keep = dropout_keep(seed, rate, m, f, x.device)
        dh = torch.where(keep, dh * (1.0 / (1.0 - rate)), 0.0)
    dh = torch.where(hf > 0 if relu_mask is None else relu_mask, dh, 0.0).to(dt)
    dx = torch.matmul(dh.float(), w1.to(dt).float()).to(dt)
    # dW1 = dh^T x [F, D], dW2 = dy^T hn [D, F]: f32 products of the
    # compute-dtype values (the JAX package's einsums with f32 results)
    dw1 = torch.matmul(dh.float().t(), x.float())
    dw2 = torch.matmul(dyc.float().t(), hn.float())
    return dx, dw1, dh.float().sum(0), dgamma, dbeta, dw2, dy.float().sum(0)


def _check(x, w1):
    m, d = x.shape
    f = w1.shape[0]
    if d not in KERNEL_D or f != KERNEL_F:
        widths = ", ".join(map(str, KERNEL_D[:-1])) + f" or {KERNEL_D[-1]}"
        raise ValueError(
            f"FFN kernels take D {widths} (a multiple of {OUT_COLS} up to {KERNEL_D[-1]}) "
            f"and F={KERNEL_F}, got D={d}, F={f}"
        )
    cuda_build.require(x, "x", x.dtype, (m, d))


def _params(w1, w2, d, f, dtype=torch.bfloat16, **vecs):
    """Weights in ``dtype`` (the bf16 kernels' operands, or the fp32
    parameters as they are) and f32 vectors, checked for the kernels."""
    w1b = w1.to(dtype).contiguous()
    w2b = w2.to(dtype).contiguous()
    cuda_build.require(w1b, "w1", dtype, (f, d))
    cuda_build.require(w2b, "w2", dtype, (d, f))
    out = []
    for n, t in vecs.items():
        t = t.float().contiguous()
        cuda_build.require(t, n, torch.float32, (d if n == "b2" else f,))
        out.append(t)
    return w1b, w2b, out


def ffn_fwd(x, w1, b1, gamma, beta, w2, b2, seed: int = 0, rate: float = 0.0,
            with_hidden: bool = False):
    """K4 over x [M, D] tokens, bf16 or fp32.  fp32 x goes to K4-f32
    (csrc/ffn_f32.cu, counted in ``ffn_fwd.launches_f32``).  With
    ``with_hidden`` (a CUDA tensor only; for the card tests) also the hn
    [M, F] the kernels leave in their workspace."""
    work.note("ffn", lambda: (work.ffn_flops(*x.shape, w1.shape[0]),
                              work.nbytes(x, w1, b1, gamma, beta, w2, b2, x)))
    if x.device.type == "cpu":
        if with_hidden:
            raise ValueError("with_hidden reads the kernels' workspace: a CUDA tensor only")
        with work.uncounted():
            return ffn_plain(x, w1, b1, gamma, beta, w2, b2, seed, rate)
    name = cuda_build.library_for("ffn", x.dtype)
    _check(x, w1)
    m, d = x.shape
    f = w1.shape[0]
    w1b, w2b, (b1f, gf, bef, b2f) = _params(w1, w2, d, f, x.dtype, b1=b1, gamma=gamma,
                                            beta=beta, b2=b2)
    y = torch.empty_like(x)
    hn = torch.empty(m, f, dtype=x.dtype, device=x.device)
    dseed, thresh, scale = kernel_args(seed, rate)
    lib = cuda_build.load(name)
    stream = cuda_build.stream_ptr(x.device)
    if x.dtype == torch.float32:
        # both products read W1 and W2 as stored, split into their TF32
        # planes (work); hn holds the hidden
        planes = torch.empty(4 * f * d, dtype=torch.float32, device=x.device)
        table = cuda_build.ptr_table(x, w1b, b1f, gf, bef, w2b, b2f, y, hn, planes)
        rc = lib.crog_ffn_f32_fwd(table, m, d, f, dseed, thresh, scale, stream)
        cuda_build.check_launch(lib, rc, "crog_ffn_f32_fwd")
        ffn_fwd.launches_f32 += 1
        return (y, hn) if with_hidden else y
    # both products read a B that is row-major along their output columns
    w1t, w2t = w1b.t().contiguous(), w2b.t().contiguous()
    table = cuda_build.ptr_table(x, w1t, b1f, gf, bef, w2t, b2f, y, hn)
    rc = lib.crog_ffn_fwd(table, m, d, f, len(fwd_schedule(m, d)[0]), dseed, thresh, scale,
                          stream)
    cuda_build.check_launch(lib, rc, "crog_ffn_fwd")
    ffn_fwd.launches += 1
    return (y, hn) if with_hidden else y


ffn_fwd.launches = 0
ffn_fwd.launches_f32 = 0


def ffn_bwd(x, w1, b1, gamma, beta, w2, dy, seed: int = 0, rate: float = 0.0,
            with_hidden: bool = False):
    """K4b on a CUDA tensor (csrc/ffn_bwd.cu: the cluster kernel, the dx
    kernel and two fixed-order sums) plus the two weight-gradient products
    (bf16 GEMMs with f32 results).  Returns (dx, dw1, db1, dgamma, dbeta,
    dw2, db2), and with ``with_hidden`` also the kernels' dh and hn [M, F]
    bf16 (the card tests hold them to equal bits across repeats).  fp32 x
    goes to K4b-f32 (``_ffn_bwd_f32``)."""
    name = cuda_build.library_for("ffn_bwd", x.dtype)
    _check(x, w1)
    if x.dtype == torch.float32:
        return _ffn_bwd_f32(name, x, w1, b1, gamma, beta, w2, dy, seed, rate, with_hidden)
    m, d = x.shape
    f = w1.shape[0]
    w1b, w2b, (b1f, gf, bef) = _params(w1, w2, d, f, b1=b1, gamma=gamma, beta=beta)
    dy = dy.to(torch.bfloat16).contiguous()
    cuda_build.require(dy, "dy", torch.bfloat16, (m, d))
    dev = x.device
    nblk = len(bwd_schedule(m)[0])
    dx = torch.empty_like(x)
    dh = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
    hn = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
    rows = torch.empty(3, f, dtype=torch.float32, device=dev)  # db1, dgamma, dbeta
    db2 = torch.empty(d, dtype=torch.float32, device=dev)
    parts = torch.empty(nblk, 3 * f + d, dtype=torch.float32, device=dev)
    dseed, thresh, scale = kernel_args(seed, rate)
    w1t = w1b.t().contiguous()  # the recompute's B, row-major along the hidden as w2 is
    table = cuda_build.ptr_table(x, w1b, b1f, gf, bef, w2b, dy, dx, dh, hn, rows, db2, parts,
                                 w1t)
    lib = cuda_build.load("ffn_bwd")
    rc = lib.crog_ffn_bwd(table, m, d, f, dseed, thresh, scale,
                          cuda_build.stream_ptr(dev))
    cuda_build.check_launch(lib, rc, "crog_ffn_bwd")
    ffn_bwd.launches += 1
    # bf16 GEMMs with f32 sums and results: products of bf16 values are
    # exact in f32, so these differ from the twin's f32 products only in the
    # order of the sums
    dw1 = torch.mm(dh.t(), x, out_dtype=torch.float32)
    dw2 = torch.mm(dy.t(), hn, out_dtype=torch.float32)
    out = (dx, dw1, rows[0], rows[1], rows[2], dw2, db2)
    return out + (dh, hn) if with_hidden else out


ffn_bwd.launches = 0
ffn_bwd.launches_f32 = 0


def _ffn_bwd_f32(name, x, w1, b1, gamma, beta, w2, dy, seed, rate, with_hidden):
    """K4b-f32: crog_ffn_f32_bwd (csrc/ffn_bwd_f32.cu, counted in
    ``ffn_bwd.launches_f32``) for every output, dW1 and dW2 included; dh
    and hn [M, F] f32."""
    m, d = x.shape
    f = w1.shape[0]
    w1f, w2f, (b1f, gf, bef) = _params(w1, w2, d, f, torch.float32, b1=b1, gamma=gamma,
                                       beta=beta)
    dy = dy.to(torch.float32).contiguous()
    cuda_build.require(dy, "dy", torch.float32, (m, d))
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=x.device)
    dx, dh, hn, rows, db2 = new(m, d), new(m, f), new(m, f), new(3, f), new(d)
    part, planes = (new(n) for n in f32_bwd_work(m, d, f))
    dw1, dw2 = new(f, d), new(d, f)
    dseed, thresh, scale = kernel_args(seed, rate)
    table = cuda_build.ptr_table(x, w1f, b1f, gf, bef, w2f, dy, dx, dh, hn, rows, db2, dw1,
                                 dw2, part, planes)
    lib = cuda_build.load(name)
    rc = lib.crog_ffn_f32_bwd(table, m, d, f, dseed, thresh, scale,
                              cuda_build.stream_ptr(x.device))
    cuda_build.check_launch(lib, rc, "crog_ffn_f32_bwd")
    ffn_bwd.launches_f32 += 1
    out = (dx, dw1, rows[0], rows[1], rows[2], dw2, db2)
    return out + (dh, hn) if with_hidden else out


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, gamma, beta, w2, b2, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        ctx.save_for_backward(x, w1, b1, gamma, beta, w2)
        return ffn_fwd(x, w1, b1, gamma, beta, w2, b2, seed, rate)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, gamma, beta, w2 = ctx.saved_tensors
        fn = ffn_bwd_plain if x.device.type == "cpu" else ffn_bwd
        return (*fn(x, w1, b1, gamma, beta, w2, dy, ctx.seed, ctx.rate), None, None)


def fused_ffn(x, w1, b1, gamma, beta, w2, b2, seed: int = 0, rate: float = 0.0):
    """K4 forward and K4b backward over x [M, D] tokens."""
    return _FusedFFN.apply(x, w1, b1, gamma, beta, w2, b2, seed, rate)
