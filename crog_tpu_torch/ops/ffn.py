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
"""

from __future__ import annotations

import torch

from crog_tpu_torch.ops import cuda_build, work
from crog_tpu_torch.ops.decoder_blocks import dense, ln_fast, ln_stats
from crog_tpu_torch.ops.dropout import apply_dropout, dropout_keep, kernel_args

KERNEL_D, KERNEL_F = 512, 2048
BWD_ROWS = 128  # rows per cluster tile of K4 and K4b (csrc/ffn.cuh kBM)
BWD_CLUSTER = 8  # CTAs per K4 / K4b cluster, each with KERNEL_F // 8 hidden columns
OUT_COLS = 256  # output columns per CTA of K4's y and K4b's dx GEMM (csrc/ffn.cuh)


def fwd_schedule(m: int):
    """K4's work split over ``m`` rows, from the shapes alone: the row range
    [r0, r1) of each cluster tile, the hidden column range [c0, c1) that CTA
    k of every cluster owns (both as ``bwd_schedule``: K4b recomputes the
    same hidden), and the output column range [c0, c1) of each CTA of the y
    GEMM, which runs over the same row tiles.  csrc/ffn.cu launches one
    cluster per tile and the y GEMM over len(tiles) x len(out_cols) CTAs."""
    tiles, slices = bwd_schedule(m)
    return tiles, slices, [(c, c + OUT_COLS) for c in range(0, KERNEL_D, OUT_COLS)]


def bwd_schedule(m: int):
    """K4b's work split over ``m`` rows, from the shapes alone: the row
    range [r0, r1) of each cluster tile (one partial row of column sums
    each, summed in this order), and the hidden column range [c0, c1) that
    CTA k of every cluster owns.  csrc/ffn_bwd.cu launches one cluster per
    tile and the dx kernel over the same row tiles."""
    tiles = [(r, min(r + BWD_ROWS, m)) for r in range(0, m, BWD_ROWS)]
    width = KERNEL_F // BWD_CLUSTER
    return tiles, [(k * width, (k + 1) * width) for k in range(BWD_CLUSTER)]


def ffn_plain(x, w1, b1, gamma, beta, w2, b2, seed: int = 0, rate: float = 0.0,
              eps: float = 1e-5):
    h = apply_dropout(torch.relu(dense(x, w1, b1)), seed, rate)
    return dense(ln_fast(h, gamma, beta, eps), w2, b2)


def ffn_bwd_plain(x, w1, b1, gamma, beta, w2, dy, seed: int = 0, rate: float = 0.0,
                  eps: float = 1e-5):
    """Plain twin of K4b (``_bwd_kernel`` of pallas_ffn.py plus the two
    weight-gradient products).  Returns (dx, dw1, db1, dgamma, dbeta, dw2,
    db2), the weight gradients in f32."""
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
    dh = torch.where(hf > 0, dh, 0.0).to(dt)
    dx = torch.matmul(dh.float(), w1.to(dt).float()).to(dt)
    # dW1 = dh^T x [F, D], dW2 = dy^T hn [D, F]: f32 products of the
    # compute-dtype values (the JAX package's einsums with f32 results)
    dw1 = torch.matmul(dh.float().t(), x.float())
    dw2 = torch.matmul(dyc.float().t(), hn.float())
    return dx, dw1, dh.float().sum(0), dgamma, dbeta, dw2, dy.float().sum(0)


def _check(x, w1):
    m, d = x.shape
    f = w1.shape[0]
    if (d, f) != (KERNEL_D, KERNEL_F):
        raise ValueError(
            f"FFN kernels take D={KERNEL_D}, F={KERNEL_F}, got D={d}, F={f}"
        )
    cuda_build.require(x, "x", torch.bfloat16, (m, d))


def _params(w1, w2, d, f, **vecs):
    """bf16 weights and f32 vectors, checked for the kernels."""
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    cuda_build.require(w1b, "w1", torch.bfloat16, (f, d))
    cuda_build.require(w2b, "w2", torch.bfloat16, (d, f))
    out = []
    for n, t in vecs.items():
        t = t.float().contiguous()
        cuda_build.require(t, n, torch.float32, (d if n == "b2" else f,))
        out.append(t)
    return w1b, w2b, out


def ffn_fwd(x, w1, b1, gamma, beta, w2, b2, seed: int = 0, rate: float = 0.0):
    """K4 over x [M, D] tokens."""
    work.note("ffn", lambda: (work.ffn_flops(*x.shape, w1.shape[0]),
                              work.nbytes(x, w1, b1, gamma, beta, w2, b2, x)))
    if x.device.type == "cpu":
        with work.uncounted():
            return ffn_plain(x, w1, b1, gamma, beta, w2, b2, seed, rate)
    _check(x, w1)
    m, d = x.shape
    f = w1.shape[0]
    w1b, w2b, (b1f, gf, bef, b2f) = _params(w1, w2, d, f, b1=b1, gamma=gamma, beta=beta,
                                            b2=b2)
    y = torch.empty_like(x)
    hn = torch.empty(m, f, dtype=torch.bfloat16, device=x.device)
    dseed, thresh, scale = kernel_args(seed, rate)
    # both products read a B that is row-major along their output columns
    w1t, w2t = w1b.t().contiguous(), w2b.t().contiguous()
    table = cuda_build.ptr_table(x, w1t, b1f, gf, bef, w2t, b2f, y, hn)
    lib = cuda_build.load("ffn")
    rc = lib.crog_ffn_fwd(table, m, d, f, len(fwd_schedule(m)[0]), dseed, thresh, scale,
                          cuda_build.stream_ptr(x.device))
    cuda_build.check_launch(lib, rc, "crog_ffn_fwd")
    ffn_fwd.launches += 1
    return y


ffn_fwd.launches = 0


def ffn_bwd(x, w1, b1, gamma, beta, w2, dy, seed: int = 0, rate: float = 0.0,
            with_hidden: bool = False):
    """K4b on a CUDA tensor (csrc/ffn_bwd.cu: the cluster kernel, the dx
    kernel and two fixed-order sums) plus the two weight-gradient products
    (bf16 GEMMs with f32 results).  Returns (dx, dw1, db1, dgamma, dbeta,
    dw2, db2), and with ``with_hidden`` also the kernels' dh and hn [M, F]
    bf16 (the card tests hold them to equal bits across repeats)."""
    _check(x, w1)
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
