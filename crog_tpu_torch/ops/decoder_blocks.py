"""K2/K3 and K2b/K3b: the decoder's pre-LN self- and cross-attention blocks,
forward and backward.

Counterpart of crog_tpu/ops/pallas_decoder.py ``decoder_self_block`` (590)
and ``decoder_cross_block`` (613) with their custom VJPs:

  self : x + drop(LN_post(OutProj(MHA(LN_pre(x)+pos, LN_pre(x)+pos, LN_pre(x)))))
  cross: x + drop(LN_post(OutProj(MHA(LN_pre(x)+pos, txt+tpos, txt))))

Weights are in torch layout: ``in_w`` [3D, D] packs the q/k/v projections
(nn.MultiheadAttention's ``in_proj_weight``), ``out_w`` [D, D]; biases and
LN affines are 1-D.  ``decoder_self_block`` / ``decoder_cross_block`` are
autograd functions.  On a CUDA tensor their forward launches the kernel
sequence of csrc/decoder_blocks.cu (its projection GEMM over the tiles of
``proj_plan``, its out-projection clusters over those of ``out_schedule``)
and their backward that of csrc/decoder_blocks_bwd.cu (or raises); on a CPU
tensor both run the plain
twins, which keep the TPU kernels' cast points: bf16 after every Dense and
every LN, f32 LN statistics with flax's fast variance, f32 softmax; in the
backward P and dS rounded before their products, the LN backward on f32
x-hat, dW summed in f32 and rounded once to the compute dtype.

Dropout (``rate`` > 0, training) uses the counter-based mask of
ops/dropout.py keyed by ``seed``, over rows b*L + l and columns of D.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from crog_tpu_torch.ops import cuda_build, work
from crog_tpu_torch.ops.attention import HEAD_DIM, NEG, attention_plain, mha_bwd_plain
from crog_tpu_torch.ops.dropout import apply_dropout, dropout_keep, kernel_args

EPS = 1e-5
MAX_TOKENS = 768
KERNEL_D = 512  # the width the block kernels take
PROJ_ROWS = 128  # rows per CTA tile of the forward's GEMM kernels (csrc/gemm.cuh kGM)
PROJ_COLS = 256  # output columns per CTA tile (csrc/decoder_blocks.cu kPN)
OUT_CLUSTER = KERNEL_D // PROJ_COLS  # CTAs per out-projection cluster


@lru_cache(maxsize=64)
def proj_plan(segments):
    """The forward's projection launch over its products, from the shapes
    alone: ``segments`` is a tuple of products (rows m, first output column
    w0 of in_w's 3D, columns n), each A [m, D] times in_w rows w0 .. w0 + n
    - 1.  Returns one (product, (r0, r1), (c0, c1)) per CTA in launch order:
    product by product, row tiles of PROJ_ROWS outer, column tiles of
    PROJ_COLS inner (c in in_w's rows).  csrc/decoder_blocks.cu launches
    len(plan) CTAs and walks the same order."""
    plan = []
    for s, (m, w0, n) in enumerate(segments):
        for r in range(0, m, PROJ_ROWS):
            for c in range(w0, w0 + n, PROJ_COLS):
                plan.append((s, (r, min(r + PROJ_ROWS, m)), (c, c + PROJ_COLS)))
    return tuple(plan)


def self_proj_segments(m: int, d: int = KERNEL_D):
    """K2's products: q and k from qin into the packed [M, 2D] qk (in_w's
    first 2D rows), v from xl (the last D rows), both over the M rows."""
    return ((m, 0, 2 * d), (m, 2 * d, d))


def cross_proj_segments(m: int, mt: int, d: int = KERNEL_D):
    """K3's products: q from qin over the M image rows; k from kin and v
    from the text over the MT = B*T text rows."""
    return ((m, 0, d), (mt, d, d), (mt, 2 * d, d))


def out_schedule(m: int):
    """The out-projection's clusters over ``m`` rows: the row range [r0, r1)
    of each cluster tile, and the column range [c0, c1) that CTA k of every
    cluster owns (together a whole row, so the LayerNorm's statistics stay
    in the cluster)."""
    tiles = [(r, min(r + PROJ_ROWS, m)) for r in range(0, m, PROJ_ROWS)]
    return tiles, [(k * PROJ_COLS, (k + 1) * PROJ_COLS) for k in range(OUT_CLUSTER)]


def ln_fast(x, g, b, eps: float = EPS):
    """LayerNorm with f32 statistics and flax's fast variance
    E[x^2] - E[x]^2, cast back to x's dtype."""
    xhat, _ = ln_stats(x, eps)
    return (xhat * g.float() + b.float()).to(x.dtype)


def ln_stats(x, eps: float = EPS):
    """(x-hat, rstd) in f32 over the last axis, fast variance."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    rstd = torch.rsqrt((mu2 - mu * mu).clamp_min(0.0) + eps)
    return (xf - mu) * rstd, rstd


def ln_bwd(dy, xhat, rstd, g):
    """LayerNorm backward on [M, N] f32 rows (``_ln_bwd``): dx and the
    column sums dg, db."""
    dxhat = dy * g.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx, (dy * xhat).sum(0), dy.sum(0)


def dense(x, w, b):
    """x W^T + b with the sum in f32 and one rounding to x's dtype (the TPU
    kernels' ``_dense``); ``w`` is [out, in]."""
    y = torch.matmul(x.float(), w.to(x.dtype).float().t())
    return (y + b.float()).to(x.dtype)


def dense_t(dy, w):
    """dy W with the sum in f32, rounded to dy's dtype (``_dense_t``): the
    input gradient of ``dense`` for a torch-layout ``w`` [out, in]."""
    return torch.matmul(dy.float(), w.to(dy.dtype).float()).to(dy.dtype)


def grad_w(dy, x, dtype):
    """dW = dy^T x [out, in], summed over all rows in f32 and rounded once
    to the compute dtype (``_grad_w`` + ``dw.astype(w.dtype)``)."""
    return torch.matmul(dy.reshape(-1, dy.shape[-1]).float().t(),
                        x.reshape(-1, x.shape[-1]).float()).to(dtype).float()


def key_mask(pad_mask, b: int, t: int, device):
    """[B, T] additive f32 key mask: 0 keep, -1e30 for padded keys."""
    if pad_mask is None:
        return torch.zeros(b, t, dtype=torch.float32, device=device)
    return torch.where(pad_mask.bool(), NEG, 0.0).to(torch.float32)


def self_block_plain(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                     b_post, nheads: int, seed: int = 0, rate: float = 0.0):
    d = x.shape[-1]
    xl = ln_fast(x, g_pre, b_pre)
    qin = xl + pos.to(x.dtype)
    q = dense(qin, in_w[:d], in_b[:d])
    k = dense(qin, in_w[d : 2 * d], in_b[d : 2 * d])
    v = dense(xl, in_w[2 * d :], in_b[2 * d :])
    o = attention_plain(q, k, v, nheads)
    on = ln_fast(dense(o, out_w, out_b), g_post, b_post)
    return x + apply_dropout(on, seed, rate)


def cross_block_plain(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b,
                      g_pre, b_pre, g_post, b_post, nheads: int, seed: int = 0,
                      rate: float = 0.0):
    d = x.shape[-1]
    xl = ln_fast(x, g_pre, b_pre)
    kv = txt.to(x.dtype)
    q = dense(xl + pos.to(x.dtype), in_w[:d], in_b[:d])
    k = dense(kv + tpos.to(x.dtype), in_w[d : 2 * d], in_b[d : 2 * d])
    v = dense(kv, in_w[2 * d :], in_b[2 * d :])
    mask = key_mask(pad_mask, txt.shape[0], txt.shape[1], x.device)
    o = attention_plain(q, k, v, nheads, mask)
    on = ln_fast(dense(o, out_w, out_b), g_post, b_post)
    return x + apply_dropout(on, seed, rate)


def _post_ln_bwd(dy, op, g_post, seed, rate):
    """Dropout and post-LN backward shared by both blocks: (dop f32, dop
    rounded, dg_post, db_post, db_out)."""
    m, d = op.shape
    dyf = dy.reshape(m, d).float()
    if rate > 0.0:
        keep = dropout_keep(seed, rate, m, d, dy.device)
        dyf = torch.where(keep, dyf * (1.0 / (1.0 - rate)), 0.0)
    xhat2, rstd2 = ln_stats(op)
    dop, dgp, dbp = ln_bwd(dyf, xhat2, rstd2, g_post)
    return dop.to(op.dtype), dgp, dbp, dop.sum(0)


def self_block_bwd_plain(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                         b_post, dy, nheads: int, seed: int = 0, rate: float = 0.0):
    """Plain twin of K2b (``_self_bwd_kernel``): recompute the block, then
    its backward.  Returns (dx, d in_w, d in_b, d out_w, d out_b, d g_pre,
    d b_pre, d g_post, d b_post); weight grads f32 holding values of the
    compute dtype."""
    b, l, d = x.shape
    dt = x.dtype
    x2 = x.reshape(b * l, d)
    xl = ln_fast(x2, g_pre, b_pre)
    qin = xl + pos.to(dt).repeat(b, 1)
    q = dense(qin, in_w[:d], in_b[:d])
    k = dense(qin, in_w[d : 2 * d], in_b[d : 2 * d])
    v = dense(xl, in_w[2 * d :], in_b[2 * d :])
    heads = lambda t: t.view(b, l, d)
    o = attention_plain(heads(q), heads(k), heads(v), nheads).reshape(b * l, d)
    op = dense(o, out_w, out_b)
    dop, dgp, dbp, dbo = _post_ln_bwd(dy.to(dt), op, g_post, seed, rate)
    do = dense_t(dop, out_w)
    dq, dk, dv = (t.reshape(b * l, d) for t in
                  mha_bwd_plain(heads(q), heads(k), heads(v), heads(do), nheads))
    dxl = (dense_t(dq, in_w[:d]).float() + dense_t(dk, in_w[d : 2 * d]).float()
           + dense_t(dv, in_w[2 * d :]).float())
    xhat1, rstd1 = ln_stats(x2)
    dx_ln, dga, dba = ln_bwd(dxl, xhat1, rstd1, g_pre)
    dx = (dy.to(dt).reshape(b * l, d).float() + dx_ln).to(dt).view(b, l, d)
    d_in_w = torch.cat([grad_w(dq, qin, dt), grad_w(dk, qin, dt), grad_w(dv, xl, dt)])
    d_in_b = torch.cat([t.float().sum(0) for t in (dq, dk, dv)])
    return dx, d_in_w, d_in_b, grad_w(dop, o, dt), dbo, dga, dba, dgp, dbp


def cross_block_bwd_plain(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b,
                          g_pre, b_pre, g_post, b_post, dy, nheads: int,
                          seed: int = 0, rate: float = 0.0):
    """Plain twin of K3b (``_cross_bwd_kernel``).  Returns (dx, d txt,
    d in_w, d in_b, d out_w, d out_b, d g_pre, d b_pre, d g_post,
    d b_post)."""
    b, l, d = x.shape
    t = txt.shape[1]
    dt = x.dtype
    x2 = x.reshape(b * l, d)
    kv = txt.to(dt).reshape(b * t, d)
    xl = ln_fast(x2, g_pre, b_pre)
    qin = xl + pos.to(dt).repeat(b, 1)
    kin = kv + tpos.to(dt).repeat(b, 1)
    q = dense(qin, in_w[:d], in_b[:d])
    k = dense(kin, in_w[d : 2 * d], in_b[d : 2 * d])
    v = dense(kv, in_w[2 * d :], in_b[2 * d :])
    mask = key_mask(pad_mask, b, t, x.device)
    qs, ks, vs = q.view(b, l, d), k.view(b, t, d), v.view(b, t, d)
    o = attention_plain(qs, ks, vs, nheads, mask).reshape(b * l, d)
    op = dense(o, out_w, out_b)
    dop, dgp, dbp, dbo = _post_ln_bwd(dy.to(dt), op, g_post, seed, rate)
    do = dense_t(dop, out_w)
    dq, dk, dv = mha_bwd_plain(qs, ks, vs, do.view(b, l, d), nheads, mask)
    dq, dk, dv = dq.reshape(b * l, d), dk.reshape(b * t, d), dv.reshape(b * t, d)
    dxl = dense_t(dq, in_w[:d]).float()
    dkv = (dense_t(dk, in_w[d : 2 * d]).float()
           + dense_t(dv, in_w[2 * d :]).float()).to(dt).view(b, t, d)
    xhat1, rstd1 = ln_stats(x2)
    dx_ln, dga, dba = ln_bwd(dxl, xhat1, rstd1, g_pre)
    dx = (dy.to(dt).reshape(b * l, d).float() + dx_ln).to(dt).view(b, l, d)
    d_in_w = torch.cat([grad_w(dq, qin, dt), grad_w(dk, kin, dt), grad_w(dv, kv, dt)])
    d_in_b = torch.cat([t_.float().sum(0) for t_ in (dq, dk, dv)])
    return (dx, dkv, d_in_w, d_in_b, grad_w(dop, o, dt), dbo, dga, dba, dgp, dbp)


# ------------------------------------------------------------ CUDA side
def kernel_supported(d_model: int, nheads: int) -> bool:
    """Widths the block kernels take: 64-wide heads, D = 512."""
    return d_model == KERNEL_D and d_model == nheads * HEAD_DIM


def _check_block_input(x, nheads):
    if x.dim() != 3 or not kernel_supported(x.shape[-1], nheads):
        raise ValueError(
            f"decoder block kernels take x [B, L, 512] with 8 heads of 64, got "
            f"{tuple(x.shape)} and {nheads} heads"
        )
    if x.shape[1] > MAX_TOKENS:
        raise ValueError(
            f"decoder block kernels take at most {MAX_TOKENS} tokens, got {x.shape[1]}")
    cuda_build.require(x, "x", torch.bfloat16)


def _weights(x, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post):
    d = x.shape[-1]
    wi = in_w.to(torch.bfloat16).contiguous()
    wo = out_w.to(torch.bfloat16).contiguous()
    vecs = [t.float().contiguous() for t in (in_b, out_b, g_pre, b_pre, g_post, b_post)]
    cuda_build.require(wi, "in_w", torch.bfloat16, (3 * d, d))
    cuda_build.require(wo, "out_w", torch.bfloat16, (d, d))
    for t, n, size in zip(vecs, ("in_b", "out_b", "g_pre", "b_pre", "g_post", "b_post"),
                          (3 * d, d, d, d, d, d)):
        cuda_build.require(t, n, torch.float32, (size,))
    return wi, wo, vecs


def _wgrad_splits(m: int) -> int:
    """Row chunks of the dW kernels' first pass (summed in a fixed order by
    the second pass): at M = 16224, 16 chunks of the 8 [128, 256] tiles of a
    [512, 512] dW are 128 CTAs, one per SM of an H100."""
    return max(1, min(16, -(-m // 1024)))


def self_block_fwd(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post,
                   nheads: int, seed: int = 0, rate: float = 0.0, save: bool = False):
    """K2.  x [B, L, D]; pos [L, D].  Returns (x + block(x), saved), where
    ``saved`` holds what K2b reads when ``save`` (else None)."""
    work.note("decoder_self_block", lambda: (
        work.self_block_flops(*x.shape),
        work.nbytes(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post, x)))
    if x.device.type == "cpu":
        with work.uncounted():
            return self_block_plain(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre,
                                    g_post, b_post, nheads, seed, rate), None
    _check_block_input(x, nheads)
    b, l, d = x.shape
    posb = pos.to(torch.bfloat16).contiguous()
    cuda_build.require(posb, "pos", torch.bfloat16, (l, d))
    wi, wo, (bi, bo, gp, bp, gq, bq) = _weights(
        x, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post)
    new = lambda n: torch.empty(b * l, n, dtype=torch.bfloat16, device=x.device)
    y = torch.empty_like(x)
    ws = (new(d), new(d), new(2 * d), new(d), new(d))  # xl, qin, qk, v, o
    op = new(d) if save else None
    dseed, thresh, scale = kernel_args(seed, rate)
    lib = cuda_build.load("decoder_blocks")
    rc = lib.crog_self_block_fwd(
        x.data_ptr(), posb.data_ptr(), wi.data_ptr(), bi.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), gp.data_ptr(), bp.data_ptr(),
        gq.data_ptr(), bq.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in ws), None if op is None else op.data_ptr(),
        b, l, d, nheads, len(proj_plan(self_proj_segments(b * l))),
        len(out_schedule(b * l)[0]), dseed, thresh, scale, cuda_build.stream_ptr(x.device),
    )
    cuda_build.check_launch(lib, rc, "crog_self_block_fwd")
    self_block_fwd.launches += 1
    return y, ((wi, wo, gp, gq) + ws + (op,) if save else None)


self_block_fwd.launches = 0


def self_block_bwd(x, saved, dy, nheads: int, seed: int = 0, rate: float = 0.0):
    """K2b on a CUDA tensor: the backward kernels of csrc/decoder_blocks_bwd.cu
    over what ``self_block_fwd(save=True)`` kept.  Returns (dx, d in_w,
    d in_b, d out_w, d out_b, d g_pre, d b_pre, d g_post, d b_post)."""
    _check_block_input(x, nheads)
    b, l, d = x.shape
    m = b * l
    wi, wo, g_pre, g_post, xl, qin, qk, v, o, op = saved
    dy = dy.to(torch.bfloat16).contiguous()
    cuda_build.require(dy, "dy", torch.bfloat16, (b, l, d))
    dev = x.device
    bf = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=dev)
    f32 = lambda *s: torch.empty(*s, dtype=torch.float32, device=dev)
    splits = _wgrad_splits(m)
    dx, dwi, dwo, dvec = bf(b, l, d), bf(3 * d, d), bf(d, d), f32(8, d)
    ws = (bf(m, d), bf(m, d), bf(m, d), bf(m, d), bf(m, d), f32(m, d),
          f32(3, b * nheads, l), f32(splits, d, d), f32(splits, d),
          f32(-(-m // 64), 3, d))  # dop, do, dq, dk, dv, dxl, stats, parts
    dseed, thresh, scale = kernel_args(seed, rate)
    table = cuda_build.ptr_table(x, wi, wo, g_pre, g_post, xl, qin, qk, v, o, op, dy,
                  dx, dwi, dwo, dvec, *ws)
    lib = cuda_build.load("decoder_blocks_bwd")
    rc = lib.crog_self_block_bwd(table, b, l, d, nheads, splits, dseed, thresh, scale,
                                 cuda_build.stream_ptr(dev))
    cuda_build.check_launch(lib, rc, "crog_self_block_bwd")
    self_block_bwd.launches += 1
    return (dx, dwi.float(), dvec[:3].reshape(-1), dwo.float(), dvec[3], dvec[4],
            dvec[5], dvec[6], dvec[7])


self_block_bwd.launches = 0


def cross_block_fwd(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b, g_pre,
                    b_pre, g_post, b_post, nheads: int, seed: int = 0,
                    rate: float = 0.0, save: bool = False):
    """K3.  x [B, L, D]; txt [B, T, D]; pos [L, D]; tpos [T, D]; pad_mask
    [B, T] bool (True = ignore that key) or None.  Returns (y, saved)."""
    work.note("decoder_cross_block", lambda: (
        work.cross_block_flops(*x.shape[:2], txt.shape[1], x.shape[2]),
        work.nbytes(x, txt, pos, tpos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                    b_post, x) + (0 if pad_mask is None else work.nbytes(pad_mask))))
    if x.device.type == "cpu":
        with work.uncounted():
            return cross_block_plain(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w,
                                     out_b, g_pre, b_pre, g_post, b_post, nheads, seed,
                                     rate), None
    _check_block_input(x, nheads)
    b, l, d = x.shape
    t = txt.shape[1]
    kv = txt.to(torch.bfloat16).contiguous()
    cuda_build.require(kv, "txt", torch.bfloat16, (b, t, d))
    posb = pos.to(torch.bfloat16).contiguous()
    tposb = tpos.to(torch.bfloat16).contiguous()
    cuda_build.require(posb, "pos", torch.bfloat16, (l, d))
    cuda_build.require(tposb, "tpos", torch.bfloat16, (t, d))
    mask = key_mask(pad_mask, b, t, x.device).contiguous()
    cuda_build.require(mask, "key mask", torch.float32, (b, t))
    wi, wo, (bi, bo, gp, bp, gq, bq) = _weights(
        x, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post)
    new = lambda n: torch.empty(n, d, dtype=torch.bfloat16, device=x.device)
    y = torch.empty_like(x)
    # qin, q, o [B*L, D]; kin, k, v [B*T, D]
    ws = (new(b * l), new(b * l), new(b * l), new(b * t), new(b * t), new(b * t))
    op = new(b * l) if save else None
    dseed, thresh, scale = kernel_args(seed, rate)
    lib = cuda_build.load("decoder_blocks")
    rc = lib.crog_cross_block_fwd(
        x.data_ptr(), kv.data_ptr(), posb.data_ptr(), tposb.data_ptr(),
        mask.data_ptr(), wi.data_ptr(), bi.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), gp.data_ptr(), bp.data_ptr(), gq.data_ptr(),
        bq.data_ptr(), y.data_ptr(), *(w.data_ptr() for w in ws),
        None if op is None else op.data_ptr(),
        b, l, t, d, nheads, len(proj_plan(cross_proj_segments(b * l, b * t))),
        len(out_schedule(b * l)[0]), dseed, thresh, scale, cuda_build.stream_ptr(x.device),
    )
    cuda_build.check_launch(lib, rc, "crog_cross_block_fwd")
    cross_block_fwd.launches += 1
    return y, ((kv, mask, wi, wo, gp, gq) + ws + (op,) if save else None)


cross_block_fwd.launches = 0


def cross_block_bwd(x, saved, dy, nheads: int, seed: int = 0, rate: float = 0.0):
    """K3b on a CUDA tensor.  Returns (dx, d txt, d in_w, d in_b, d out_w,
    d out_b, d g_pre, d b_pre, d g_post, d b_post)."""
    _check_block_input(x, nheads)
    b, l, d = x.shape
    kv, mask, wi, wo, g_pre, g_post, qin, q, o, kin, k, v, op = saved
    t = kv.shape[1]
    m, mt = b * l, b * t
    dy = dy.to(torch.bfloat16).contiguous()
    cuda_build.require(dy, "dy", torch.bfloat16, (b, l, d))
    dev = x.device
    bf = lambda *s: torch.empty(*s, dtype=torch.bfloat16, device=dev)
    f32 = lambda *s: torch.empty(*s, dtype=torch.float32, device=dev)
    splits = _wgrad_splits(m)
    dx, dkv, dwi, dwo, dvec = bf(b, l, d), bf(b, t, d), bf(3 * d, d), bf(d, d), f32(8, d)
    ws = (bf(m, d), bf(m, d), bf(m, d), bf(mt, d), bf(mt, d), f32(m, d),
          f32(3, b * nheads, l), f32(splits, d, d), f32(splits, d),
          f32(-(-m // 64), 3, d))  # dop, do, dq, dk, dv, dxl, stats, parts
    dseed, thresh, scale = kernel_args(seed, rate)
    table = cuda_build.ptr_table(x, kv, mask, wi, wo, g_pre, g_post, qin, q, o, kin, k, v, op, dy,
                  dx, dkv, dwi, dwo, dvec, *ws)
    lib = cuda_build.load("decoder_blocks_bwd")
    rc = lib.crog_cross_block_bwd(table, b, l, t, d, nheads, splits, dseed, thresh,
                                  scale, cuda_build.stream_ptr(dev))
    cuda_build.check_launch(lib, rc, "crog_cross_block_bwd")
    cross_block_bwd.launches += 1
    return (dx, dkv, dwi.float(), dvec[:3].reshape(-1), dwo.float(), dvec[3],
            dvec[4], dvec[5], dvec[6], dvec[7])


cross_block_bwd.launches = 0


# ------------------------------------------------------------- autograd
class _SelfBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, *args):
        *params, nheads, seed, rate, save = args
        ctx.nheads, ctx.seed, ctx.rate = nheads, seed, rate
        y, saved = self_block_fwd(x, pos, *params, nheads, seed, rate, save)
        ctx.saved = saved
        ctx.save_for_backward(x, pos, *params)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, pos, *params = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = self_block_bwd_plain(x, pos, *params, dy, ctx.nheads, ctx.seed,
                                         ctx.rate)
        else:
            grads = self_block_bwd(x, ctx.saved, dy, ctx.nheads, ctx.seed, ctx.rate)
        ctx.saved = None
        return (grads[0], None, *grads[1:], None, None, None, None)


class _CrossBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, txt, pos, tpos, pad_mask, *args):
        *params, nheads, seed, rate, save = args
        ctx.nheads, ctx.seed, ctx.rate = nheads, seed, rate
        ctx.pad_mask = pad_mask
        y, saved = cross_block_fwd(x, txt, pos, tpos, pad_mask, *params, nheads,
                                   seed, rate, save)
        ctx.saved = saved
        ctx.save_for_backward(x, txt, pos, tpos, *params)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, txt, pos, tpos, *params = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = cross_block_bwd_plain(x, txt, pos, tpos, ctx.pad_mask, *params, dy,
                                          ctx.nheads, ctx.seed, ctx.rate)
        else:
            grads = cross_block_bwd(x, ctx.saved, dy, ctx.nheads, ctx.seed, ctx.rate)
        ctx.saved = ctx.pad_mask = None
        dtxt = grads[1].to(txt.dtype)
        return (grads[0], dtxt, None, None, None, *grads[2:], None, None, None, None)


def decoder_self_block(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                       b_post, nheads: int, seed: int = 0, rate: float = 0.0):
    """x + block(x) with K2 forward and K2b backward; ``pos`` takes no
    gradient (fixed sin/cos)."""
    return _SelfBlock.apply(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                            b_post, nheads, seed, rate, torch.is_grad_enabled())


def decoder_cross_block(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b,
                        g_pre, b_pre, g_post, b_post, nheads: int, seed: int = 0,
                        rate: float = 0.0):
    """x + block(x, txt) with K3 forward and K3b backward; gradients for x,
    txt and the parameters (``pos``/``tpos`` are fixed sin/cos)."""
    return _CrossBlock.apply(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b,
                             g_pre, b_pre, g_post, b_post, nheads, seed, rate,
                             torch.is_grad_enabled())
