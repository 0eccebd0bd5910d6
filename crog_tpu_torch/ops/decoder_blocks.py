"""K2 and K3: the decoder's pre-LN self- and cross-attention blocks.

Counterpart of crog_tpu/ops/pallas_decoder.py ``decoder_self_block`` (590)
and ``decoder_cross_block`` (613), forward only:

  self : x + LN_post(OutProj(MHA(LN_pre(x)+pos, LN_pre(x)+pos, LN_pre(x))))
  cross: x + LN_post(OutProj(MHA(LN_pre(x)+pos, txt+tpos, txt)))

Weights are in torch layout: ``in_w`` [3D, D] packs the q/k/v projections
(nn.MultiheadAttention's ``in_proj_weight``), ``out_w`` [D, D]; biases and
LN affines are 1-D.  On a CUDA tensor each block launches the kernel
sequence of csrc/decoder_blocks.cu (or raises); on a CPU tensor it runs the
plain twin, which keeps the TPU kernel's cast points: bf16 after every Dense
and every LN, f32 LN statistics with flax's fast variance, f32 softmax.
"""

from __future__ import annotations

import torch

from crog_tpu_torch.ops import cuda_build
from crog_tpu_torch.ops.attention import HEAD_DIM, NEG, attention_plain

EPS = 1e-5


def ln_fast(x, g, b, eps: float = EPS):
    """LayerNorm with f32 statistics and flax's fast variance
    E[x^2] - E[x]^2, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = (mu2 - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()
    return y.to(x.dtype)


def dense(x, w, b):
    """x W^T + b with the sum in f32 and one rounding to x's dtype (the TPU
    kernels' ``_dense``); ``w`` is [out, in]."""
    y = torch.matmul(x.float(), w.to(x.dtype).float().t())
    return (y + b.float()).to(x.dtype)


def key_mask(pad_mask, b: int, t: int, device):
    """[B, T] additive f32 key mask: 0 keep, -1e30 for padded keys."""
    if pad_mask is None:
        return torch.zeros(b, t, dtype=torch.float32, device=device)
    return torch.where(pad_mask.bool(), NEG, 0.0).to(torch.float32)


def self_block_plain(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                     b_post, nheads: int):
    d = x.shape[-1]
    xl = ln_fast(x, g_pre, b_pre)
    qin = xl + pos.to(x.dtype)
    q = dense(qin, in_w[:d], in_b[:d])
    k = dense(qin, in_w[d : 2 * d], in_b[d : 2 * d])
    v = dense(xl, in_w[2 * d :], in_b[2 * d :])
    o = attention_plain(q, k, v, nheads)
    on = ln_fast(dense(o, out_w, out_b), g_post, b_post)
    return x + on


def cross_block_plain(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b,
                      g_pre, b_pre, g_post, b_post, nheads: int):
    d = x.shape[-1]
    xl = ln_fast(x, g_pre, b_pre)
    kv = txt.to(x.dtype)
    q = dense(xl + pos.to(x.dtype), in_w[:d], in_b[:d])
    k = dense(kv + tpos.to(x.dtype), in_w[d : 2 * d], in_b[d : 2 * d])
    v = dense(kv, in_w[2 * d :], in_b[2 * d :])
    mask = key_mask(pad_mask, txt.shape[0], txt.shape[1], x.device)
    o = attention_plain(q, k, v, nheads, mask)
    on = ln_fast(dense(o, out_w, out_b), g_post, b_post)
    return x + on


def kernel_supported(d_model: int, nheads: int) -> bool:
    """Widths the block kernels take: 64-wide heads, D = 512."""
    return d_model == 512 and d_model == nheads * HEAD_DIM


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


def _check_block_input(x, nheads):
    cuda_build.require(x, "x", torch.bfloat16)
    if x.dim() != 3 or not kernel_supported(x.shape[-1], nheads):
        raise ValueError(
            f"decoder block kernels take x [B, L, 512] with 8 heads of 64, got "
            f"{tuple(x.shape)} and {nheads} heads"
        )
    if x.shape[1] > 768:
        raise ValueError(f"decoder block kernels take at most 768 tokens, got {x.shape[1]}")


def decoder_self_block(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post,
                       b_post, nheads: int):
    """K2.  x [B, L, D]; pos [L, D].  Returns x + block(x)."""
    if x.device.type == "cpu":
        return self_block_plain(x, pos, in_w, in_b, out_w, out_b, g_pre, b_pre,
                                g_post, b_post, nheads)
    _check_block_input(x, nheads)
    b, l, d = x.shape
    posb = pos.to(torch.bfloat16).contiguous()
    cuda_build.require(posb, "pos", torch.bfloat16, (l, d))
    wi, wo, (bi, bo, gp, bp, gq, bq) = _weights(
        x, in_w, in_b, out_w, out_b, g_pre, b_pre, g_post, b_post)
    new = lambda n: torch.empty(b * l, n, dtype=torch.bfloat16, device=x.device)
    y = torch.empty_like(x)
    ws = (new(d), new(d), new(2 * d), new(d), new(d))  # xl, qin, qk, v, o
    lib = cuda_build.load("decoder_blocks")
    rc = lib.crog_self_block_fwd(
        x.data_ptr(), posb.data_ptr(), wi.data_ptr(), bi.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), gp.data_ptr(), bp.data_ptr(),
        gq.data_ptr(), bq.data_ptr(), y.data_ptr(),
        *(t.data_ptr() for t in ws), b, l, d, nheads,
        cuda_build.stream_ptr(x.device),
    )
    cuda_build.check_launch(lib, rc, "crog_self_block_fwd")
    decoder_self_block.launches += 1
    return y


decoder_self_block.launches = 0


def decoder_cross_block(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w, out_b,
                        g_pre, b_pre, g_post, b_post, nheads: int):
    """K3.  x [B, L, D]; txt [B, T, D]; pos [L, D]; tpos [T, D]; pad_mask
    [B, T] bool (True = ignore that key) or None."""
    if x.device.type == "cpu":
        return cross_block_plain(x, txt, pos, tpos, pad_mask, in_w, in_b, out_w,
                                 out_b, g_pre, b_pre, g_post, b_post, nheads)
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
    ws = (new(b * l), new(b * l), new(b * l), new(b * t), new(b * t), new(b * t))
    lib = cuda_build.load("decoder_blocks")
    rc = lib.crog_cross_block_fwd(
        x.data_ptr(), kv.data_ptr(), posb.data_ptr(), tposb.data_ptr(),
        mask.data_ptr(), wi.data_ptr(), bi.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), gp.data_ptr(), bp.data_ptr(), gq.data_ptr(),
        bq.data_ptr(), y.data_ptr(), *(w.data_ptr() for w in ws),
        b, l, t, d, nheads, cuda_build.stream_ptr(x.device),
    )
    cuda_build.check_launch(lib, rc, "crog_cross_block_fwd")
    decoder_cross_block.launches += 1
    return y


decoder_cross_block.launches = 0
