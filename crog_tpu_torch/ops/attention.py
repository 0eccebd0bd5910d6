"""Multi-head attention, and K1/K1b: the fused attention kernel and its
backward.

Counterpart of crog_tpu/ops/attention.py (``attention_core``,
``MultiHeadAttention``) and crog_tpu/ops/pallas_attention.py
(``fused_self_attention`` and its custom VJP).  Unmasked self-shaped
attention over at least 64 tokens (the CLIP attention pool's 169) goes to
``FusedAttention``, as ``_use_fused`` routes it to the Pallas kernel on a
TPU: its forward is ``fused_attention`` (K1, csrc/attention.cu) and its
backward ``attention_bwd`` (K1b, csrc/attention_bwd.cu) on a CUDA tensor,
their plain PyTorch twins on a CPU tensor.  Masked or short attention (the
17-token causal text tower) stays a plain matmul + fp32 softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crog_tpu_torch.ops import cuda_build, work

NEG = -1e30  # the kernels' mask value: finite, keeps all-masked rows finite
MAX_KEYS = 768  # the kernels' limit on keys per head
ONE_PASS_MAX_KEYS = 192  # the forward's one-pass kernel holds 3 key tiles of scores
HEAD_MAX_LEN = 256  # K1b's one-CTA-per-head kernel holds a whole head
HEAD_DIM = 64


def _use_fused(lq, lk, attn_mask, key_padding_mask) -> bool:
    return attn_mask is None and key_padding_mask is None and lq == lk and lq >= 64


def attention_plain(q, k, v, num_heads: int, mask_add=None):
    """Plain twin of the kernel: softmax(q k^T / sqrt(dh) + mask) v per head.

    q [B, Lq, H*dh], k/v [B, Lk, H*dh]; ``mask_add`` [B, Lk] additive f32 or
    None.  Scores and softmax in f32 on the operands' values; the normalized
    probabilities are rounded to v's dtype before P.V (f32 accumulation),
    and the result is rounded to q's dtype — the TPU kernel's cast points.
    """
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // num_heads
    qh = q.reshape(b, lq, num_heads, dh).transpose(1, 2).float()
    kh = k.reshape(b, lk, num_heads, dh).transpose(1, 2).float()
    vh = v.reshape(b, lk, num_heads, dh).transpose(1, 2).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * dh**-0.5
    if mask_add is not None:
        s = s + mask_add.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.matmul(p, vh)
    return o.transpose(1, 2).reshape(b, lq, d).to(q.dtype)


def _check_rows(t: torch.Tensor, name: str) -> None:
    cuda_build.require(t, name, torch.bfloat16, contiguous=False)
    if t.dim() != 3 or t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
        raise ValueError(
            f"{name}: expected [B, L, D] with unit feature stride and row and "
            f"batch strides divisible by 8, got strides {t.stride()}"
        )


def fwd_path(lk: int) -> str:
    """Which forward kernel takes a head of ``lk`` keys: "one_pass" (the
    head's scores in registers, K1's 169 and K3's 17 keys) up to
    ONE_PASS_MAX_KEYS, else "two_pass" (statistics, then P.V; K2's 676), up
    to MAX_KEYS.  csrc/attention.cuh:attn_fwd_key_tiles makes the same
    choice on the card."""
    if not 1 <= lk <= MAX_KEYS:
        raise ValueError(f"attention kernel takes 1..{MAX_KEYS} keys, got {lk}")
    return "one_pass" if lk <= ONE_PASS_MAX_KEYS else "two_pass"


def fused_attention(q, k, v, num_heads: int, mask_add=None):
    """K1.  q [B, Lq, H*64], k/v [B, Lk, H*64] bf16 (any row and batch
    stride, unit feature stride); ``mask_add`` [B, Lk] f32 or None.

    On a CPU tensor this is ``attention_plain``; on a CUDA tensor it launches
    crog_attention_fwd (csrc/attention.cu), whose kernel ``fwd_path`` names,
    or raises."""
    work.note("attention", lambda: (
        work.attention_flops(*q.shape[:2], k.shape[1], q.shape[2]),
        work.nbytes(q, k, v, q) + (0 if mask_add is None else work.nbytes(mask_add))))
    if q.device.type == "cpu":
        with work.uncounted():
            return attention_plain(q, k, v, num_heads, mask_add)
    b, lq, d = q.shape
    lk = k.shape[1]
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(t, name)
    if d != num_heads * HEAD_DIM or k.shape != (b, lk, d) or v.shape != (b, lk, d):
        raise ValueError(
            f"attention kernel takes head dim {HEAD_DIM}: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, {num_heads} heads"
        )
    fwd_path(lk)  # raises past MAX_KEYS
    if mask_add is not None:
        cuda_build.require(mask_add, "mask_add", torch.float32, (b, lk))
    o = torch.empty(b, lq, d, dtype=torch.bfloat16, device=q.device)
    lib = cuda_build.load("attention")
    rc = lib.crog_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask_add is None else mask_add.data_ptr(),
        o.data_ptr(), b, num_heads, lq, lk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        HEAD_DIM**-0.5, cuda_build.stream_ptr(q.device),
    )
    cuda_build.check_launch(lib, rc, "crog_attention_fwd")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0


def _split_heads(t, num_heads: int):
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(t, dtype):
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh).to(dtype)


def attention_bwd_plain(q, k, v, o, do, num_heads: int):
    """Plain twin of K1b (``_bwd_kernel`` of pallas_attention.py): everything
    in f32 -- q, k, v, o and do upcast, P, dP and dS f32, delta =
    rowsum(do * o) -- and only dq, dk, dv rounded to q's dtype."""
    qh, kh, vh, oh, doh = (_split_heads(t, num_heads).float() for t in (q, k, v, o, do))
    scale = qh.shape[-1] ** -0.5
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_merge_heads(t, q.dtype) for t in (dq, dk, dv))


def mha_bwd_plain(q, k, v, do, num_heads: int, mask_add=None):
    """Plain twin of the attention step inside the decoder blocks' backward
    (``_mha_bwd`` of pallas_decoder.py): bf16 operands with f32 sums; P is
    recomputed in f32 and rounded to q's dtype for dV = P^T dO; delta =
    rowsum(dP * P) on the f32 P; dS is rounded to q's dtype before dQ and
    dK."""
    dt = q.dtype
    qh, kh, vh, doh = (_split_heads(t, num_heads).float() for t in (q, k, v, do.to(dt)))
    scale = qh.shape[-1] ** -0.5
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if mask_add is not None:
        s = s + mask_add.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_merge_heads(t, dt) for t in (dq, dk, dv))


def _check_bwd_width(q, num_heads: int) -> None:
    b, l, d = q.shape
    if d != num_heads * HEAD_DIM or not 1 <= l <= MAX_KEYS:
        raise ValueError(
            f"attention backward kernel takes head dim {HEAD_DIM} and 1..{MAX_KEYS} "
            f"tokens: q {tuple(q.shape)}, {num_heads} heads"
        )


def bwd_path(l: int, bf16_casts: bool = False) -> str:
    """Which K1b kernel takes a head of ``l`` tokens: "head" (one CTA per
    head, crog_attention_bwd_head) up to HEAD_MAX_LEN tokens, else
    "rows_cols" (the two kernels of crog_attention_bwd, up to MAX_KEYS);
    the decoder blocks' cast points exist only on the two-kernel path."""
    return "head" if l <= HEAD_MAX_LEN and not bf16_casts else "rows_cols"


def attention_bwd(q, k, v, o, do, num_heads: int, bf16_casts: bool = False, mask_add=None):
    """K1b.  q, o, do [B, Lq, H*64], k, v [B, Lk, H*64] bf16 (contiguous)
    -> dq, dk, dv.

    On a CPU tensor this is ``attention_bwd_plain``; on a CUDA tensor it
    launches the kernel ``bwd_path`` names (csrc/attention_bwd.cu) or
    raises.  ``bf16_casts`` swaps in the decoder blocks' cast points (P and
    dS rounded to bf16, twin ``mha_bwd_plain``) on the two-kernel path that
    K2b and K3b run, which alone takes a key mask ``mask_add`` [B, Lk] f32
    and Lk != Lq; only the checks of that path and of K1b's tolerance set
    it (chip_smoke.py, tests/test_torch_cuda_kernels.py)."""
    if q.device.type == "cpu":
        if bf16_casts:
            return mha_bwd_plain(q, k, v, do, num_heads, mask_add)
        return attention_bwd_plain(q, k, v, o, do, num_heads)
    _check_bwd_width(q, num_heads)
    _check_bwd_width(k, num_heads)
    b, lq, d = q.shape
    lk = k.shape[1]
    if not bf16_casts and (mask_add is not None or lk != lq):
        raise ValueError("K1b takes unmasked self attention; a key mask or Lk != Lq "
                         "runs only with the decoder blocks' bf16 cast points")
    for t, name in ((q, "q"), (o, "o"), (do, "do")):
        cuda_build.require(t, name, torch.bfloat16, (b, lq, d))
    for t, name in ((k, "k"), (v, "v")):
        cuda_build.require(t, name, torch.bfloat16, (b, lk, d))
    if mask_add is not None:
        cuda_build.require(mask_add, "mask_add", torch.float32, (b, lk))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv)]
    lib = cuda_build.load("attention_bwd")
    stream = cuda_build.stream_ptr(q.device)
    if lq == lk and bwd_path(lq, bf16_casts) == "head":
        rc = lib.crog_attention_bwd_head(*ptrs, b, num_heads, lq, HEAD_DIM**-0.5, stream)
        cuda_build.check_launch(lib, rc, "crog_attention_bwd_head")
    else:
        stats = torch.empty(3, b * num_heads, lq, dtype=torch.float32, device=q.device)
        rc = lib.crog_attention_bwd(*ptrs, stats.data_ptr(),
                                    None if mask_add is None else mask_add.data_ptr(),
                                    b, num_heads, lq, lk, HEAD_DIM**-0.5, int(bf16_casts),
                                    stream)
        cuda_build.check_launch(lib, rc, "crog_attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class FusedAttention(torch.autograd.Function):
    """K1 forward, K1b backward (``fused_self_attention``'s custom VJP).
    The backward recomputes the row statistics from q and k instead of
    saving the forward's logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        o = fused_attention(q, k, v, num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*attention_bwd(q, k, v, o, do.contiguous(), ctx.num_heads), None)


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over projected q/k/v.

    q: [B, Lq, D], k/v: [B, Lk, D].
    attn_mask: additive [Lq, Lk] (e.g. causal -inf upper triangle).
    key_padding_mask: [B, Lk] bool, True = ignore that key.
    """
    b, lq, d = q.shape
    lk = k.shape[1]
    if _use_fused(lq, lk, attn_mask, key_padding_mask):
        return FusedAttention.apply(q, k, v, num_heads)
    dh = d // num_heads
    qh = q.reshape(b, lq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(b, lk, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, lk, num_heads, dh).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * dh**-0.5
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    if key_padding_mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], neg)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights, vh)
    return out.transpose(1, 2).reshape(b, lq, d)


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype with fp32 parameters (flax
    ``Dense(dtype=compute, param_dtype=float32)``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameter schema (packed
    ``in_proj_weight``/``in_proj_bias``, ``out_proj``) computing through
    ``attention_core``."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, attn_mask=None, key_padding_mask=None):
        d = query.shape[-1]
        w = self.in_proj_weight.to(query.dtype)
        bias = self.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:d], bias[:d])
        k = F.linear(key, w[d : 2 * d], bias[d : 2 * d])
        v = F.linear(value, w[2 * d :], bias[2 * d :])
        out = attention_core(q, k, v, self.num_heads, attn_mask, key_padding_mask)
        return self.out_proj(out)
