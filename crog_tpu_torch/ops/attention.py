"""Multi-head attention, and K1: the fused attention kernel.

Counterpart of crog_tpu/ops/attention.py (``attention_core``,
``MultiHeadAttention``) and crog_tpu/ops/pallas_attention.py
(``fused_self_attention``).  Unmasked self-shaped attention over at least 64
tokens (the CLIP attention pool's 169) goes to ``fused_attention``, as
``_use_fused`` routes it to the Pallas kernel on a TPU; on a CUDA tensor that
launches the hand-written kernel of csrc/attention.cu, on a CPU tensor its
plain PyTorch twin.  Masked or short attention (the 17-token causal text
tower) stays a plain matmul + fp32 softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crog_tpu_torch.ops import cuda_build

NEG = -1e30  # the kernels' mask value: finite, keeps all-masked rows finite
MAX_KEYS = 768  # the kernel keeps a [64, Lk] score block in shared memory
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


def fused_attention(q, k, v, num_heads: int, mask_add=None):
    """K1.  q [B, Lq, H*64], k/v [B, Lk, H*64] bf16 (any row and batch
    stride, unit feature stride); ``mask_add`` [B, Lk] f32 or None.

    On a CPU tensor this is ``attention_plain``; on a CUDA tensor it launches
    crog_attention_fwd (csrc/attention.cu) or raises."""
    if q.device.type == "cpu":
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
    if not 1 <= lk <= MAX_KEYS:
        raise ValueError(f"attention kernel takes 1..{MAX_KEYS} keys, got {lk}")
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
        return fused_attention(q, k, v, num_heads)
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
