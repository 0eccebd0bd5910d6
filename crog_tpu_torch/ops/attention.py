"""Multi-head attention, and K1/K1b: the fused attention kernel and its
backward.

Counterpart of crog_tpu/ops/attention.py (``attention_core``,
``MultiHeadAttention``) and crog_tpu/ops/pallas_attention.py
(``fused_self_attention`` and its custom VJP).  Unmasked self-shaped
attention over at least 64 tokens (the CLIP attention pool's 169) goes to
``FusedAttention``, as ``_use_fused`` routes it to the Pallas kernel on a
TPU: its forward is ``fused_attention`` (K1, csrc/attention.cu) and its
backward ``attention_bwd`` (K1b, csrc/attention_bwd.cu) on a CUDA tensor,
their plain PyTorch twins on a CPU tensor.  On fp32 operands (a model
built with ``compute_dtype: float32``) they launch K1-f32
(csrc/attention_f32.cu) and K1b-f32 (csrc/attention_bwd_f32.cu) instead.
Masked or short attention (the 17-token causal text tower) stays a plain
matmul + fp32 softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crog_tpu_torch.ops import cuda_build, work

NEG = -1e30  # the kernels' mask value: finite, keeps all-masked rows finite
ONE_PASS_MAX_KEYS = 192  # the forward's one-pass kernel holds 3 key tiles of scores
HEAD_MAX_LEN = 256  # K1b's one-CTA-per-head kernel holds a whole head
HEAD_KERNEL_DIM = 64  # ... of this head dim (every CLIP attention's)
HEAD_DIMS = (8, 16, 32, 64, 128, 256, 512)  # the head dims the attention kernels take
WIDE_MIN_DIM = 256  # from this head dim on the wide builds stream the head in chunks
_DIMS = ", ".join(map(str, HEAD_DIMS[:-1])) + f" or {HEAD_DIMS[-1]}"
F32_KEY_BLOCK = 64  # keys per main-kernel block of the fp32 backward
F32_MAX_DQ_PARTS = 11  # its dQ partials at most (csrc/attention_bwd_f32.cuh kAbF32MaxParts)


def _use_fused(lq, lk, attn_mask, key_padding_mask) -> bool:
    return attn_mask is None and key_padding_mask is None and lq == lk and lq >= 64


def attention_plain(q, k, v, num_heads: int, mask_add=None, with_lse: bool = False):
    """Plain twin of the kernel: softmax(q k^T / sqrt(dh) + mask) v per head.

    q [B, Lq, H*dh], k/v [B, Lk, H*dh]; ``mask_add`` [B, Lk] additive f32 or
    None.  Scores and softmax in f32 on the operands' values; the normalized
    probabilities are rounded to v's dtype before P.V (f32 accumulation),
    and the result is rounded to q's dtype — the TPU kernel's cast points.
    ``with_lse`` also returns each row's logsumexp of the scores, [B, H, Lq]
    f32, as ``_fwd_kernel`` saves it for the backward (K1-f32's twin).
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
    o = torch.matmul(p, vh).transpose(1, 2).reshape(b, lq, d).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if with_lse else o


def _check_rows(t: torch.Tensor, name: str, dtype: torch.dtype = torch.bfloat16) -> None:
    cuda_build.require(t, name, dtype, contiguous=False)
    per16 = 16 // t.element_size()  # elements in a 16-byte row segment
    if t.dim() != 3 or t.stride(2) != 1 or t.stride(1) % per16 or t.stride(0) % per16:
        raise ValueError(
            f"{name}: expected [B, L, D] with unit feature stride and row and "
            f"batch strides divisible by {per16}, got strides {t.stride()}"
        )


def head_tile(dh: int) -> int:
    """The head tile of the kernel build that takes a head of ``dh``
    columns (csrc/common.cuh attn_head_tile): 32 for dh 8, 16 and 32 (the
    columns past dh zero-filled in shared memory, never stored), else dh
    (64, 128, and the wide builds 256 and 512, whose CTAs split the head's
    output columns and stream it in 64-column chunks); 0 for a head dim no
    kernel takes."""
    return max(dh, 32) if dh in HEAD_DIMS else 0


def head_dim(d: int, num_heads: int) -> int:
    """The head dim of a ``d``-wide projection over ``num_heads`` heads if
    the kernels take it (one of HEAD_DIMS), else 0 (csrc/common.cuh
    attn_head_dim)."""
    return d // num_heads if num_heads > 0 and d % num_heads == 0 and head_tile(
        d // num_heads) else 0


def fwd_path(lk: int, dh: int = HEAD_KERNEL_DIM) -> str:
    """Which forward kernel takes a head of ``lk`` keys and head dim ``dh``:
    "one_pass" (the head's scores in registers, K1's 169 and K3's 17 keys)
    up to ONE_PASS_MAX_KEYS below WIDE_MIN_DIM, else "two_pass" (statistics,
    then P.V; K2's 676, any longer head: 1600 at 640^2, and every length at
    dh 256 and 512, whose kernel streams K in chunks twice).
    csrc/attention.cuh (attn_fwd_key_tiles, and the wide kernel's attributes)
    makes the same choice on the card."""
    if lk < 1:
        raise ValueError(f"attention kernel takes at least 1 key, got {lk}")
    return "one_pass" if lk <= ONE_PASS_MAX_KEYS and dh < WIDE_MIN_DIM else "two_pass"


def fused_attention(q, k, v, num_heads: int, mask_add=None, with_lse: bool = False):
    """K1.  q [B, Lq, H*dh], k/v [B, Lk, H*dh] with dh one of HEAD_DIMS,
    all bf16 or all fp32 (any row and batch stride, unit feature stride);
    ``mask_add`` [B, Lk] f32 or None.

    On a CPU tensor this is ``attention_plain``; on a CUDA tensor it launches
    the build for q's dtype (``cuda_build.library_for``): crog_attention_fwd
    (csrc/attention.cu, bf16), whose kernel ``fwd_path`` names, or
    crog_attention_f32_fwd (csrc/attention_f32.cu, fp32, counted in
    ``fused_attention.launches_f32``); or raises.  ``with_lse`` (fp32 only)
    also returns each row's logsumexp [B, H, Lq] f32, which K1b-f32 reads."""
    work.note("attention", lambda: (
        work.attention_flops(*q.shape[:2], k.shape[1], q.shape[2]),
        work.nbytes(q, k, v, q) + (0 if mask_add is None else work.nbytes(mask_add))))
    if q.device.type == "cpu":
        with work.uncounted():
            return attention_plain(q, k, v, num_heads, mask_add, with_lse)
    name = cuda_build.library_for("attention", q.dtype)
    if with_lse and q.dtype != torch.float32:
        raise ValueError("K1 writes a logsumexp only at fp32 (K1-f32)")
    b, lq, d = q.shape
    lk = k.shape[1]
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        _check_rows(t, n, q.dtype)
    dh = head_dim(d, num_heads)
    if not dh or k.shape != (b, lk, d) or v.shape != (b, lk, d):
        raise ValueError(
            f"attention kernel takes head dims {_DIMS}: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, {num_heads} heads"
        )
    fwd_path(lk, dh)  # raises on no keys
    if mask_add is not None:
        cuda_build.require(mask_add, "mask_add", torch.float32, (b, lk))
    o = torch.empty(b, lq, d, dtype=q.dtype, device=q.device)
    lib = cuda_build.load(name)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_add is None else mask_add.data_ptr(), o.data_ptr())
    args = (b, num_heads, lq, lk, dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1), dh**-0.5)
    stream = cuda_build.stream_ptr(q.device)
    if q.dtype == torch.float32:
        lse = (torch.empty(b, num_heads, lq, dtype=torch.float32, device=q.device)
               if with_lse else None)
        rc = lib.crog_attention_f32_fwd(*ptrs, None if lse is None else lse.data_ptr(), *args,
                                        stream)
        cuda_build.check_launch(lib, rc, "crog_attention_f32_fwd")
        fused_attention.launches_f32 += 1
        return (o, lse) if with_lse else o
    rc = lib.crog_attention_fwd(*ptrs, *args, stream)
    cuda_build.check_launch(lib, rc, "crog_attention_fwd")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
fused_attention.launches_f32 = 0


def _split_heads(t, num_heads: int):
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(t, dtype):
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh).to(dtype)


def attention_bwd_plain(q, k, v, o, do, num_heads: int, lse=None, mask_add=None):
    """Plain twin of K1b (``_bwd_kernel`` of pallas_attention.py): everything
    in f32 -- q, k, v, o and do upcast, P, dP and dS f32, delta =
    rowsum(do * o) -- and only dq, dk, dv rounded to q's dtype.  With the
    forward's logsumexp ``lse`` [B, H, Lq] (K1b-f32's twin) P = exp(s -
    lse), as ``_bwd_kernel`` takes it; without, softmax(s).  ``mask_add``
    [B, Lk] additive f32 or None."""
    qh, kh, vh, oh, doh = (_split_heads(t, num_heads).float() for t in (q, k, v, o, do))
    scale = qh.shape[-1] ** -0.5
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if mask_add is not None:
        s = s + mask_add.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1) if lse is None else torch.exp(s - lse[..., None])
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


def attention_bwd_f32_plain(q, k, v, do, num_heads: int, mask_add=None, o=None, lse=None):
    """The decomposition of the fp32 attention backward's kernels
    (csrc/attention_bwd_f32.cuh) in plain PyTorch, all f32, for the CPU
    tests only (nothing on the card path calls it; the kernels' twins are
    ``attention_bwd_plain`` and ``mha_bwd_plain``).  Each row's statistics:
    with the forward's logsumexp ``lse`` [B, H, Lq] (K1b-f32) m = lse, r =
    1, delta = rowsum(do * o); without it (the blocks) m, r = 1 / l and
    delta = sum(p dp) / l from a pass over 64-key tiles with online
    rescaling.  Then, per 64-key block over 32-query tiles, p = exp(x - m)
    r, dS, dV and dK (each tile's sums added to the running ones) and the
    block's dQ; each group of ``f32_dq_parts`` consecutive blocks adds its
    blocks' dQ in key order into one partial, and dq is the partials added
    in key-block order."""
    qh, kh, vh, doh = (_split_heads(t, num_heads).float() for t in (q, k, v, do))
    b, h, lq, dh = qh.shape
    lk = kh.shape[2]
    scale = dh**-0.5
    madd = (torch.zeros(b, 1, 1, lk) if mask_add is None
            else mask_add.float()[:, None, None, :])
    x_of = lambda qs, k0, k1: (torch.matmul(qs, kh[:, :, k0:k1].transpose(-1, -2)) * scale
                               + madd[..., k0:k1])
    if lse is not None:
        m, r = lse.float(), torch.ones(b, h, lq)
        delta = (doh * _split_heads(o, num_heads).float()).sum(-1)
    else:
        m = torch.full((b, h, lq), float("-inf"))
        l, w = torch.zeros(b, h, lq), torch.zeros(b, h, lq)
        for k0 in range(0, lk, 64):
            k1 = min(k0 + 64, lk)
            x = x_of(qh, k0, k1)
            dp = torch.matmul(doh, vh[:, :, k0:k1].transpose(-1, -2))
            mnew = torch.maximum(m, x.amax(-1))
            c, e = torch.exp(m - mnew), torch.exp(x - mnew[..., None])
            l, w, m = l * c + e.sum(-1), w * c + (e * dp).sum(-1), mnew
        r, delta = 1.0 / l, w / l
    group = f32_dq_parts(lk)[0]
    dq, dks, dvs, part = None, [], [], None
    for k0 in range(0, lk, 64):
        k1 = min(k0 + 64, lk)
        dk, dv = torch.zeros(b, h, k1 - k0, dh), torch.zeros(b, h, k1 - k0, dh)
        blk = torch.zeros(b, h, lq, dh)
        for q0 in range(0, lq, 32):
            q1 = min(q0 + 32, lq)
            rows = slice(q0, q1)
            p = torch.exp(x_of(qh[:, :, rows], k0, k1) - m[..., rows, None]) * r[..., rows, None]
            dp = torch.matmul(doh[:, :, rows], vh[:, :, k0:k1].transpose(-1, -2))
            ds = p * (dp - delta[..., rows, None]) * scale
            dv = dv + torch.matmul(p.transpose(-1, -2), doh[:, :, rows])
            dk = dk + torch.matmul(ds.transpose(-1, -2), qh[:, :, rows])
            blk[:, :, rows] = torch.matmul(ds, kh[:, :, k0:k1])
        first = (k0 // 64) % group == 0
        part = blk if first else part + blk
        if (k0 // 64) % group == group - 1 or k1 == lk:  # the group's partial is whole
            dq = part if dq is None else dq + part
        dks.append(dk)
        dvs.append(dv)
    return tuple(_merge_heads(t, q.dtype) for t in (dq, torch.cat(dks, 2), torch.cat(dvs, 2)))


def _check_bwd_width(q, num_heads: int) -> int:
    """The head dim of ``q`` [B, L, H*dh] that the backward kernels take;
    raises for any other width or no token."""
    b, l, d = q.shape
    dh = head_dim(d, num_heads)
    if not dh or l < 1:
        raise ValueError(
            f"attention backward kernel takes head dims {_DIMS} and at least 1 "
            f"token: q {tuple(q.shape)}, {num_heads} heads"
        )
    return dh


def f32_dq_parts(lk: int):
    """(key blocks a CTA walks, dQ partials written) by the fp32 attention
    backward's main kernel over ``lk`` keys: ceil(lk / 64) blocks of 64 in
    groups of ceil(blocks / F32_MAX_DQ_PARTS) consecutive ones, one partial
    [B*H, Lq, dh] per group, so that the workspace grows linearly in Lq
    (one group per block up to 704 keys; 9 partials of 3 blocks at 1600).
    csrc/attention_bwd_f32.cuh ab_f32_group / ab_f32_parts make the same
    split, and crog_attention_f32_dq_parts reports it."""
    blocks = -(-lk // F32_KEY_BLOCK)
    group = -(-blocks // F32_MAX_DQ_PARTS)
    return group, -(-blocks // group)


def bwd_path(l: int, bf16_casts: bool = False, dh: int = HEAD_KERNEL_DIM) -> str:
    """Which K1b kernel takes a head of ``l`` tokens and head dim ``dh``:
    "head" (one CTA per head, crog_attention_bwd_head) up to HEAD_MAX_LEN
    tokens of HEAD_KERNEL_DIM columns, else "rows_cols" (the two kernels of
    crog_attention_bwd: any longer head, and every other head dim -- the
    head kernel's warps tile 64 columns, and 256 tokens of dh 128 would not
    fit its shared memory); the decoder blocks' cast points exist only on
    the two-kernel path.  crog_attention_bwd_head_takes is the C mirror."""
    head = l <= HEAD_MAX_LEN and dh == HEAD_KERNEL_DIM and not bf16_casts
    return "head" if head else "rows_cols"


def attention_bwd(q, k, v, o, do, num_heads: int, bf16_casts: bool = False, mask_add=None,
                  lse=None):
    """K1b.  q, o, do [B, Lq, H*dh], k, v [B, Lk, H*dh] with dh one of
    HEAD_DIMS, all bf16 or all fp32 (contiguous) -> dq, dk, dv.

    On a CPU tensor this is ``attention_bwd_plain``; on a CUDA tensor it
    launches the build for q's dtype (``cuda_build.library_for``): the bf16
    kernel ``bwd_path`` names (csrc/attention_bwd.cu), or K1b-f32
    (csrc/attention_bwd_f32.cu, counted in ``attention_bwd.launches_f32``);
    or raises.  ``bf16_casts`` swaps in the decoder blocks' attention
    backward (``_mha_bwd``, twin ``mha_bwd_plain``): its cast points (P and
    dS rounded to bf16; nothing at fp32) and, at fp32, its statistics
    recomputed by a pre-pass with delta = rowsum(dP P), as K2b-f32 and
    K3b-f32 run it.  In bf16 that is the two-kernel path that K2b and K3b
    run, which alone of the bf16 kernels takes a key mask ``mask_add`` [B,
    Lk] f32 and Lk != Lq; only the checks of that path and of K1b's
    tolerance set it (chip_smoke.py, tests/test_torch_cuda_kernels.py).
    K1b-f32 reads the forward's logsumexp ``lse`` [B, H, Lq] (from
    ``fused_attention(..., with_lse=True)``) and takes a key mask and Lk !=
    Lq."""
    if q.device.type == "cpu":
        if bf16_casts:
            return mha_bwd_plain(q, k, v, do, num_heads, mask_add)
        return attention_bwd_plain(q, k, v, o, do, num_heads, lse, mask_add)
    name = cuda_build.library_for("attention_bwd", q.dtype)
    dh = _check_bwd_width(q, num_heads)
    _check_bwd_width(k, num_heads)
    b, lq, d = q.shape
    lk = k.shape[1]
    if q.dtype == torch.float32:
        if not bf16_casts and lse is None:
            raise ValueError("K1b-f32 reads the forward's logsumexp: pass lse from "
                             "fused_attention(..., with_lse=True)")
        return _attention_bwd_f32(name, q, k, v, o, do, num_heads, mask_add,
                                  None if bf16_casts else lse)
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
    if lq == lk and bwd_path(lq, bf16_casts, dh) == "head":
        rc = lib.crog_attention_bwd_head(*ptrs, b, num_heads, lq, dh, dh**-0.5, stream)
        cuda_build.check_launch(lib, rc, "crog_attention_bwd_head")
    else:
        stats = torch.empty(3, b * num_heads, lq, dtype=torch.float32, device=q.device)
        rc = lib.crog_attention_bwd(*ptrs, stats.data_ptr(),
                                    None if mask_add is None else mask_add.data_ptr(),
                                    b, num_heads, lq, lk, dh, dh**-0.5, int(bf16_casts),
                                    stream)
        cuda_build.check_launch(lib, rc, "crog_attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0
attention_bwd.launches_f32 = 0


def _attention_bwd_f32(name, q, k, v, o, do, num_heads: int, mask_add=None, lse=None):
    """crog_attention_f32_bwd, all fp32: with ``lse`` K1b-f32 (each row's
    delta = rowsum(do * o) beside the forward's logsumexp), without it the
    decoder blocks' attention backward (a pre-pass for each row's
    statistics, delta = rowsum(dP P); ``o`` unused); then the main kernel,
    one CTA per group of 64-key blocks (``f32_dq_parts``) writing a dQ
    partial each, and their sum in key-block order."""
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // num_heads
    for t, n in ((q, "q"), (do, "do")) + (((o, "o"),) if lse is not None else ()):
        cuda_build.require(t, n, torch.float32, (b, lq, d))
    for t, n in ((k, "k"), (v, "v")):
        cuda_build.require(t, n, torch.float32, (b, lk, d))
    if mask_add is not None:
        cuda_build.require(mask_add, "mask_add", torch.float32, (b, lk))
    if lse is not None:
        cuda_build.require(lse, "lse", torch.float32, (b, num_heads, lq))
    else:
        o = q  # not read
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(b * num_heads, 3, lq, dtype=torch.float32, device=q.device)
    dqpart = torch.empty(f32_dq_parts(lk)[1], b * num_heads, lq, dh,
                         dtype=torch.float32, device=q.device)
    lib = cuda_build.load(name)
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in (t.stride(0), t.stride(1))]
    rc = lib.crog_attention_f32_bwd(
        *(t.data_ptr() for t in (q, k, v)), None if lse is None else o.data_ptr(),
        do.data_ptr(), None if mask_add is None else mask_add.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *(t.data_ptr() for t in (dq, dk, dv, stats, dqpart)), b, num_heads, lq, lk, dh,
        *strides, dh**-0.5, cuda_build.stream_ptr(q.device))
    cuda_build.check_launch(lib, rc, "crog_attention_f32_bwd")
    attention_bwd.launches_f32 += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """K1 forward, K1b backward (``fused_self_attention``'s custom VJP).
    At fp32 the forward saves each row's logsumexp, which K1b-f32 reads as
    ``_bwd_kernel`` reads the Pallas forward's; the bf16 backward recomputes
    the row statistics from q and k."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        if q.dtype == torch.float32:
            o, lse = fused_attention(q, k, v, num_heads, with_lse=True)
        else:
            o, lse = fused_attention(q, k, v, num_heads), None
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, o, do.contiguous(), ctx.num_heads, lse=lse), None)


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
