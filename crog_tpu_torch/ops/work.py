"""The work of each hand-written kernel, counted from its shapes, and the
least time an H100 could take for it.

The forward wrappers (K1 ``attention.fused_attention``, K2/K3
``decoder_blocks.self_block_fwd`` / ``cross_block_fwd``, K4
``ffn.ffn_fwd``, K6 ``s2dconv.s2dconv_fwd``) ``note`` their work while a
``counting`` block is open, on the card and on the CPU alike; on the CPU
they run their plain twin under ``uncounted``, which hides the twin's own
aten ops from any open ``TorchDispatchMode`` (``FlopCounterMode``), so that
a count over a program is the same whichever implementation runs.  The
kernels launch through ctypes, where no dispatch mode sees them.
chip_smoke.py holds each kernel to ``bound`` of this work;
tools/torch_roofline.py adds it to the aten count of the CROG forward.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, f32
# products on the tensor cores (TF32's 495 TFLOP/s over the three TF32
# products of the 3xTF32 split, which keeps f32 accuracy), device memory
PEAK_BF16_FLOPS = 989e12
PEAK_F32_TC_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS,
          peak_bytes: float = PEAK_BYTES):
    """(ms, limiter): the least time for ``flops`` operations at ``peak``
    (the bf16 tensor-core rate unless the operands are f32) and ``nbytes``
    of device-memory traffic at ``peak_bytes``."""
    t_ops = flops / peak * 1e3
    t_mem = nbytes / peak_bytes * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# products of each kernel (2 flops a multiply-add), from its shapes: the
# rows of the attention matrices, the q/k/v and output projections of a
# decoder block, the FFN's two GEMMs; a backward counts the recompute and
# the gradient products.  d = heads * head dim.
def attention_flops(b: int, lq: int, lk: int, d: int) -> float:
    """K1: QK^T and PV."""
    return 4.0 * b * lq * lk * d


def attention_bwd_flops(b: int, l: int, d: int) -> float:
    """K1b: QK^T again, dV, dP, dQ, dK."""
    return 10.0 * b * l * l * d


def self_block_flops(b: int, l: int, d: int) -> float:
    """K2: q, k, v and out projections over B*L rows, self attention."""
    return 8.0 * b * l * d * d + 4.0 * b * l * l * d


def self_block_bwd_flops(b: int, l: int, d: int) -> float:
    return 16.0 * b * l * d * d + 10.0 * b * l * l * d


def cross_block_flops(b: int, l: int, t: int, d: int) -> float:
    """K3: q and out projections over B*L rows, k and v over B*T text rows,
    attention of L queries over T keys."""
    return 4.0 * b * l * d * d + 4.0 * b * t * d * d + 4.0 * b * l * t * d


def cross_block_bwd_flops(b: int, l: int, t: int, d: int) -> float:
    return 8.0 * b * l * d * d + 8.0 * b * t * d * d + 10.0 * b * l * t * d


def ffn_flops(m: int, d: int, f: int) -> float:
    """K4: Dense d->f and f->d over M rows."""
    return 4.0 * m * d * f


def ffn_bwd_flops(m: int, d: int, f: int) -> float:
    """K4b: the recompute, dhn and dx in the kernel; dW1, dW2 outside it."""
    return 10.0 * m * d * f


def s2dconv_flops(b: int, h: int, w: int, ci: int, co: int) -> float:
    """K6 (or K6b) over a 2x2-blocked [B, H, W, 4ci] tensor: the real taps
    of the 3x3 conv, 2*9*ci*co per original output pixel (4 per cell)."""
    return 2.0 * 9 * ci * co * 4 * b * h * w


def lincomb_inside(args, t):
    """[B, KT, HW] bool: the points (column, pixel) inside their column's
    sanitized box, the pixels p with x1 <= p_x < x2 and y1 <= p_y < y2
    (``box_inside_mask``), T columns per box."""
    protos, _, _, _, boxes = args
    ph, pw = protos.shape[1:3]
    x1, x2, y1, y2 = (v.repeat_interleave(t, 1)[..., None] for v in boxes.unbind(-1))
    p = torch.arange(ph * pw, device=boxes.device)
    px, py = (p % pw).float(), (p // pw).float()
    return (px >= x1) & (px < x2) & (py >= y1) & (py < y2)


def lincomb_work(args, t):
    """(flops, dense flops, fwd bytes, bwd bytes, inside share) of one K5 /
    K5b call.  The products the function needs are 2·C per point inside its
    column's box: outside, the loss takes the constant outside_t and the
    gradient is 0.  The dense count charges every point, 2·B·KT·HW·C.  K5b
    needs three products per point (the prediction, dcoef and dprotos); the
    elementwise work is not counted.  Bytes: each input read once and each
    output written once, and of the inputs only what this call's boxes
    need.  Of the prototypes, the pixels inside some box of their image.
    Of the GT, K5 reads each row a column names in full (its outside sum
    needs every pixel); K5b only a named row's pixels inside the union of
    the boxes of the columns that name it."""
    protos, coef, ds, idx, boxes = args
    b, _, _, c = protos.shape
    kt = coef.shape[1]
    tm, hw = ds.shape[1:]
    inside = lincomb_inside(args, t)
    rows = gt_inside = 0
    for i in range(b):
        named = torch.zeros(tm, hw, dtype=torch.int32, device=inside.device)
        named.index_add_(0, idx[i].long(), inside[i].int())
        rows += int(idx[i].unique().numel())
        gt_inside += int((named > 0).sum())
    px_inside = int(inside.any(1).sum())
    read = px_inside * c * 4 + nbytes(coef, idx, boxes)
    out = b * kt * 4  # the sums (K5) or their gradient g (K5b)
    share = float(inside.float().mean())
    return (2.0 * c * float(inside.sum()), 2.0 * b * kt * hw * c, read + rows * hw * 4 + out,
            read + gt_inside * 4 + out + nbytes(coef, protos), share)


# this thread's open counting() blocks, innermost last (dispatch modes are
# per thread too)
_local = threading.local()


def _open() -> List[List[Tuple[str, float, int]]]:
    if not hasattr(_local, "blocks"):
        _local.blocks = []
    return _local.blocks


def note(name: str, work_of) -> None:
    """Record one kernel call's (name, flops, bytes of its inputs and
    outputs), ``work_of()`` giving the last two, in this thread's innermost
    open ``counting`` block, if any."""
    blocks = _open()
    if blocks:
        blocks[-1].append((name, *work_of()))


@contextlib.contextmanager
def counting():
    """Yields the list that the kernel calls inside the block ``note``
    into."""
    calls: List[Tuple[str, float, int]] = []
    _open().append(calls)
    try:
        yield calls
    finally:
        _open().pop()


def uncounted():
    """Around a plain twin: inside a ``counting`` block, every dispatch mode
    (a FlopCounterMode, a byte counter) is lifted for the twin's aten ops;
    elsewhere nothing."""
    if not _open():
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()
