"""Counter-based dropout masks, shared by the kernels and their twins.

The TPU kernels draw their dropout masks from the TPU's own PRNG
(``pltpu.prng_random_bits``), which nothing else can reproduce.  The port's
kernels instead hash a key (the step seed) with the element's global
(row, column) index, so the mask of an element does not depend on how a
kernel tiles its work, a backward kernel regenerates the forward's mask
from the same seed, and this module computes the very same bits with torch
integer ops (int64 with ``& 0xFFFFFFFF``), so a kernel can be held against
its twin with dropout on.  ``mix32`` and ``dropout_keep`` in
csrc/common.cuh are the device side of ``_mix`` and ``dropout_keep`` here.

The hash is three rounds of a 32-bit integer mixer (multiplier 0x45D9F3B,
below 2^31, so every product of a 32-bit value fits in int64):

    bits(seed, row, col) = mix(mix(mix(seed) ^ row) ^ col)
    keep = bits >= floor(rate * 2^32)

Draws from the step's ``torch.Generator`` give the seeds (``draw_seed``);
nothing here touches the global RNG.
"""

from __future__ import annotations

import torch

from crog_tpu_torch.parallel.dist import rank, rank_seed, world

_MASK = 0xFFFFFFFF
_MUL = 0x45D9F3B


def _mix(x):
    """The 32-bit mixer on a Python int or an int64 tensor of values < 2^32."""
    x = (((x >> 16) ^ x) * _MUL) & _MASK
    x = (((x >> 16) ^ x) * _MUL) & _MASK
    return (x >> 16) ^ x


def threshold(rate: float) -> int:
    """The uint32 threshold below which an element is dropped."""
    return min(int(rate * 2**32), 2**32 - 1)


def dropout_bits(seed: int, rows: int, cols: int, device=None):
    """[rows, cols] int64 hash bits of elements (r, c)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return _mix(_mix(_mix(int(seed) & _MASK) ^ r) ^ c)


def dropout_keep(seed: int, rate: float, rows: int, cols: int, device=None):
    """[rows, cols] bool keep mask; all True when ``rate`` is 0."""
    if rate <= 0.0:
        return torch.ones(rows, cols, dtype=torch.bool, device=device)
    return dropout_bits(seed, rows, cols, device) >= threshold(rate)


def apply_dropout(x, seed: int, rate: float):
    """x * keep / (1 - rate) over a [..., C] tensor whose rows are counted in
    order, in x's dtype (the scale is applied in f32 and rounded once).
    Identity when ``rate`` is 0."""
    if rate <= 0.0:
        return x
    keep = dropout_keep(seed, rate, x.numel() // x.shape[-1], x.shape[-1], x.device)
    y = torch.where(keep.view(x.shape), x.float() * (1.0 / (1.0 - rate)), 0.0)
    return y.to(x.dtype)


def kernel_args(seed: int, rate: float):
    """(seed, uint32 threshold, keep scale) as the kernels take them;
    threshold 0 switches dropout off."""
    if rate <= 0.0:
        return 0, 0, 1.0
    return int(seed) & _MASK, threshold(rate), 1.0 / (1.0 - rate)


def draw_seed(generator: torch.Generator) -> int:
    """One kernel seed from the step's (CPU) generator: no device sync.
    Every rank's generator is seeded alike, so under a process group of
    world > 1 the draw is folded with the rank (``rank_seed``): ranks never
    share a mask."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    return seed if world() == 1 else rank_seed(seed, rank())
