"""Space-to-depth helpers for the CLIP stem.

Counterpart of crog_tpu/ops/s2d.py: ``space_to_depth`` (34),
``depth_to_space`` (42), ``block_kernel_s2`` (58), ``block_kernel_s1`` (80)
and ``block_mean`` (101), over NHWC torch tensors and [3,3,ci,co] (HWIO)
kernels, as in the JAX package.

The stem's stride-1 3x3 convs run on 2x2-blocked tensors: slot
``(dy*2+dx)*C + c`` of cell (i, j) holds original pixel (2i+dy, 2j+dx),
channel c.  Each original conv becomes one conv on blocked tensors whose
kernel is a zero-embedded rearrangement of the original weights: output slot
dy' at cell i reads original rows 2i+dy'+u, u in {-1, 0, 1}, and original
row 2m+dy lands there iff u = 2(a-1)+dy-dy' with cell tap a = m-i+1, so each
output slot takes exactly 9 nonzero [ci, co] blocks.  The stride-2 conv1
under 4x4 input blocking takes 2x2 cell taps with u = ry+4(a-1)-2dy'.  The
kernels are assembled from the original parameters with ``torch.cat``, so
gradients flow back to them.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC -> (B, H/k, W/k, k*k*C), slot index (dy*k+dx)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // k, w // k, k * k * c)


def depth_to_space(x: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``space_to_depth``."""
    b, h, w, kkc = x.shape
    c = kkc // (k * k)
    x = x.reshape(b, h, w, k, k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * k, w * k, c)


def assemble(blocks, ci: int, co: int, like: torch.Tensor) -> torch.Tensor:
    """[R][C] grid of [ci, co] blocks (None for zeros) -> [R*ci, C*co]."""
    zero = like.new_zeros(ci, co)
    rows = [torch.cat([zero if blk is None else blk for blk in row], dim=1)
            for row in blocks]
    return torch.cat(rows, dim=0)


def block_kernel_s2(w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 kernel [3,3,ci,co] -> blocked [2,2,16ci,4co] for a
    4x4-blocked input and a 2x2-blocked output; apply with stride 1 and
    padding ((1,0),(1,0))."""
    ci, co = w.shape[2], w.shape[3]
    taps = []
    for a in range(2):
        row = []
        for bb in range(2):
            grid = []
            for ry in range(4):
                for rx in range(4):
                    slots = []
                    for dy in range(2):
                        for dx in range(2):
                            u = ry + 4 * (a - 1) - 2 * dy
                            v = rx + 4 * (bb - 1) - 2 * dx
                            ok = abs(u) <= 1 and abs(v) <= 1
                            slots.append(w[u + 1, v + 1] if ok else None)
                    grid.append(slots)
            row.append(assemble(grid, ci, co, w))
        taps.append(torch.stack(row))
    return torch.stack(taps)


def block_kernel_s1(w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 kernel [3,3,ci,co] -> blocked [3,3,4ci,4co] for
    2x2-blocked input and output; apply with stride 1, padding 1."""
    ci, co = w.shape[2], w.shape[3]
    taps = []
    for a in range(3):
        row = []
        for bb in range(3):
            grid = []
            for dy in range(2):
                for dx in range(2):
                    slots = []
                    for dyo in range(2):
                        for dxo in range(2):
                            u = 2 * (a - 1) + dy - dyo
                            v = 2 * (bb - 1) + dx - dxo
                            ok = abs(u) <= 1 and abs(v) <= 1
                            slots.append(w[u + 1, v + 1] if ok else None)
                    grid.append(slots)
            row.append(assemble(grid, ci, co, w))
        taps.append(torch.stack(row))
    return torch.stack(taps)


def block_mean(x: torch.Tensor, c: int) -> torch.Tensor:
    """avg_pool(2) of the un-blocked tensor == mean over the 4 block slots
    of the 2x2-blocked tensor: (B,h,w,4c) -> (B,h,w,c), summed in the JAX
    package's order."""
    return (x[..., 0 * c:1 * c] + x[..., 1 * c:2 * c] + x[..., 2 * c:3 * c]
            + x[..., 3 * c:4 * c]) * 0.25
