"""K6/K6b: the gathered blocked 3x3 convolution of the space-to-depth stem.

Counterpart of crog_tpu/ops/pallas_s2dconv.py: ``pack_s1`` (115),
``unpack_s1`` (132), ``_conv_padded`` (296, the forward and the dgrad),
``_wgrad`` (359) and the custom VJP of ``blocked_conv3x3_s1`` (394-450).

``blocked_conv3x3_s1(x, w)`` is a 3x3 stride-1 pad-1 conv of the 2x2-blocked
tensor x [B, H, W, 4ci] with the original kernel w [3, 3, ci, co]: the same
function as ``F.conv2d`` of x with ``s2d.block_kernel_s1(w)``, with the
blocked kernel's structural zeros gathered away.  For output cell (i, j) the
four output slots read original rows 2i-1..2i+2 and columns 2j-1..2j+2, a
4x4 window: 16 (slot-row t, slot-col s) blocks of ci channels from the 3x3
cell neighbourhood, with

    cell offset  OFS[t] = (t >> 1) + (t & 1)   in the 1-padded input
    block slot   DY[t]  = (t + 1) & 1
    W_packed[(t*4+s)*ci + c, (dy'*2+dx')*co + o] = w[t - dy', s - dx', c, o]

(zero unless both kernel indices fall in 0..2).  The [B*H*W, 16ci] gathered
patch times the packed [16ci, 4co] weight is the conv.  Its backward: the
dgrad is the same op with the flipped, ci/co-swapped kernel, and the wgrad
is patch^T @ dy in the packed layout, folded back to [3, 3, ci, co] by
``unpack_s1``.

Cast points, as in the JAX package: bf16 operands, f32 sums, the output in
x's dtype; the weight gradient stays f32 until it is folded and cast to w's
dtype.  On a CUDA tensor the forward and the dgrad launch csrc/s2dconv.cu's
K6 (``crog_s2dconv_fwd``) and the wgrad K6b (``crog_s2dconv_wgrad``), or
raise; on a CPU tensor they run the plain twins ``conv_padded_plain`` and
``wgrad_plain``.  The TPU kernel's VMEM split planner and its fallback to
the XLA conv follow from the TPU's memory and are not carried over: on the
card a shape the kernels do not take (ci, co not in {32, 64}, activations
not bf16) raises before any launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crog_tpu_torch.ops import cuda_build, work
from crog_tpu_torch.ops.s2d import assemble

OFS = (0, 1, 1, 2)  # padded-input cell offset of slot-row t
DY = (1, 0, 1, 0)  # block slot (dy or dx) of slot-row t
KERNEL_WIDTHS = (32, 64)  # ci and co the kernels take
TILE_CELLS = (8, 16)  # the kernels' cell tile (rows, columns)
# K6b: the SMs its clusters take, one CTA each.  An H100 has 132, but its
# GPCs hold at most 30 clusters of 4 and 15 of 8 at once
# (cudaOccupancyMaxActiveClusters), so 120 keeps every cluster in one wave.
CLUSTER_SMS = 120
MAX_CLUSTER = 8  # K6b: CTAs per cluster, at most the portable size
# K6: its persistent CTAs, one per SM of an H100 (132); a card with fewer
# SMs runs the rest as a second wave, with the same sums
FWD_SMS = 132


def pack_s1(w: torch.Tensor) -> torch.Tensor:
    """[3,3,ci,co] -> gathered-patch weight [16ci, 4co] (56% dense)."""
    ci, co = w.shape[2], w.shape[3]
    grid = []
    for t in range(4):
        for s in range(4):
            row = []
            for dy in range(2):
                for dx in range(2):
                    a, b = t - dy, s - dx
                    row.append(w[a, b] if 0 <= a <= 2 and 0 <= b <= 2 else None)
            grid.append(row)
    return assemble(grid, ci, co, w)


def unpack_s1(dwp: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """Adjoint of ``pack_s1``: packed grad [16ci, 4co] -> [3,3,ci,co], each
    tap the sum of its four packed blocks in (dy, dx) order."""
    rows = []
    for a in range(3):
        cols = []
        for b in range(3):
            blk = 0
            for dy in range(2):
                for dx in range(2):
                    t, s = a + dy, b + dx
                    blk = blk + dwp[(t * 4 + s) * ci:(t * 4 + s + 1) * ci,
                                    (dy * 2 + dx) * co:(dy * 2 + dx + 1) * co]
            cols.append(blk)
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def gather_patch(x: torch.Tensor, ci: int) -> torch.Tensor:
    """[B, H, W, 4ci] -> the gathered patch [B, H, W, 16ci], block (t, s)
    at channels (t*4+s)*ci, read from the 1-cell zero-padded input."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    parts = []
    for t in range(4):
        for s in range(4):
            slot = DY[t] * 2 + DY[s]
            parts.append(xp[:, OFS[t]:OFS[t] + h, OFS[s]:OFS[s] + w,
                            slot * ci:(slot + 1) * ci])
    return torch.cat(parts, dim=-1)


def conv_padded_plain(x: torch.Tensor, wp: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """Plain twin of K6: y [B, H, W, 4co] in x's dtype, f32 sums."""
    b, h, w, _ = x.shape
    p = gather_patch(x, ci).reshape(-1, 16 * ci)
    y = p.float() @ wp.float()
    return y.reshape(b, h, w, 4 * co).to(x.dtype)


def wgrad_plain(x: torch.Tensor, dy: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """Plain twin of K6b: the packed weight gradient [16ci, 4co] in f32."""
    p = gather_patch(x, ci).reshape(-1, 16 * ci)
    return p.float().t() @ dy.reshape(-1, 4 * co).float()


def _check(x: torch.Tensor, ci: int, co: int, name: str):
    if ci not in KERNEL_WIDTHS or co not in KERNEL_WIDTHS:
        raise ValueError(f"the s2d conv kernels take ci, co in {KERNEL_WIDTHS}, "
                         f"got {ci}, {co}")
    if x.dim() != 4 or x.shape[-1] != 4 * ci:
        raise ValueError(f"{name}: expected [B, H, W, {4 * ci}], got {tuple(x.shape)}")
    cuda_build.require(x, name, torch.bfloat16)
    return x.shape[:3]


def wgrad_cluster(ci: int, co: int):
    """(CTAs per cluster, column groups) of K6b: a CTA per [128, 128] block
    of the packed [16ci, 4co] gradient; a cluster takes every row block and
    as many column blocks as MAX_CLUSTER allows, and the remaining column
    blocks take clusters of their own."""
    kb, nb = 16 * ci // 128, 4 * co // 128
    nbc = min(nb, MAX_CLUSTER // kb)
    return kb * nbc, nb // nbc


def wgrad_schedule(b: int, h: int, w: int, ci: int, co: int):
    """(clusters, tiles per cluster) of K6b: cluster g sums the 8 x 16 cell
    tiles [g * per, (g + 1) * per), none empty, with as many clusters as
    CLUSTER_SMS hold at one CTA per SM; each writes one partial, added in
    index order.  A function of the shapes alone, so the order of the sums
    is too."""
    tr, tw = TILE_CELLS
    tiles = b * -(-h // tr) * -(-w // tw)
    size, groups = wgrad_cluster(ci, co)
    per = -(-tiles // max(1, min(tiles, CLUSTER_SMS // (size * groups))))
    return -(-tiles // per), per


def fwd_cols(ci: int) -> int:
    """Output columns of K6's resident 128 KB weight slice: [16ci, 128] at
    ci 32, [16ci, 64] at ci 64."""
    return 128 if ci == 32 else 64


def fwd_schedule(b: int, h: int, w: int, ci: int, co: int):
    """(CTAs, tiles per range) of K6: the 8 x 16 cell tiles in contiguous
    ranges [g * per, (g + 1) * per), none empty, each taken by one CTA per
    column slice (CTA i: range i // nh, slice i % nh, nh = 4co / fwd_cols),
    with as many CTAs as FWD_SMS.  A function of the shapes alone."""
    tr, tw = TILE_CELLS
    tiles = b * -(-h // tr) * -(-w // tw)
    nh = 4 * co // fwd_cols(ci)
    per = -(-tiles // max(1, min(tiles, FWD_SMS // nh)))
    return -(-tiles // per) * nh, per


def s2dconv_fwd(x: torch.Tensor, wp: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """K6: blocked conv of x [B, H, W, 4ci] with the packed weight wp
    [16ci, 4co] -> [B, H, W, 4co] (the forward, and the dgrad with the
    flipped, swapped kernel)."""
    work.note("s2dconv", lambda: (
        work.s2dconv_flops(*x.shape[:3], ci, co),
        work.nbytes(x, wp) + x.numel() // ci * co * x.element_size()))
    if x.device.type == "cpu":
        with work.uncounted():
            return conv_padded_plain(x, wp, ci, co)
    b, h, w = _check(x, ci, co, "x")
    cuda_build.require(wp, "wp", torch.bfloat16, (16 * ci, 4 * co))
    y = torch.empty(b, h, w, 4 * co, dtype=torch.bfloat16, device=x.device)
    ctas, per = fwd_schedule(b, h, w, ci, co)
    lib = cuda_build.load("s2dconv")
    rc = lib.crog_s2dconv_fwd(x.data_ptr(), wp.data_ptr(), y.data_ptr(), b, h, w, ci,
                              co, ctas, per, cuda_build.stream_ptr(x.device))
    cuda_build.check_launch(lib, rc, "crog_s2dconv_fwd")
    s2dconv_fwd.launches += 1
    return y


s2dconv_fwd.launches = 0


def s2dconv_wgrad(x: torch.Tensor, dy: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """K6b: the packed weight gradient [16ci, 4co] f32 of the blocked conv
    from its input x [B, H, W, 4ci] and output gradient dy [B, H, W, 4co]."""
    if x.device.type == "cpu":
        return wgrad_plain(x, dy, ci, co)
    b, h, w = _check(x, ci, co, "x")
    cuda_build.require(dy, "dy", torch.bfloat16, (b, h, w, 4 * co))
    clusters, per = wgrad_schedule(b, h, w, ci, co)
    dev = x.device
    part = torch.empty(clusters, 16 * ci, 4 * co, dtype=torch.float32, device=dev)
    dwp = torch.empty(16 * ci, 4 * co, dtype=torch.float32, device=dev)
    lib = cuda_build.load("s2dconv")
    rc = lib.crog_s2dconv_wgrad(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                                dwp.data_ptr(), b, h, w, ci, co, clusters, per,
                                cuda_build.stream_ptr(dev))
    cuda_build.check_launch(lib, rc, "crog_s2dconv_wgrad")
    s2dconv_wgrad.launches += 1
    return dwp


s2dconv_wgrad.launches = 0


class _BlockedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ci, co = w.shape[2], w.shape[3]
        ctx.save_for_backward(x, w)
        return s2dconv_fwd(x, pack_s1(w).to(x.dtype).contiguous(), ci, co)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ci, co = w.shape[2], w.shape[3]
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)
            dx = s2dconv_fwd(dy, pack_s1(wt).to(dy.dtype).contiguous(), co, ci)
        if ctx.needs_input_grad[1]:
            dw = unpack_s1(s2dconv_wgrad(x, dy, ci, co), ci, co).to(w.dtype)
        return dx, dw


def blocked_conv3x3_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 conv of the 2x2-blocked x [B, H, W, 4ci] with the
    original kernel w [3, 3, ci, co] (f32) -> [B, H, W, 4co] in x's dtype."""
    return _BlockedConv.apply(x.contiguous(), w)
