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

Cast points, as in the JAX package: the operands in the model's compute
dtype (bf16, or fp32 under ``compute_dtype: float32``), f32 sums, the
output in x's dtype; the weight gradient stays f32 until it is folded and
cast to w's dtype.  On a CUDA tensor the forward and the dgrad launch K6,
the wgrad K6b, from the build for x's dtype (``cuda_build.library_for``):
bf16 csrc/s2dconv.cu (``crog_s2dconv_fwd``, ``crog_s2dconv_wgrad``) or fp32
csrc/s2dconv_f32.cu (``crog_s2dconv_f32_fwd``, ``crog_s2dconv_f32_wgrad``,
3xTF32 products, counted in ``launches_f32``), or raise; on a CPU tensor
they run the plain twins ``conv_padded_plain`` and ``wgrad_plain``.  The TPU
kernel's VMEM split planner and its fallback to the XLA conv follow from
the TPU's memory and are not carried over (at 416^2 the fp32 stem takes
that fallback on a TPU, which computes the same function): on the card a
shape the kernels do not take (ci, co not in {32, 64}, activations neither
bf16 nor fp32, operands of mixed dtypes) raises before any launch.
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
# K6b-f32: the CTAs its cell chunks aim at, one on each of an H100's 132 SMs
# (csrc/gemm_wgmma_f32.cuh's kernel takes one SM's shared memory)
WGRAD_F32_CTAS = 132


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
    y = torch.matmul(p.float(), wp.float())
    return y.reshape(b, h, w, 4 * co).to(x.dtype)


def wgrad_plain(x: torch.Tensor, dy: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """Plain twin of K6b: the packed weight gradient [16ci, 4co] in f32."""
    p = gather_patch(x, ci).reshape(-1, 16 * ci)
    return torch.matmul(p.float().t(), dy.reshape(-1, 4 * co).float())


def _check(x: torch.Tensor, ci: int, co: int, name: str):
    if ci not in KERNEL_WIDTHS or co not in KERNEL_WIDTHS:
        raise ValueError(f"the s2d conv kernels take ci, co in {KERNEL_WIDTHS}, "
                         f"got {ci}, {co}")
    if x.dim() != 4 or x.shape[-1] != 4 * ci:
        raise ValueError(f"{name}: expected [B, H, W, {4 * ci}], got {tuple(x.shape)}")
    cuda_build.require(x, name, x.dtype)
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


def wgrad_f32_schedule(b: int, h: int, w: int, ci: int, co: int):
    """(chunks, cells per chunk) of K6b-f32: each [128, 128] block of the
    packed gradient takes one CTA per chunk of cells, as many chunks as
    bring the CTAs to WGRAD_F32_CTAS (one wave of CTAs), each a multiple of
    32 cells (the GEMM's K slice) and none empty; each chunk writes one
    partial, added in chunk order.  A function of the shapes alone, so the
    order of the sums is too."""
    cells = b * h * w
    blocks = (16 * ci // 128) * (4 * co // 128)
    want = max(1, min(-(-cells // 32), WGRAD_F32_CTAS // blocks))
    chunk = (-(-cells // want) + 31) // 32 * 32
    return -(-cells // chunk), chunk


def fwd_f32_planes(ci: int, co: int) -> int:
    """Floats of K6-f32's workspace: the packed weight's TF32 hi and lo
    planes, each [4co, 16ci] (K-major, as the GEMM reads B)."""
    return 2 * 4 * co * 16 * ci


def fwd_f32_slot_rows(co: int, n0: int):
    """[t_lo, t_hi): the slot-rows t of the packed weight that K6-f32's
    128-column tile at output column n0 multiplies (csrc/s2dconv_f32.cu
    ``S2dPatch::k_range``).  Block (t, s) x (dy', dx') of ``pack_s1``'s
    layout is a structural zero unless t - dy' lies in 0..2, and the tile's
    columns n hold dy' = n // (2co): at co 64 one dy' a tile, so a quarter
    of the slices are skipped; at co 32 none."""
    dlo, dhi = n0 // (2 * co), (n0 + 127) // (2 * co)
    return dlo, min(4, dhi + 3)


def wgrad_f32_planes(b: int, h: int, w: int, co: int) -> int:
    """Floats of K6b-f32's workspace: dy's TF32 hi and lo planes, each [4co,
    cells] with its rows rounded up to 4 floats (16 bytes, for TMA)."""
    return 2 * 4 * co * (-(-b * h * w // 4) * 4)


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
    [16ci, 4co] (``pack_s1``'s layout) -> [B, H, W, 4co] in x's dtype (the
    forward, and the dgrad with the flipped, swapped kernel); fp32 x goes
    to K6-f32 (csrc/s2dconv_f32.cu, counted in ``s2dconv_fwd.launches_f32``;
    it skips wp's structural-zero blocks where a tile's columns allow, and
    splits wp into a workspace of ``fwd_f32_planes`` floats)."""
    work.note("s2dconv", lambda: (
        work.s2dconv_flops(*x.shape[:3], ci, co),
        work.nbytes(x, wp) + x.numel() // ci * co * x.element_size()))
    if x.device.type == "cpu":
        with work.uncounted():
            return conv_padded_plain(x, wp, ci, co)
    name = cuda_build.library_for("s2dconv", x.dtype)
    b, h, w = _check(x, ci, co, "x")
    cuda_build.require(wp, "wp", x.dtype, (16 * ci, 4 * co))
    y = torch.empty(b, h, w, 4 * co, dtype=x.dtype, device=x.device)
    lib = cuda_build.load(name)
    stream = cuda_build.stream_ptr(x.device)
    if x.dtype == torch.float32:
        planes = torch.empty(fwd_f32_planes(ci, co), dtype=torch.float32, device=x.device)
        rc = lib.crog_s2dconv_f32_fwd(x.data_ptr(), wp.data_ptr(), planes.data_ptr(),
                                      y.data_ptr(), b, h, w, ci, co, stream)
        cuda_build.check_launch(lib, rc, "crog_s2dconv_f32_fwd")
        s2dconv_fwd.launches_f32 += 1
        return y
    ctas, per = fwd_schedule(b, h, w, ci, co)
    rc = lib.crog_s2dconv_fwd(x.data_ptr(), wp.data_ptr(), y.data_ptr(), b, h, w, ci,
                              co, ctas, per, stream)
    cuda_build.check_launch(lib, rc, "crog_s2dconv_fwd")
    s2dconv_fwd.launches += 1
    return y


s2dconv_fwd.launches = 0
s2dconv_fwd.launches_f32 = 0


def s2dconv_wgrad(x: torch.Tensor, dy: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """K6b: the packed weight gradient [16ci, 4co] f32 of the blocked conv
    from its input x [B, H, W, 4ci] and output gradient dy [B, H, W, 4co];
    fp32 operands go to K6b-f32 (csrc/s2dconv_f32.cu, counted in
    ``s2dconv_wgrad.launches_f32``; dy split into a workspace of
    ``wgrad_f32_planes`` floats, 532 MB at conv3 of the main path)."""
    if x.device.type == "cpu":
        return wgrad_plain(x, dy, ci, co)
    name = cuda_build.library_for("s2dconv_wgrad", x.dtype)
    b, h, w = _check(x, ci, co, "x")
    cuda_build.require(dy, "dy", x.dtype, (b, h, w, 4 * co))
    dev = x.device
    f32 = x.dtype == torch.float32
    parts, per = (wgrad_f32_schedule if f32 else wgrad_schedule)(b, h, w, ci, co)
    part = torch.empty(parts, 16 * ci, 4 * co, dtype=torch.float32, device=dev)
    dwp = torch.empty(16 * ci, 4 * co, dtype=torch.float32, device=dev)
    lib = cuda_build.load(name)
    stream = cuda_build.stream_ptr(dev)
    if f32:
        planes = torch.empty(wgrad_f32_planes(b, h, w, co), dtype=torch.float32, device=dev)
        rc = lib.crog_s2dconv_f32_wgrad(x.data_ptr(), dy.data_ptr(), planes.data_ptr(),
                                        part.data_ptr(), dwp.data_ptr(), b, h, w, ci, co,
                                        parts, per, stream)
        cuda_build.check_launch(lib, rc, "crog_s2dconv_f32_wgrad")
        s2dconv_wgrad.launches_f32 += 1
        return dwp
    rc = lib.crog_s2dconv_wgrad(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dwp.data_ptr(), b,
                                h, w, ci, co, parts, per, stream)
    cuda_build.check_launch(lib, rc, "crog_s2dconv_wgrad")
    s2dconv_wgrad.launches += 1
    return dwp


s2dconv_wgrad.launches = 0
s2dconv_wgrad.launches_f32 = 0


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
