"""K5/K5b: SSG's prototype-combination loss sums, forward and backward.

Counterpart of crog_tpu/ops/pallas_lincomb.py ``lincomb_task_sums`` (273)
and its custom VJP (``make_lincomb_sums``, 198).  Per image, selected anchor
j and task t (column j*T + t) it sums over the ph x pw prototype pixels

    loss(where(inside box_j, sigmoid(protos @ coef[j, t]), outside_t), gt)

with outside_t 1 for the cos task and 0 otherwise, the GT row
``sel_gt[j] + t*M`` of ``ds_flat``, and loss BCE (1e-7 log clip) or
smooth-L1.  ``lincomb_task_sums`` is an autograd function with gradients to
the coefficients and the prototypes only.  On a CUDA tensor its forward
launches csrc/lincomb.cu's K5 and its backward K5b (or raises); on a CPU
tensor both run the plain twins, ``lincomb_task_sums_plain`` and
``lincomb_bwd_plain``: the einsum -> sigmoid -> crop -> loss chain of
crog_tpu/models/ssg_loss.py:280-302 in f32, over the kernels' interface.

The kernels take the prototypes in the model's channels-last layout
[B, ph, pw, C] and read each column's GT row directly; nothing is padded,
so a column can never point at a GT row other than its own.  They work
only inside the boxes: the map is cut into regions (``region_plan``), each
region's block lists the anchors whose box reaches it and computes their
columns there (csrc/lincomb.cu:list_anchors), and a second pass adds each
column's region partials in region order (csrc/lincomb.cu:region_range);
K5 adds them to each GT row's full-map loss at outside_t.
"""

from __future__ import annotations

import torch

from crog_tpu_torch.ops import cuda_build
from crog_tpu_torch.ops.boxes import sanitize_boxes

KERNEL_C = 32  # prototypes per pixel
LOSS_KINDS = {"bce": 0, "smooth_l1": 1}


def _outside(kt: int, num_tasks: int, cos_idx: int, device):
    """outside_t of each column j*T + t: 1 for the cos task, else 0."""
    col = torch.arange(kt, device=device)
    if num_tasks > 1:
        return ((col % num_tasks) == cos_idx).float()
    return torch.zeros(kt, device=device)


def _points(protos, coef, ds, idx, boxes, num_tasks, cos_idx):
    """(s, inside, m, gt), each [B, KT, HW]: the sigmoid, the box mask, the
    cropped prediction and the gathered GT of every (column, pixel)."""
    b, ph, pw, c = protos.shape
    hw = ph * pw
    kt = coef.shape[1]
    dev = protos.device
    s = torch.sigmoid(torch.einsum("bnc,bpc->bnp", coef, protos.reshape(b, hw, c)))
    x1, x2, y1, y2 = boxes.repeat_interleave(num_tasks, dim=1).unbind(-1)
    p = torch.arange(hw, device=dev)
    px, py = (p % pw).float(), (p // pw).float()
    inside = ((px >= x1[..., None]) & (px < x2[..., None])
              & (py >= y1[..., None]) & (py < y2[..., None]))
    m = torch.where(inside, s, _outside(kt, num_tasks, cos_idx, dev)[:, None])
    gt = torch.gather(ds, 1, idx.long()[..., None].expand(b, kt, hw))
    return s, inside, m, gt


def _loss(m, gt, loss_kind):
    """BCE with a 1e-7 log clip, or smooth-L1, per point."""
    if loss_kind == "bce":
        return -(gt * torch.log(m.clamp_min(1e-7))
                 + (1.0 - gt) * torch.log((1.0 - m).clamp_min(1e-7)))
    d = (m - gt).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def lincomb_task_sums_plain(protos, coef, ds, idx, boxes, num_tasks: int,
                            cos_idx: int = 2, loss_kind: str = "smooth_l1"):
    """Plain twin of K5: sums [B, KT] over the kernels' interface (protos
    [B, ph, pw, C], coef [B, KT, C], ds [B, TM, HW], idx [B, KT], sanitized
    boxes [B, KT/T, 4] as x1, x2, y1, y2)."""
    _, _, m, gt = _points(protos, coef, ds, idx, boxes, num_tasks, cos_idx)
    return _loss(m, gt, loss_kind).sum(-1)


def lincomb_bwd_plain(protos, coef, ds, idx, boxes, g, num_tasks: int,
                      cos_idx: int = 2, loss_kind: str = "smooth_l1"):
    """Plain twin of K5b: (dcoef [B, KT, C], dprotos [B, ph, pw, C]) for the
    gradient ``g`` [B, KT] of the sums; the BCE gradient is 0 where its log
    clip saturates, as jnp.maximum's VJP is."""
    b, ph, pw, c = protos.shape
    s, inside, m, gt = _points(protos, coef, ds, idx, boxes, num_tasks, cos_idx)
    if loss_kind == "bce":
        up = torch.where(m > 1e-7, gt / m.clamp_min(1e-7), 0.0)
        dn = torch.where(1.0 - m > 1e-7, (1.0 - gt) / (1.0 - m).clamp_min(1e-7), 0.0)
        dldm = -(up - dn)
    else:
        dldm = (m - gt).clamp(-1.0, 1.0)
    dpred = torch.where(inside, g[..., None] * dldm, 0.0) * s * (1.0 - s)
    dcoef = torch.einsum("bnp,bpc->bnc", dpred, protos.reshape(b, ph * pw, c))
    dprotos = torch.einsum("bnp,bnc->bpc", dpred, coef).reshape(b, ph, pw, c)
    return dcoef, dprotos


# pixels of a region, about, timed on the boxes SSG's train step hands the
# kernels (tools/torch_lincomb_cases.py --pixels).  There an image's 100
# anchors share its few objects' boxes, so a block's time is the chain of
# anchors its region lists: K5 takes small regions (1360 blocks at batch 8,
# 136^2), which split the busy ones; K5b keeps 3 blocks per SM (75 KB of
# shared memory each) in one wave of 680 blocks, since its smaller regions
# cost more with large boxes than they gain with small ones
FWD_PIXELS, BWD_PIXELS = 112, 224


def region_plan(ph: int, pw: int, pixels: int = FWD_PIXELS):
    """(rh, rw): the kernels' regions of rh x rw pixels, a function of the
    map's shape alone.  Regions about 32 pixels wide and ``pixels`` in all:
    small enough that a box reaches few of them, large enough that a
    region's prototypes serve many columns.  The last row and column of
    regions may be cut by the map."""
    rw = -(-pw // -(-pw // 32))
    return max(1, min(ph, pixels // rw)), rw


def _regions(ph: int, pw: int, pixels: int) -> int:
    rh, rw = region_plan(ph, pw, pixels)
    return -(-ph // rh) * -(-pw // rw)


def _check(protos, coef, ds, idx, boxes, num_tasks):
    b, ph, pw, c = protos.shape
    kt = coef.shape[1]
    if c != KERNEL_C:
        raise ValueError(f"the lincomb kernels take {KERNEL_C} prototypes, got {c}")
    if kt % num_tasks:
        raise ValueError(f"{kt} columns is not a multiple of {num_tasks} tasks")
    f32 = torch.float32
    cuda_build.require(protos, "protos", f32, (b, ph, pw, c))
    cuda_build.require(coef, "coef", f32, (b, kt, c))
    cuda_build.require(ds, "ds", f32, (b, ds.shape[1], ph * pw), contiguous=True)
    cuda_build.require(idx, "idx", torch.int32, (b, kt))
    cuda_build.require(boxes, "boxes", f32, (b, kt // num_tasks, 4))
    return b, ph * pw, pw, kt, ds.shape[1]


def lincomb_fwd(protos, coef, ds, idx, boxes, num_tasks: int, cos_idx: int = 2,
                loss_kind: str = "smooth_l1"):
    """K5: sums [B, KT] (arguments as ``lincomb_task_sums_plain``)."""
    if protos.device.type == "cpu":
        return lincomb_task_sums_plain(protos, coef, ds, idx, boxes, num_tasks,
                                       cos_idx, loss_kind)
    b, hw, pw, kt, tm = _check(protos, coef, ds, idx, boxes, num_tasks)
    rh, rw = region_plan(hw // pw, pw, FWD_PIXELS)
    dev = protos.device
    rowsum = torch.empty(b, tm, 2, dtype=torch.float32, device=dev)
    part = torch.empty(b, _regions(hw // pw, pw, FWD_PIXELS), kt, dtype=torch.float32,
                       device=dev)
    sums = torch.empty(b, kt, dtype=torch.float32, device=dev)
    lib = cuda_build.load("lincomb")
    rc = lib.crog_lincomb_fwd(
        protos.data_ptr(), coef.data_ptr(), ds.data_ptr(), idx.data_ptr(),
        boxes.data_ptr(), rowsum.data_ptr(), part.data_ptr(), sums.data_ptr(), b, hw,
        pw, kt, tm, num_tasks, cos_idx, LOSS_KINDS[loss_kind], rh, rw,
        cuda_build.stream_ptr(dev),
    )
    cuda_build.check_launch(lib, rc, "crog_lincomb_fwd")
    lincomb_fwd.launches += 1
    return sums


lincomb_fwd.launches = 0


def lincomb_bwd(protos, coef, ds, idx, boxes, g, num_tasks: int, cos_idx: int = 2,
                loss_kind: str = "smooth_l1"):
    """K5b: (dcoef [B, KT, C], dprotos [B, ph, pw, C]) for the gradient
    ``g`` [B, KT] of the sums."""
    if protos.device.type == "cpu":
        return lincomb_bwd_plain(protos, coef, ds, idx, boxes, g, num_tasks,
                                 cos_idx, loss_kind)
    b, hw, pw, kt, tm = _check(protos, coef, ds, idx, boxes, num_tasks)
    g = g.float().contiguous()
    cuda_build.require(g, "g", torch.float32, (b, kt))
    rh, rw = region_plan(hw // pw, pw, BWD_PIXELS)
    dev = protos.device
    part = torch.empty(b, _regions(hw // pw, pw, BWD_PIXELS), kt, KERNEL_C, dtype=torch.float32,
                       device=dev)
    dcoef = torch.empty_like(coef)
    dprotos = torch.empty_like(protos)
    lib = cuda_build.load("lincomb")
    rc = lib.crog_lincomb_bwd(
        protos.data_ptr(), coef.data_ptr(), ds.data_ptr(), idx.data_ptr(),
        boxes.data_ptr(), g.data_ptr(), part.data_ptr(), dcoef.data_ptr(),
        dprotos.data_ptr(), b, hw, pw, kt, tm, num_tasks, cos_idx,
        LOSS_KINDS[loss_kind], rh, rw, cuda_build.stream_ptr(dev),
    )
    cuda_build.check_launch(lib, rc, "crog_lincomb_bwd")
    lincomb_bwd.launches += 1
    return dcoef, dprotos


lincomb_bwd.launches = 0


class _LincombSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, protos, coef, ds, idx, boxes, num_tasks, cos_idx, loss_kind):
        ctx.save_for_backward(protos, coef, ds, idx, boxes)
        ctx.args = (num_tasks, cos_idx, loss_kind)
        return lincomb_fwd(protos, coef, ds, idx, boxes, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        protos, coef, ds, idx, boxes = ctx.saved_tensors
        dcoef, dprotos = lincomb_bwd(protos, coef, ds, idx, boxes, g, *ctx.args)
        return dprotos, dcoef, None, None, None, None, None, None


def kernel_args(protos, sel_coef, ds_flat, sel_gt, sel_box, num_tasks: int):
    """(protos, coef, ds, idx, boxes) in the kernels' interface from the
    JAX package's arguments: coefficients as [B, KT, C] with column j*T + t,
    the GT row of each column, and the boxes sanitized as
    ``box_inside_mask`` does (padding 1)."""
    b, ph, pw, _ = protos.shape
    k, t = sel_coef.shape[1:3]
    m_slots = ds_flat.shape[1] // num_tasks
    t_ids = torch.arange(num_tasks, device=sel_gt.device)
    idx = (sel_gt[:, :, None] + t_ids * m_slots).reshape(b, k * t).to(torch.int32)
    x1, x2, y1, y2 = sanitize_boxes(sel_box.float(), ph, pw)
    boxes = torch.stack([x1, x2, y1, y2], dim=-1)
    return (protos.float().contiguous(), sel_coef.float().reshape(b, k * t, -1).contiguous(),
            ds_flat.float().contiguous(), idx.contiguous(), boxes.contiguous())


def lincomb_task_sums(protos, sel_coef, ds_flat, sel_gt, sel_box, num_tasks: int,
                      cos_idx: int = 2, loss_kind: str = "smooth_l1"):
    """Per-anchor, per-task pixel sums [B, k, T] of the lincomb loss.

    protos [B, ph, pw, C] f32; sel_coef [B, k, T, C] f32; ds_flat
    [B, T*M, ph*pw] f32 GT maps (row t*M + m); sel_gt [B, k] GT index per
    selected anchor; sel_box [B, k, 4] matched GT boxes (relative)."""
    b, k, t = sel_coef.shape[:3]
    if t != num_tasks:
        raise ValueError(f"sel_coef has {t} tasks, expected {num_tasks}")
    args = kernel_args(protos, sel_coef, ds_flat.detach(), sel_gt, sel_box.detach(),
                       num_tasks)
    sums = _LincombSums.apply(*args, num_tasks, cos_idx, loss_kind)
    return sums.reshape(b, k, t)
