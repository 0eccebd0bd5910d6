"""SSG training losses.

Counterpart of crog_tpu/models/ssg_loss.py: ``smooth_l1_sum`` (31),
``category_loss`` (36), ``box_loss`` (67), ``_select_positives`` (74),
``lincomb_mask_loss`` (88), ``lincomb_grasp_masks_loss`` (206),
``semantic_seg_loss`` (312) and ``ssg_losses`` (345): the 8-term loss over
the padded ground-truth layout of ``data/ocid_grasp.py:collate_ssg``
(boxes [B, M, 4], labels and obj_valid [B, M], instance and grasp maps
[B, M, S, S]), for a whole batch at once.

Both prototype-combination losses go through ``ops/lincomb.py`` (K5 and K5b
on the card, their plain twins on the CPU): one path, the same function as
the JAX package's einsum path and its Pallas kernel.  The positives each
image trains (``masks_to_train``) are the top-k of a priority array that
``ssg_losses`` draws from the step's ``torch.Generator`` (or takes as
``priority``); hard negatives are ranked with stable sorts, as
``jnp.argsort`` ranks them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from crog_tpu_torch.ops.boxes import match
from crog_tpu_torch.ops.lincomb import lincomb_task_sums
from crog_tpu_torch.ops.resize import downsample_masks
from crog_tpu_torch.parallel import dist

GRASP_KEYS = ("qua", "sin", "cos", "wid")


def smooth_l1_sum(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _norm(pos, norm):
    return pos.sum().clamp_min(1) if norm is None else norm


def category_loss(class_logits, conf_gt, pos, np_ratio: int = 3, norm=None):
    """Softmax CE with 3:1 hard-negative mining.  class_logits [B, N, C];
    conf_gt [B, N] (-1 neutral, 0 background, > 0 class); pos [B, N].
    ``norm``: the divisor, by default the batch's positive count (at least
    1); the same holds for the losses below."""
    _, n, c = class_logits.shape
    logits = class_logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # OHEM score, 0 for positives and neutrals
    mark = torch.where(pos | (conf_gt < 0), 0.0, lse - logits[..., 0]).detach()
    order = torch.argsort(-mark, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    num_pos = pos.sum(1, keepdim=True)
    num_neg = (np_ratio * num_pos).clamp_max(n - 1)
    neg = (ranks < num_neg) & ~pos & (conf_gt >= 0)
    labels = conf_gt.clamp(0, c - 1).long()
    ce = lse - torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = torch.where(pos | neg, ce, 0.0).sum()
    return loss / _norm(pos, norm)


def box_loss(box_pred, offsets, pos, norm=None):
    """Smooth-L1 on the positive anchors."""
    per = smooth_l1_sum(box_pred, offsets).sum(-1)
    return torch.where(pos, per, 0.0).sum() / _norm(pos, norm)


def _select_positives(pos, priority, k: int):
    """Up to k positive anchors per image, the k of highest ``priority``
    [B, N] (uniform in [0, 1)).  Returns (idx [B, k], sel_valid [B, k],
    old_num_pos [B], num_pos [B])."""
    score = torch.where(pos, priority, -1.0)
    # a stable descending sort: equal scores in index order, as lax.top_k
    top_vals, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    sel_valid = top_vals >= 0.0
    return top_idx, sel_valid, pos.sum(1), sel_valid.sum(1)


def draw_priority(shape, generator: Optional[torch.Generator] = None):
    """The positives' priorities of one step, uniform in [0, 1), drawn on
    the host (the JAX package draws ``jax.random.uniform``)."""
    return torch.rand(shape, generator=generator)


def _gather_rows(x, idx):
    """x [B, N, ...] at idx [B, k] -> [B, k, ...]."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape))


def _per_anchor_scale(sums, sel_box, sel_valid, old_num_pos, num_pos):
    """Per-anchor sums / box area, masked to the selected positives, scaled
    up where masks_to_train dropped positives; summed over anchors."""
    area = (sel_box[..., 2] - sel_box[..., 0]) * (sel_box[..., 3] - sel_box[..., 1])
    if sums.dim() == 3:
        area, sel_valid = area[..., None], sel_valid[..., None]
    per = torch.where(sel_valid, sums / area.clamp_min(1e-6), 0.0)
    scale = torch.where(old_num_pos > num_pos,
                        old_num_pos / num_pos.clamp_min(1), 1.0)
    return per.sum(1) * (scale[:, None] if sums.dim() == 3 else scale)


def lincomb_mask_loss(ins_coef, protos, ins_masks_gt, pos, anchor_max_i, anchor_max_gt,
                      sel_idx, sel_valid, old_num_pos, num_pos, ins_ds=None, norm=None):
    """Instance-mask loss: sigmoid(protos @ coef) cropped to the matched GT
    box, BCE against the GT mask at prototype resolution, normalized by box
    area.  ``ins_ds`` [B, M, ph, pw]: the GT already downsampled and
    binarized (then ``ins_masks_gt`` may be None)."""
    b = ins_coef.shape[0]
    ph, pw = protos.shape[1:3]
    ds = ins_ds if ins_ds is not None else downsample_masks(ins_masks_gt, (ph, pw))
    sel_coef = _gather_rows(ins_coef, sel_idx).float()[:, :, None, :]  # [B, k, 1, C]
    sel_gt = torch.gather(anchor_max_i, 1, sel_idx)
    sel_box = _gather_rows(anchor_max_gt, sel_idx)
    sums = lincomb_task_sums(protos, sel_coef, ds.reshape(b, ds.shape[1], ph * pw),
                             sel_gt, sel_box, num_tasks=1, loss_kind="bce")[..., 0]
    losses = _per_anchor_scale(sums, sel_box, sel_valid, old_num_pos, num_pos)
    return losses.sum() / ph / pw / _norm(pos, norm)


def lincomb_grasp_masks_loss(grasp_coef, protos, grasp_masks_gt, pos, anchor_max_i,
                             anchor_max_gt, sel_idx, sel_valid, old_num_pos, num_pos,
                             grasp_ds=None, norm=None):
    """Grasp-map loss: smooth-L1 of sigmoid(protos @ coef) against the GT
    maps at prototype resolution; the cos map is 1 outside the box, the
    others 0.  ``grasp_ds`` [B, 4, M, ph, pw]: the GT maps already
    downsampled (then ``grasp_masks_gt`` may be None).  Returns
    {qua, sin, cos, wid}."""
    b = grasp_coef.shape[0]
    ph, pw = protos.shape[1:3]
    if grasp_ds is None:
        grasp_ds = torch.stack([downsample_masks(grasp_masks_gt[k], (ph, pw), False)
                                for k in GRASP_KEYS], dim=1)
    sel_coef = _gather_rows(grasp_coef, sel_idx).float()  # [B, k, 4, C]
    sel_gt = torch.gather(anchor_max_i, 1, sel_idx)
    sel_box = _gather_rows(anchor_max_gt, sel_idx)
    sums = lincomb_task_sums(protos, sel_coef,
                             grasp_ds.reshape(b, 4 * grasp_ds.shape[2], ph * pw),
                             sel_gt, sel_box, num_tasks=4)  # [B, k, 4]
    losses = _per_anchor_scale(sums, sel_box, sel_valid, old_num_pos, num_pos)
    per_task = losses.sum(0) / ph / pw / _norm(pos, norm)
    return {k: per_task[i] for i, k in enumerate(GRASP_KEYS)}


def semantic_seg_loss(seg_pred, sem_masks_gt, labels, obj_valid, sem_ds=None):
    """Per-class BCE against the max over each class's instance masks.
    ``sem_ds`` [B, M, h, w]: the masks already downsampled and binarized."""
    b, h, w, c = seg_pred.shape
    ds = sem_ds if sem_ds is not None else downsample_masks(sem_masks_gt, (h, w))
    onehot = torch.nn.functional.one_hot(labels.long(), c).float()
    onehot = onehot * obj_valid.float()[..., None]
    seg_gt = torch.einsum("bmhw,bmc->bchw", ds, onehot).clamp(0.0, 1.0)
    logits = seg_pred.permute(0, 3, 1, 2).float()
    bce = logits.clamp_min(0) - logits * seg_gt + torch.log1p(torch.exp(-logits.abs()))
    return bce.sum() / h / w / b


def ssg_losses(output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
               anchors: torch.Tensor, generator: Optional[torch.Generator] = None,
               priority: Optional[torch.Tensor] = None, pos_iou_thre: float = 0.5,
               neg_iou_thre: float = 0.4, masks_to_train: int = 100,
               alpha_conf: float = 1.0, alpha_bbox: float = 1.5, alpha_ins: float = 6.126,
               alpha_sem: float = 1.0, alpha_grasp: float = 6.125,
               with_grasp_masks: bool = True):
    """(total, the 8-term loss dict).  ``priority`` [B, N] orders the
    positives that train the mask losses; without it, it is drawn uniform
    from ``generator`` on the host.  The alpha defaults are
    config/OCID-Grasp/ssg_r50.yaml's.

    Under a process group of world > 1 each rank holds its rows of the
    global batch (rank-major): the priorities are drawn for the global
    batch (every rank's generator is seeded alike) and the rank takes its
    rows, and the positive-count normalizers are the global batch's count
    over ``world``, so that DDP's mean of the ranks' gradients is the
    gradient of the global loss, and the mean of the ranks' terms
    (``mean_over_ranks``) the global terms.  The semantic loss is a mean
    over images and stays per rank.

    Each term runs in a profiler range named as the JAX package's scopes
    (``lmatch``, ``lcls``, ``lbox``, ``lins``, ``lsem``, ``lgrasp``), the
    regions of tools/torch_profile_step.py."""
    boxes, labels, obj_valid = batch["boxes"], batch["labels"], batch["obj_valid"]
    with record_function("lmatch"):
        offsets, conf_gt, anchor_max_gt, anchor_max_i = match(
            boxes.float(), obj_valid.bool(), labels, anchors, pos_iou_thre, neg_iou_thre)
        pos = conf_gt > 0
        world, rank = dist.world(), dist.rank()
        b = pos.shape[0]
        if priority is None:
            priority = draw_priority((world * b, pos.shape[1]),
                                     generator)[rank * b:(rank + 1) * b]
        norm = None
        if world > 1:
            norm = dist.all_reduce_sum(pos.sum()).clamp_min(1) / world
        sel_idx, sel_valid, old_np, num_np = _select_positives(
            pos, priority.to(pos.device), masks_to_train)
    loss = {}
    with record_function("lcls"):
        loss["loss_cls"] = alpha_conf * category_loss(output["cls_logits"], conf_gt, pos,
                                                      norm=norm)
    with record_function("lbox"):
        loss["loss_box"] = alpha_bbox * box_loss(output["box_pred"], offsets, pos, norm)
    with record_function("lins"):
        loss["loss_ins"] = alpha_ins * lincomb_mask_loss(
            output["ins_coef_pred"], output["protos"], batch.get("ins_masks"), pos,
            anchor_max_i, anchor_max_gt, sel_idx, sel_valid, old_np, num_np,
            ins_ds=batch.get("ins_ds"), norm=norm)
    with record_function("lsem"):
        loss["loss_sem"] = alpha_sem * semantic_seg_loss(
            output["seg_pred"], batch.get("ins_masks"), labels, obj_valid,
            sem_ds=batch.get("sem_ds"))
    if with_grasp_masks:
        with record_function("lgrasp"):
            g = lincomb_grasp_masks_loss(
                output["grasp_coef_pred"], output["protos"],
                None if "grasp_ds" in batch else {k: batch[f"grasp_{k}"]
                                                  for k in GRASP_KEYS},
                pos, anchor_max_i, anchor_max_gt, sel_idx, sel_valid, old_np, num_np,
                grasp_ds=batch.get("grasp_ds"), norm=norm)
            for k in GRASP_KEYS:
                loss[f"loss_{k}"] = alpha_grasp * g[k]
    return sum(loss.values()), loss
