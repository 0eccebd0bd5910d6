"""Box and anchor utilities for SSG.

Counterpart of crog_tpu/ops/boxes.py: ``make_anchors`` (21), ``box_iou``
(36), ``encode`` (48), ``decode`` (58), ``match`` (67), ``box_inside_mask``
(118), ``crop_masks`` (142) and ``mask_iou`` (150).  ``match`` takes one
image ([M, 4] boxes) or a batch ([B, M, 4]): every op broadcasts over the
leading axes.

Two choices pin the port to what the JAX package gives on the CPU:
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does; and
when two valid ground truths share a best anchor, the force-match gives that
anchor to the later ground truth, as XLA's in-order scatter does on the CPU.
The port takes it with an ``amax`` scatter-reduce, which does not depend on
the order of the writes, so the card gives the same winner.
"""

from __future__ import annotations

from itertools import product
from math import sqrt

import numpy as np
import torch

VARIANCES = (0.1, 0.2)


def make_anchors(conv_h, conv_w, scale, aspect_ratios, img_size) -> np.ndarray:
    """Center-form priors [N, 4]; iteration order (rows, cols, ratios)
    matches the prediction head's flattening."""
    priors = []
    for j, i in product(range(conv_h), range(conv_w)):
        x = (i + 0.5) / conv_w
        y = (j + 0.5) / conv_h
        for ar in aspect_ratios:
            ar = sqrt(ar)
            priors.append([x, y, scale * ar / img_size, scale / ar / img_size])
    return np.asarray(priors, np.float32)


def box_iou(box_a, box_b):
    """Pairwise IoU of point-form boxes: [..., A, 4] x [..., B, 4] ->
    [..., A, B]."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    inter = (max_xy - min_xy).clamp_min(0.0)
    inter_area = inter[..., 0] * inter[..., 1]
    area_a = (box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1])
    area_b = (box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1])
    return inter_area / (area_a[..., :, None] + area_b[..., None, :] - inter_area)


def encode(matched, priors):
    """Point-form GT -> (cx, cy, w, h) offsets with variances (0.1, 0.2)."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (VARIANCES[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(g_wh.clamp_min(1e-12)) / VARIANCES[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(box_pred, anchors):
    """Offsets -> point-form boxes, clipped to [0, 1]."""
    cxcy = anchors[..., :2] + box_pred[..., :2] * VARIANCES[0] * anchors[..., 2:]
    wh = anchors[..., 2:] * torch.exp(box_pred[..., 2:] * VARIANCES[1])
    return torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1).clamp(0.0, 1.0)


def match(box_gt, gt_valid, class_gt, anchors_cf, pos_iou_thre: float = 0.5,
          neg_iou_thre: float = 0.4):
    """Anchor-GT assignment over a padded GT set.

    box_gt [..., M, 4] point form, gt_valid [..., M] bool, class_gt [..., M]
    int, anchors_cf [N, 4] center form.  Returns (offsets [..., N, 4], conf
    [..., N] int32, anchor_max_gt [..., N, 4], anchor_max_i [..., N] int64);
    conf is 0 for background, -1 neutral, > 0 the class.
    """
    decoded = torch.cat([anchors_cf[:, :2] - anchors_cf[:, 2:] / 2,
                         anchors_cf[:, :2] + anchors_cf[:, 2:] / 2], dim=1)
    overlaps = box_iou(box_gt, decoded)  # [..., M, N]
    overlaps = torch.where(gt_valid[..., None], overlaps, -1.0)
    gt_max_i = torch.argmax(overlaps, dim=-1)  # best anchor of each GT
    each_anchor_max, _ = torch.max(overlaps, dim=-2)
    anchor_max_i = torch.argmax(overlaps, dim=-2)

    # force-match the best anchor of each valid GT (IoU := 2), so every GT
    # owns a positive; the later GT wins an anchor two of them share
    m = box_gt.shape[-2]
    gt_ids = torch.arange(m, device=box_gt.device).expand_as(gt_max_i)
    forced = torch.full_like(anchor_max_i, -1).scatter_reduce(
        -1, gt_max_i, torch.where(gt_valid, gt_ids, -1), reduce="amax")
    each_anchor_max = torch.where(forced >= 0, 2.0, each_anchor_max)
    anchor_max_i = torch.where(forced >= 0, forced, anchor_max_i)

    anchor_max_gt = torch.gather(
        box_gt, -2, anchor_max_i[..., None].expand(*anchor_max_i.shape, 4))
    conf = torch.gather(class_gt, -1, anchor_max_i).to(torch.int32)
    conf = torch.where(each_anchor_max < pos_iou_thre, -1, conf)
    conf = torch.where(each_anchor_max < neg_iou_thre, 0, conf).to(torch.int32)
    offsets = encode(anchor_max_gt, anchors_cf)
    return offsets, conf, anchor_max_gt, anchor_max_i


def sanitize_boxes(boxes, h: int, w: int, padding: int = 1):
    """[..., 4] relative boxes -> (x1, x2, y1, y2) pixel bounds, padded by
    ``padding`` and clipped to the map, in the float arithmetic of
    ``box_inside_mask``."""

    def axis(a, b, size):
        a = a * size
        b = b * size
        lo = torch.minimum(a, b)
        hi = torch.maximum(a, b)
        return (lo - padding).clamp_min(0.0), (hi + padding).clamp_max(float(size))

    x1, x2 = axis(boxes[..., 0], boxes[..., 2], w)
    y1, y2 = axis(boxes[..., 1], boxes[..., 3], h)
    return x1, x2, y1, y2


def box_inside_mask(boxes, h: int, w: int, padding: int = 1):
    """[N, 4] relative boxes -> boolean [H, W, N] inside-box mask."""
    x1, x2, y1, y2 = sanitize_boxes(boxes, h, w, padding)
    cols = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, :, None]
    rows = torch.arange(h, dtype=torch.float32, device=boxes.device)[:, None, None]
    return (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)


def crop_masks(masks, boxes, padding: int = 1, outside_value: float = 0.0):
    """Zero (or fill) everything outside each box.  masks [H, W, N]; boxes
    [N, 4] relative."""
    h, w, _ = masks.shape
    inside = box_inside_mask(boxes, h, w, padding)
    return torch.where(inside, masks, outside_value)


def mask_iou(mask1, mask2):
    """[A, P] x [B, P] binary masks -> [A, B] IoU."""
    inter = mask1 @ mask2.T
    area1 = mask1.sum(1)[:, None]
    area2 = mask2.sum(1)[None, :]
    return inter / (area1 + area2 - inter)
