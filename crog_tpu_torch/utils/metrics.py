"""Segmentation metric helpers (reference utils/misc.py:115-167), on
tensors wherever they live.  Counterpart of crog_tpu/utils/metrics.py."""

from __future__ import annotations

import torch

def _iou(output_logits, target, threshold: float):
    prob = torch.sigmoid(output_logits.float())
    b = prob.reshape(prob.shape[0], -1) >= threshold
    t = target.reshape(target.shape[0], -1) > 0.5
    inter = (b & t).sum(1)
    union = (b | t).sum(1)
    return inter / (union + 1e-6)


def train_mask_metrics(output_logits, target, threshold=0.35, pr_iou=0.5):
    """Batch thresholded mask IoU (x100) and Pr@pr_iou (reference
    trainMetricGPU, utils/misc.py:115-131)."""
    ious = _iou(output_logits, target, threshold)
    return 100.0 * ious.mean(), 100.0 * (ious > pr_iou).float().mean()


def val_mask_metrics(output_logits, target, threshold=0.35):
    """Per-sample IoU [B] and Pr@{50..90} hits [B, 5] (reference
    ValMetricGPU, utils/misc.py:134-150).  The thresholds are the
    reference's ``torch.arange(0.5, 1.0, 0.1)``; crog_tpu's jnp.arange
    rounds 0.7, 0.8 and 0.9 one float32 step higher."""
    iou = _iou(output_logits, target, threshold)
    thresholds = torch.arange(0.5, 1.0, 0.1, device=iou.device)
    return iou, (iou[:, None] > thresholds[None, :]).float()


def intersection_and_union(output, target, num_classes: int, ignore_index=255):
    """Multi-class intersection / union / target histograms [num_classes]
    (reference intersectionAndUnionGPU, utils/misc.py:153-167)."""
    output = output.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index
    output = torch.where(valid, output, num_classes)
    target = torch.where(valid, target, num_classes)
    n = num_classes + 1
    area_inter = torch.bincount(torch.where(output == target, output, num_classes),
                                minlength=n)[:num_classes]
    area_out = torch.bincount(output, minlength=n)[:num_classes]
    area_tgt = torch.bincount(target, minlength=n)[:num_classes]
    return area_inter, area_out + area_tgt - area_inter, area_tgt
