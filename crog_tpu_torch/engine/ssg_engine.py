"""SSG train / eval engine.

Counterpart of crog_tpu/engine/ssg_engine.py: ``make_ssg_train_step`` (48),
``train_one_epoch`` (110), ``make_ssg_eval_fwd`` (143) and ``validate``
(237).  The train step is forward in train mode, ``ssg_losses`` (anchor
matching, the 8 terms, K5 for the two prototype-combination losses),
backward (K5b), optional global-norm clipping, AdamW and the schedule, the
BatchNorm running statistics updated in place; it returns device tensors
and never syncs.  Eval is the forward in eval mode and
``models/ssg_eval.py`` post-processing on the device, then the host-side
per-object Jacquard check: a ground-truth object counts as hit if any
predicted instance's grasps match it.  Only the legacy (dense) batch is
ported; a raw-wire batch raises.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from crog_tpu_torch.engine.crog_engine import jacquard_index
from crog_tpu_torch.engine.optim import clip_by_global_norm_
from crog_tpu_torch.models.ssg_loss import ssg_losses
from crog_tpu_torch.utils.logging import get_logger
from crog_tpu_torch.utils.meters import AverageMeter, ProgressMeter

DENSE_KEYS = ("img", "boxes", "labels", "obj_valid", "ins_masks", "grasp_qua",
              "grasp_sin", "grasp_cos", "grasp_wid")


def _dense(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    if "ssg_img_u8" in batch:
        raise NotImplementedError(
            "the SSG raw wire is not ported yet (ROADMAP queue 1); use wire_format legacy")
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys if k in batch}


def make_ssg_train_step(model, optimizer, scheduler, anchors: np.ndarray,
                        loss_cfg: Dict[str, Any], generator: Optional[torch.Generator] = None,
                        max_norm: float = 0.0, device=None):
    """Returns ``step(batch) -> metrics`` for a legacy numpy batch of
    ``data/ocid_grasp.py:collate_ssg``; the metrics (``loss`` and the 8
    terms) are device tensors.  ``generator`` (a CPU ``torch.Generator``)
    draws each step's positive priorities."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    anchors_t = torch.as_tensor(np.asarray(anchors, np.float32)).to(device)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        dense = _dense(batch, DENSE_KEYS, device)
        model.train()
        output = model(dense["img"])
        loss, loss_dict = ssg_losses(output, dense, anchors_t, generator, **loss_cfg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if max_norm and max_norm > 0:
            clip_by_global_norm_(params, max_norm)
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in loss_dict.items()}}

    return step


def train_one_epoch(loader, train_step, epoch: int, args,
                    steps_per_epoch: Optional[int] = None):
    """One training epoch; syncs with the device once per ``print_freq``
    window only."""
    logger = get_logger()
    meters = {"batch_time": AverageMeter("Batch", ":2.2f"),
              "loss": AverageMeter("Loss", ":2.4f")}
    progress = ProgressMeter(steps_per_epoch or len(loader), list(meters.values()),
                             prefix=f"SSG Training: Epoch=[{epoch}/{args.epochs}] ")
    win_start = time.perf_counter()
    metrics = None
    for i, batch in enumerate(loader):
        metrics = train_step(batch)
        if (i + 1) % args.print_freq == 0:
            m = {k: float(v) for k, v in metrics.items()}
            meters["loss"].update(m["loss"], len(batch["img"]))
            now = time.perf_counter()
            meters["batch_time"].update((now - win_start) / args.print_freq)
            win_start = now
            logger.info(progress.display(i + 1) + "  " + "  ".join(
                f"{k}={v:.3f}" for k, v in m.items() if k != "loss"))
    return metrics


def make_ssg_eval_fwd(model, device=None):
    """Returns ``fwd(batch) -> (output, img)``: the eval-mode forward of
    every sample in a legacy batch (pair batch-N loaders with
    ``make_ssg_post_processing(batched=True)``)."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device

    @torch.no_grad()
    def fwd(batch: Dict):
        img = _dense(batch, ("img",), device)["img"]
        model.eval()
        return model(img), img

    return fwd


def _batched_post(post: Dict) -> Dict:
    """A batch-1 post result (no batch axis) with a leading [1]."""
    if post["det_valid"].dim() == 1:
        return {k: v[None] if torch.is_tensor(v) else v for k, v in post.items()}
    return post


def validate(loader, post_fn, fwd, epoch: int, args, max_batches: int = 101):
    """Per-object J@1 / J@5 over at most ``max_batches`` val batches;
    returns [j1, j5]."""
    logger = get_logger()
    hits, totals = [0, 0], [0, 0]
    for i, batch in enumerate(loader):
        output, _ = fwd(batch)
        post = _batched_post(post_fn(output))
        rects_b = post["grasp_rects"].cpu().numpy()  # [B, K, 5, 5]
        gvalid_b = post["grasp_valid"].cpu().numpy()
        dvalid_b = post["det_valid"].cpu().numpy()
        for bi in range(rects_b.shape[0]):
            rects, gvalid, dvalid = rects_b[bi], gvalid_b[bi], dvalid_b[bi]
            pred_instances = [
                [rects[k, j].tolist() for j in range(rects.shape[1]) if gvalid[k, j]]
                for k in range(rects.shape[0]) if dvalid[k]
            ]
            for gt_rects in batch["ins_grasp_rects"][bi]:
                for gi, topk in enumerate((1, 5)):
                    hit = any(jacquard_index([p[:5] for p in preds[:topk]], gt_rects)
                              for preds in pred_instances if preds)
                    hits[gi] += int(hit)
                    totals[gi] += 1
        if i >= max_batches - 1:
            break
    j1 = hits[0] / max(totals[0], 1)
    j5 = hits[1] / max(totals[1], 1)
    logger.info(f"SSG Evaluation: Epoch=[{epoch}/{args.epochs}]  "
                f"J_index@1: {100 * j1:.2f}  J_index@5: {100 * j5:.2f}")
    return [j1, j5]
