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
predicted instance's grasps match it.  A batch is either the legacy dense
one (``data/ocid_grasp.py:collate_ssg``) or the raw wire
(``data/ssg_rawwire.py:collate_ssg_raw``), which the step copies to the
device pinned and non-blocking and unpacks there (augmentation, raster,
targets downsampled as the loss takes them); eval unpacks only the image.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from crog_tpu_torch.data.loader import device_put_crog
from crog_tpu_torch.data.ssg_rawwire import (
    SSG_RAW_EVAL_KEYS,
    SSG_RAW_STEP_KEYS,
    is_ssg_raw,
    unpack_ssg_raw,
)
from crog_tpu_torch.engine.crog_engine import jacquard_index
from crog_tpu_torch.engine.optim import clip_by_global_norm_
from crog_tpu_torch.models.ssg_loss import ssg_losses
from crog_tpu_torch.parallel.dist import gather_metrics, mean_over_ranks, unwrap
from crog_tpu_torch.utils.logging import get_logger
from crog_tpu_torch.utils.meters import AverageMeter, ProgressMeter

DENSE_KEYS = ("img", "boxes", "labels", "obj_valid", "ins_masks", "grasp_qua",
              "grasp_sin", "grasp_cos", "grasp_wid")


def device_batch(batch: Dict, device, img_size: int, with_depth: bool = True,
                 targets: bool = True, max_objs: int = 0) -> Dict[str, torch.Tensor]:
    """A host batch's fields as the model and the loss take them, on
    ``device``: a raw wire batch is copied and unpacked there (with
    ``targets``, padded to ``max_objs`` instances and downsampled as the
    loss consumes them), a legacy batch copied."""
    if is_ssg_raw(batch):
        raw = device_put_crog(batch, SSG_RAW_STEP_KEYS if targets else SSG_RAW_EVAL_KEYS,
                              device)
        with torch.no_grad():
            return unpack_ssg_raw(raw, img_size, with_depth, targets=targets,
                                  pad_objs=max_objs, emit_ds=targets)
    return device_put_crog(batch, DENSE_KEYS if targets else ("img",), device)


def make_ssg_train_step(model, optimizer, scheduler, anchors: np.ndarray,
                        loss_cfg: Dict[str, Any], generator: Optional[torch.Generator] = None,
                        max_norm: float = 0.0, device=None, max_objs: int = 24):
    """Returns ``step(batch) -> metrics`` for a host batch, legacy or raw
    wire; the metrics (``loss`` and the 8 terms) are device tensors, this
    rank's (``mean_over_ranks`` gives the global batch's).  ``generator``
    (a CPU ``torch.Generator``) draws each step's positive priorities; a
    raw batch's targets are padded to ``max_objs`` instances.  ``model``
    may be a ``wrap_model`` result (``ssg_losses`` then normalizes by the
    global batch's positive count)."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    anchors_t = torch.as_tensor(np.asarray(anchors, np.float32)).to(device)
    params = [p for p in model.parameters() if p.requires_grad]
    net = unwrap(model)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        with record_function("unpack"):
            dense = device_batch(batch, device, net.img_size, net.with_depth,
                                 max_objs=max_objs)
        model.train()
        output = model(dense["img"])
        loss, loss_dict = ssg_losses(output, dense, anchors_t, generator, **loss_cfg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with record_function("opt_update"):
            if max_norm and max_norm > 0:
                clip_by_global_norm_(params, max_norm)
            optimizer.step()
        scheduler.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in loss_dict.items()}}

    return step


def train_one_epoch(loader, train_step, epoch: int, args,
                    steps_per_epoch: Optional[int] = None):
    """One training epoch; syncs with the device once per ``print_freq``
    window only; the logged metrics, and the last step's that it returns,
    are means over the ranks."""
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
            m = {k: float(v) for k, v in mean_over_ranks(metrics).items()}
            meters["loss"].update(m["loss"], len(batch["obj_valid"]))
            now = time.perf_counter()
            meters["batch_time"].update((now - win_start) / args.print_freq)
            win_start = now
            logger.info(progress.display(i + 1) + "  " + "  ".join(
                f"{k}={v:.3f}" for k, v in m.items() if k != "loss"))
    return None if metrics is None else mean_over_ranks(metrics)


def make_ssg_eval_fwd(model, device=None):
    """Returns ``fwd(batch) -> (output, img)``: the eval-mode forward of
    every sample in a legacy or raw batch, and the image it saw (pair
    batch-N loaders with ``make_ssg_post_processing(batched=True)``)."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device

    @torch.no_grad()
    def fwd(batch: Dict):
        with record_function("unpack"):
            img = device_batch(batch, device, model.img_size, model.with_depth,
                               targets=False)["img"]
        model.eval()
        return model(img), img

    return fwd


def _batched_post(post: Dict) -> Dict:
    """A batch-1 post result (no batch axis) with a leading [1]."""
    if post["det_valid"].dim() == 1:
        return {k: v[None] if torch.is_tensor(v) else v for k, v in post.items()}
    return post


def visualization(loader, post_fn, fwd, epoch: int, vis_dir: str, rng: random.Random):
    """Render the first sample of one val batch, drawn from ``rng``: RGB,
    predicted grasps, instance mask and grasp maps, written to
    ``<vis_dir>/ssg_epoch<epoch>.png`` (needs matplotlib).  ``post_fn`` is
    the batch-1 post-processing with its full-resolution maps."""
    from crog_tpu_torch.utils.visualization import visualize_grasp_prediction

    idx = rng.randint(0, max(len(loader) - 1, 0))
    for i, batch in enumerate(loader):
        if i < idx:
            continue
        output, img = fwd(batch)
        post = _batched_post(post_fn({k: v[:1] for k, v in output.items()}))
        rects = post["grasp_rects"][0].cpu().numpy()
        gvalid = post["grasp_valid"][0].cpu().numpy()
        dvalid = post["det_valid"][0].cpu().numpy()
        all_rects = [rects[k, j] for k in range(rects.shape[0]) if dvalid[k]
                     for j in range(rects.shape[1]) if gvalid[k, j]]
        maps = [m.cpu().numpy() for m in post["grasp_masks"]]  # each [K, H, W]
        mask = post["ins_masks"][0].cpu().numpy().any(axis=0)
        return visualize_grasp_prediction(
            (img[0, :, :, :3].cpu().numpy() * 255).astype(np.uint8), mask.astype(float),
            tuple(m.max(axis=0) if m.ndim == 3 else m for m in maps), all_rects,
            f"epoch {epoch}", save_path=f"{vis_dir}/ssg_epoch{epoch:04d}.png")
    return None


def validate(loader, post_fn, fwd, epoch: int, args, max_batches: int = 101):
    """Per-object J@1 / J@5 over at most ``max_batches`` val batches;
    returns [j1, j5].  Under a process group each rank reads its shard of
    what is validated (``train_ssg.ssg_val_loader``), and the hit counts
    are summed over the ranks at the end, the one collective here, so the
    ranks' batch counts may differ."""
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
    hits[0], hits[1], totals[0], totals[1] = gather_metrics(
        np.asarray([hits + totals], np.int64)).sum(0).tolist()
    j1 = hits[0] / max(totals[0], 1)
    j5 = hits[1] / max(totals[1], 1)
    logger.info(f"SSG Evaluation: Epoch=[{epoch}/{args.epochs}]  "
                f"J_index@1: {100 * j1:.2f}  J_index@5: {100 * j5:.2f}")
    return [j1, j5]
