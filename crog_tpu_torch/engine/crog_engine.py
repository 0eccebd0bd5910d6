"""CROG train / eval engine.

Counterpart of crog_tpu/engine/crog_engine.py: ``train_metrics`` (62),
``make_train_step`` (108), ``train_one_epoch`` (429), ``make_eval_step``
(167), ``jacquard_index`` (264), ``summarize_eval`` (282),
``validate_with_grasp`` (306), ``validate_without_grasp`` (359) and
``inference_with_grasp`` (367).

Both steps take a collated batch in any of the four wire formats
(``data/ocid_vlg.py``): its dense fields go to the card through
``device_put_crog`` (pinned memory, non-blocking; fields that the loader's
put stage already moved pass unchanged) and are unpacked there by
``_unpack`` (compact: ``data/compact.py``; raw and rawlb:
``data/rawwire.py``; legacy: as they are).

The train step is forward in train mode, ``crog_losses``, backward (through
the backward kernels K1b-K4b on the card), optional global-norm clipping,
the optimizer and scheduler steps, the BatchNorm running statistics updated
in place, and the batch IoU metrics; it returns device tensors and never
syncs.  In eval, the whole post-forward pipeline
stays on the device: sigmoid -> bicubic upsample (align_corners=True)
composed with the per-sample inverse letterbox warp as one row and one
column matrix per sample -> thresholded mask IoU -> grasp peak detection.
Only the ragged Jacquard rect check against the ground-truth rects runs on
the host.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from crog_tpu_torch.data.compact import is_compact, unpack_compact
from crog_tpu_torch.data.loader import device_put_crog, to_host
from crog_tpu_torch.data.rawwire import is_raw, unpack_raw
from crog_tpu_torch.engine.optim import clip_by_global_norm_
from crog_tpu_torch.models.crog import crog_losses
from crog_tpu_torch.ops.peaks import detect_grasp_peaks
from crog_tpu_torch.ops.rects import rotated_rect_iou
from crog_tpu_torch.ops.resize import (
    batched_affine_axis_matrix,
    interp_matrix,
    resize_nearest,
)
from crog_tpu_torch.parallel.dist import (
    gather_metrics,
    mean_over_ranks,
    rank,
    unwrap,
    world,
)
from crog_tpu_torch.utils.logging import get_logger
from crog_tpu_torch.utils.meters import AverageMeter, ProgressMeter

TARGET_KEYS = ("mask", "qua", "sin", "cos", "wid")
# the dense fields each wire format sends to the card (crog_tpu/engine/
# crog_engine.py:75-86): legacy float arrays, compact uint8 planes, raw
# uint8 planes with mask bits and raster parameters
_TRAIN_KEYS = ("img", "word", "mask", "qua", "sin", "cos", "wid")
_EVAL_KEYS = ("img", "word", "mask", "inverse", "ori_size")
_TRAIN_KEYS_C = ("img_u8", "planes_u8", "word")
_EVAL_KEYS_C = ("img_u8", "planes_u8", "word", "inverse", "ori_size")
_TRAIN_KEYS_R = ("raw_img_u8", "lb_img_u8", "raw_mask_bits", "rect_corners",
                 "rect_vals", "word")
_EVAL_KEYS_R = _TRAIN_KEYS_R + ("inverse", "ori_size")


def _select_keys(batch, legacy, compact, raw):
    if is_raw(batch):
        return raw
    return compact if is_compact(batch) else legacy


def _unpack(batch: Dict, input_size: int) -> Dict:
    """Wire-format dispatch on the device tensors of a batch (identity on a
    legacy batch)."""
    if is_raw(batch):
        return unpack_raw(batch, input_size)
    if is_compact(batch):
        return unpack_compact(batch)
    return batch


def step_keys(batch: Dict, train: bool = True):
    """The dense fields a train (or eval) step sends to the card for a batch
    in its wire format (those the batch has)."""
    keys = (_select_keys(batch, _TRAIN_KEYS, _TRAIN_KEYS_C, _TRAIN_KEYS_R) if train
            else _select_keys(batch, _EVAL_KEYS, _EVAL_KEYS_C, _EVAL_KEYS_R))
    return tuple(k for k in keys if k in batch)


def device_batch(batch: Dict, device, input_size: int, train: bool = True) -> Dict:
    """Those fields of a batch on ``device``, unpacked there."""
    return _unpack(device_put_crog(batch, step_keys(batch, train), device), input_size)


def dense_host_batch(batch: Dict, input_size: int) -> Dict[str, np.ndarray]:
    """The dense float fields of a batch in any wire format (img, mask and
    the grasp maps, those it has), as numpy: unpacked on the device its
    tensors are on, or on the CPU for host arrays."""
    keys = step_keys(batch)
    dev = next((batch[k].device for k in keys if torch.is_tensor(batch[k])), "cpu")
    dense = device_batch(batch, dev, input_size)
    return {k: to_host(dense[k]) for k in ("img",) + TARGET_KEYS if k in dense}


def set_exact_fp32_matmul() -> None:
    """Full-fp32 products for fp32 tensors on the card: the eval warp
    matrices are Precision.HIGHEST in the JAX package, and TF32 keeps only
    about three decimal digits.  (PyTorch's default for matmul; cuDNN's
    default for convolutions is TF32, which this also turns off.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def train_metrics(pred_logits, target_mask, threshold: float = 0.35,
                  pr_iou: float = 0.5):
    """Batch mask IoU and Pr@50 (reference utils/misc.py:115-131), x100."""
    binary = torch.sigmoid(pred_logits.float()) >= threshold
    t = target_mask > 0.5
    b = binary.reshape(binary.shape[0], -1)
    t = t.reshape(t.shape[0], -1)
    ious = (b & t).sum(1) / ((b | t).sum(1) + 1e-6)
    return 100.0 * ious.mean(), 100.0 * (ious > pr_iou).float().mean()


def make_train_step(model, optimizer, scheduler, use_grasp_masks: bool = True,
                    max_norm: float = 0.0, generator: Optional[torch.Generator] = None,
                    device=None):
    """Returns ``step(batch) -> metrics`` for a numpy batch in any wire
    format; the metrics (``loss``, ``iou``, ``prec@50`` and the ``m_*`` loss
    terms) are device tensors, this rank's (``mean_over_ranks`` gives the
    global batch's).  ``generator`` (a CPU ``torch.Generator``) gives the
    dropout seeds of every step.  ``model`` may be a ``wrap_model`` result:
    the losses are plain means, so with equal per-rank batches DDP's mean
    of the ranks' gradients is the global batch's, and the clipping after
    it clips the global gradient."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    set_exact_fp32_matmul()  # the raw wire's warp products
    params = [p for p in model.parameters() if p.requires_grad]
    input_size = unwrap(model).input_resolution

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        with record_function("unpack"):
            dense = device_batch(batch, device, input_size)
        targets = {k: dense.get(k, dense["mask"]) for k in TARGET_KEYS}
        preds = model(dense["img"], dense["word"], generator=generator)
        loss, loss_dict = crog_losses(preds, targets, use_grasp_masks)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with record_function("opt_update"):
            if max_norm and max_norm > 0:
                clip_by_global_norm_(params, max_norm)
            optimizer.step()
        scheduler.step()
        with torch.no_grad():
            mask = targets["mask"]
            if tuple(mask.shape[1:3]) != tuple(preds.shape[1:3]):
                mask = resize_nearest(mask.float()[..., None], preds.shape[1:3])[..., 0]
            iou, pr5 = train_metrics(preds[..., 0].detach(), mask)
        return {"loss": loss.detach(), "iou": iou, "prec@50": pr5,
                **{k: v.detach() for k, v in loss_dict.items()}}

    return step


def train_one_epoch(loader, train_step, epoch: int, args,
                    steps_per_epoch: Optional[int] = None):
    """One training epoch (reference train_with_grasp, :17-122).  Syncs with
    the device once per ``print_freq`` window only; the logged metrics, and
    the last step's that it returns, are means over the ranks."""
    logger = get_logger()
    num_batches = steps_per_epoch or len(loader)
    meters = {
        name: AverageMeter(label, fmt)
        for name, (label, fmt) in {
            "batch_time": ("Batch", ":2.2f"),
            "data_time": ("Data", ":2.2f"),
            "loss": ("Loss", ":2.4f"),
            "iou": ("IoU", ":2.2f"),
            "prec@50": ("Prec@50", ":2.2f"),
        }.items()
    }
    progress = ProgressMeter(num_batches, list(meters.values()),
                             prefix=f"Training: Epoch=[{epoch}/{args.epochs}] ")
    end = time.perf_counter()
    win_start = end
    metrics = None
    for i, batch in enumerate(loader):
        meters["data_time"].update(time.perf_counter() - end)
        metrics = train_step(batch)
        if (i + 1) % args.print_freq == 0:
            bsz = len(batch["word"])
            logged = mean_over_ranks(metrics)
            for key in ("loss", "iou", "prec@50"):
                meters[key].update(float(logged[key]), bsz)
            now = time.perf_counter()
            meters["batch_time"].update((now - win_start) / args.print_freq)
            win_start = now
            logger.info(progress.display(i + 1))
        end = time.perf_counter()
    return None if metrics is None else mean_over_ranks(metrics)


def make_eval_step(
    model,
    input_size: int = 416,
    ori_hw=(480, 640),
    num_peaks: int = 5,
    mask_threshold: float = 0.35,
    device=None,
):
    """Returns ``step(batch) -> {"iou", "rects", "rects_valid"}`` for a
    numpy batch in any wire format, with per-sample original geometry.

    ``ori_hw`` is the maximum original (h, w) of the split: every sample is
    un-warped to its own resolution (``batch['inverse']`` /
    ``batch['ori_size']``) inside a common zero-padded [B, max_h, max_w]
    canvas.  The letterbox inverse is a pure scale + translate, hence
    separable, so the bicubic 4x upsample composed with the inverse warp is
    one row and one column matrix per sample applied to the raw predictions.
    """
    set_exact_fp32_matmul()
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    max_h, max_w = ori_hw
    pred_size = input_size // 4
    up = torch.from_numpy(interp_matrix(pred_size, input_size, "cubic", True)).to(device)

    @torch.no_grad()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        dense = device_batch(batch, device, input_size, train=False)
        preds = model(dense["img"], dense["word"]).float()
        mask_p = torch.sigmoid(preds[..., 0])
        qua_p = torch.sigmoid(preds[..., 1])
        sin_p = preds[..., 2]
        cos_p = preds[..., 3]
        wid_p = torch.sigmoid(preds[..., 4])

        # cv2.warpAffine(pred, inverse, ori_size) samples src = forward
        # letterbox @ dst: invert the stored axis-aligned input->original map
        inv = dense["inverse"].float()
        osz = dense["ori_size"].int()
        fsy = 1.0 / inv[:, 1, 1]
        foy = -inv[:, 1, 2] * fsy
        fsx = 1.0 / inv[:, 0, 0]
        fox = -inv[:, 0, 2] * fsx
        w_row = batched_affine_axis_matrix(input_size, max_h, fsy, foy, osz[:, 0])
        w_col = batched_affine_axis_matrix(input_size, max_w, fsx, fox, osz[:, 1])
        wr = torch.einsum("bos,sp->bop", w_row, up)
        wc = torch.einsum("bos,sp->bop", w_col, up)

        stack = torch.stack([mask_p, qua_p, sin_p, cos_p, wid_p], dim=1)
        y = torch.einsum("boh,bchw->bcow", wr, stack)
        warped = torch.einsum("bpw,bcow->bcop", wc, y)
        mask_w, qua_w, sin_w, cos_w, wid_w = warped.unbind(1)

        tgt = dense["mask"].float()
        ty = torch.einsum("boh,bhw->bow", w_row, tgt)
        tgt_w = torch.einsum("bpw,bow->bop", w_col, ty)

        pred_bin = mask_w > mask_threshold
        tgt_bin = tgt_w != 0.0  # np.logical_and float semantics
        inter = (pred_bin & tgt_bin).sum(dim=(1, 2))
        union = (pred_bin | tgt_bin).sum(dim=(1, 2))
        iou = inter / (union + 1e-6)

        rects, valid = detect_grasp_peaks(
            qua_w, sin_w, cos_w, wid_w, num_peaks=num_peaks, valid_hw=osz
        )
        return {"iou": iou, "rects": rects, "rects_valid": valid}

    return step


def jacquard_index(
    grasp_preds, grasp_targets, iou_threshold: float = 0.25, shape=(480, 640)
) -> int:
    """1 if any predicted rect overlaps any GT rect above threshold
    (reference utils/grasp_eval.py:350-373): GT height forced to 20, width
    clipped to 100."""
    if len(grasp_preds) == 0:
        return 0
    gts = np.array(grasp_targets, np.float64).copy()
    gts[:, 3] = 20.0
    gts[:, 2] = np.clip(gts[:, 2], 0, 100)
    for gt in gts:
        for p in grasp_preds:
            if rotated_rect_iou(p, gt, shape=shape) > iou_threshold:
                return 1
    return 0


def summarize_eval(iou_list, j_hits_1, j_hits_5, epoch=0, epochs=0):
    iou_arr = np.asarray(iou_list, np.float64)
    prec = {}
    for thres in range(5, 10):
        prec[f"Pr@{thres * 10}"] = float((iou_arr > thres / 10.0).mean())
    result = {
        "iou": float(iou_arr.mean()),
        "prec": prec,
        "j_index@1": float(np.mean(j_hits_1)) if len(j_hits_1) else 0.0,
        "j_index@5": float(np.mean(j_hits_5)) if len(j_hits_5) else 0.0,
    }
    head = (
        f"Evaluation: Epoch=[{epoch}/{epochs}]  IoU={100 * result['iou']:.2f}  "
        f"J_index@1: {100 * result['j_index@1']:.2f}  "
        f"J_index@5: {100 * result['j_index@5']:.2f}  "
    )
    head += "  ".join(f"{k}: {100 * v:.2f}" for k, v in prec.items())
    get_logger().info(head)
    return result


def validate_with_grasp(loader, eval_step, epoch: int = 0, args=None,
                        with_grasps: bool = True, on_batch=None):
    """Eval loop: device metrics + host Jacquard check.

    ``loader`` yields legacy batches whose host-side ``grasps`` are a list
    of [Mi, 6] arrays; a padded tail batch carries ``n_valid``.
    ``on_batch(batch, out, n_valid)`` is called after each step.  Under a
    process group the per-sample values of every rank's shard are gathered
    (rank-major) before the summary, each sample counted once.  Returns
    the summary dict; its ``"iou_list"``, ``"j1_hits"`` and ``"j5_hits"``
    hold the per-sample values.
    """
    iou_list: list = []
    j1_hits: list = []
    j5_hits: list = []
    for batch in loader:
        out = eval_step(batch)
        iou = out["iou"].cpu().numpy()
        n_valid = int(batch.get("n_valid", iou.shape[0]))
        iou_list.extend(iou[:n_valid].tolist())
        if with_grasps:
            rects = out["rects"].cpu().numpy()
            valid = out["rects_valid"].cpu().numpy()
            ori_sizes = to_host(batch["ori_size"]) if "ori_size" in batch \
                else np.full((rects.shape[0], 2), (480, 640))
            for i in range(n_valid):
                preds5 = [rects[i, k].tolist() for k in range(rects.shape[1])
                          if valid[i, k]]
                gts = batch["grasps"][i]
                shape = (int(ori_sizes[i, 0]), int(ori_sizes[i, 1]))
                j1_hits.append(jacquard_index(preds5[:1], gts, shape=shape))
                j5_hits.append(jacquard_index(preds5, gts, shape=shape))
        if on_batch is not None:
            on_batch(batch, out, n_valid)
    iou_list = gather_metrics(np.asarray(iou_list, np.float64)).tolist()
    j1_hits = gather_metrics(np.asarray(j1_hits, np.int64)).tolist()
    j5_hits = gather_metrics(np.asarray(j5_hits, np.int64)).tolist()
    epochs = getattr(args, "epochs", 0) if args is not None else 0
    result = summarize_eval(iou_list, j1_hits, j5_hits, epoch, epochs)
    result.update(iou_list=iou_list, j1_hits=j1_hits, j5_hits=j5_hits)
    return result


def validate_without_grasp(loader, eval_step, epoch: int = 0, args=None):
    """Mask-only eval (reference engine/crog_engine.py:289-381): the same
    device pipeline with the Jacquard check skipped (the use_grasp_masks
    ablation, RefCOCO)."""
    return validate_with_grasp(loader, eval_step, epoch, args, with_grasps=False)


def inference_with_grasp(loader, eval_step, args=None, visualize: bool = False,
                         vis_dir: str = "vis"):
    """Test-split inference (reference engine/crog_engine.py:386-558):
    ``validate_with_grasp``, and with ``visualize`` one PNG per real sample
    of the whole split (``<vis_dir>/<batch>_<sample>.png``, under a process
    group ``r<rank>_<batch>_<sample>.png`` over the rank's shard: the
    image, the predicted rects and the ground-truth mask and grasp maps),
    rendered in the same pass over the loader.  Every wire format is unpacked first:
    raw and rawlb batches on their own path, which the JAX package's
    version misses (crog_tpu/engine/crog_engine.py:390 tests only
    ``raw_img_u8``, so a rawlb batch reaches the render packed and raises
    KeyError on ``img``)."""
    on_batch = None
    if visualize:
        from crog_tpu_torch.utils.visualization import visualize_grasp_prediction

        size = int(args.get("input_size", 416)) if args is not None else 416
        counter = {"batch": 0}
        prefix = "" if world() == 1 else f"r{rank()}_"

        def on_batch(batch, out, n_valid):
            dense = dense_host_batch(batch, size)
            bi = counter["batch"]
            counter["batch"] += 1
            rects = out["rects"].cpu().numpy()
            valid = out["rects_valid"].cpu().numpy()
            sentences = batch.get("sentence", [""] * rects.shape[0])
            for i in range(n_valid):
                img = dense["img"][i]
                img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
                mask = dense["mask"][i]
                visualize_grasp_prediction(
                    (img * 255).astype(np.uint8), mask,
                    tuple(dense.get(k, dense["mask"])[i] for k in ("qua", "sin", "wid")),
                    [r for k, r in enumerate(rects[i]) if valid[i, k]],
                    sentences[i], save_path=f"{vis_dir}/{prefix}{bi:04d}_{i:02d}.png",
                )

    return validate_with_grasp(
        loader, eval_step, 0, args,
        with_grasps=args is None or args.get("use_grasp_masks", True),
        on_batch=on_batch,
    )
