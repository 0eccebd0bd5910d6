"""CROG eval engine.

Counterpart of the eval half of crog_tpu/engine/crog_engine.py:
``make_eval_step`` (167), ``jacquard_index`` (264), ``summarize_eval``
(282) and ``validate_with_grasp`` (306).  The whole post-forward pipeline
stays on the device: sigmoid -> bicubic upsample (align_corners=True)
composed with the per-sample inverse letterbox warp as one row and one
column matrix per sample -> thresholded mask IoU -> grasp peak detection.
Only the ragged Jacquard rect check against the ground-truth rects runs on
the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from crog_tpu_torch.ops.peaks import detect_grasp_peaks
from crog_tpu_torch.ops.rects import rotated_rect_iou
from crog_tpu_torch.ops.resize import batched_affine_axis_matrix, interp_matrix
from crog_tpu_torch.utils.logging import get_logger


def set_exact_fp32_matmul() -> None:
    """Full-fp32 products for fp32 tensors on the card: the eval warp
    matrices are Precision.HIGHEST in the JAX package, and TF32 keeps only
    about three decimal digits.  (PyTorch's default for matmul; cuDNN's
    default for convolutions is TF32, which this also turns off.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_eval_step(
    model,
    input_size: int = 416,
    ori_hw=(480, 640),
    num_peaks: int = 5,
    mask_threshold: float = 0.35,
    device=None,
):
    """Returns ``step(batch) -> {"iou", "rects", "rects_valid"}`` for a
    legacy-format numpy batch, with per-sample original geometry.

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
        if "img" not in batch:
            raise NotImplementedError(
                "only the legacy wire format is ported (ROADMAP queue 1, item 4)"
            )
        img = torch.as_tensor(batch["img"]).to(device)
        word = torch.as_tensor(batch["word"]).to(device)
        preds = model(img, word).float()
        mask_p = torch.sigmoid(preds[..., 0])
        qua_p = torch.sigmoid(preds[..., 1])
        sin_p = preds[..., 2]
        cos_p = preds[..., 3]
        wid_p = torch.sigmoid(preds[..., 4])

        # cv2.warpAffine(pred, inverse, ori_size) samples src = forward
        # letterbox @ dst: invert the stored axis-aligned input->original map
        inv = torch.as_tensor(batch["inverse"]).to(device, torch.float32)
        osz = torch.as_tensor(batch["ori_size"]).to(device, torch.int32)
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

        tgt = torch.as_tensor(batch["mask"]).to(device, torch.float32)
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
    ``on_batch(batch, out, n_valid)`` is called after each step.  Returns
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
            ori_sizes = np.asarray(batch["ori_size"]) if "ori_size" in batch \
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
    epochs = getattr(args, "epochs", 0) if args is not None else 0
    result = summarize_eval(iou_list, j1_hits, j5_hits, epoch, epochs)
    result.update(iou_list=iou_list, j1_hits=j1_hits, j5_hits=j5_hits)
    return result
