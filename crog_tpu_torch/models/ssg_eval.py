"""SSG post-processing: Fast NMS, prototype mask assembly and grasp
detection, on the device with fixed shapes.

Counterpart of crog_tpu/models/ssg_eval.py: ``_sample_bilinear_at`` (43),
``fast_nms`` (70), ``_post_one`` (102) and ``make_ssg_post_processing``
(197).  The per-image body is written once for a batch; the batch-1 mode
returns arrays without a batch axis (the reference's contract, which raises
on a larger batch), the batched mode keeps the leading [B].  Invalid
detections are carried by a validity mask, not dropped.  ``lax.top_k``
becomes a stable descending sort (equal scores in index order, as top_k
orders them).

Only the instance masks and the quality map are assembled at full
resolution; sin, cos and width are read at the quality peaks by an exact
4-tap bilinear sample of the proto-resolution maps.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from crog_tpu_torch.ops.boxes import box_iou, box_inside_mask, decode
from crog_tpu_torch.ops.filters import gaussian_blur
from crog_tpu_torch.ops.peaks import find_peaks, grasp_rects_from_values
from crog_tpu_torch.ops.resize import resize_bilinear

NEG = -1e9


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sample_bilinear_at(m, pr, pc, out_size: int):
    """The bilinear ``out_size`` upsample (align_corners False) of
    [..., K, ph, pw] maps read at pixels (pr, pc) [..., K, P], without
    building the upsampled plane."""
    ph, pw = m.shape[-2:]

    def axis(p, in_size):
        src = ((p.float() + 0.5) * (in_size / out_size) - 0.5).clamp_min(0.0)
        i0 = torch.floor(src)
        t = src - i0
        i0 = i0.long()
        return i0.clamp(0, in_size - 1), (i0 + 1).clamp(0, in_size - 1), t

    y0, y1, ty = axis(pr, ph)
    x0, x1, tx = axis(pc, pw)
    flat = m.reshape(*m.shape[:-2], ph * pw)
    at = lambda y, x: torch.gather(flat, -1, y * pw + x)
    top = at(y0, x0) * (1 - tx) + at(y0, x1) * tx
    bot = at(y1, x0) * (1 - tx) + at(y1, x1) * tx
    return top * (1 - ty) + bot * ty


def _rows(x, idx):
    """x [B, N, ...] at idx [B, K] -> [B, K, ...]."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape))


def fast_nms(scores, boxes, ins_coef, grasp_coef, top_k: int = 200,
             iou_thre: float = 0.5, max_detections: int = 100):
    """Matrix Fast-NMS with fixed shapes, per image of a batch: scores
    [B, C-1, N] (background removed), boxes [B, N, 4] decoded, ins_coef
    [B, N, P], grasp_coef [B, N, 4, P]."""
    b = scores.shape[0]
    top_scores, idx = _top_k(scores, top_k)  # [B, C-1, top_k]
    boxes_k = torch.gather(boxes[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                           idx[..., None].expand(*idx.shape, 4))
    iou = torch.triu(box_iou(boxes_k, boxes_k), diagonal=1)
    iou_max = iou.max(dim=-2).values
    keep = iou_max <= iou_thre
    flat_scores = torch.where(keep, top_scores, NEG).reshape(b, -1)
    det_scores, flat_i = _top_k(flat_scores, max_detections)
    anchor_i = torch.gather(idx.reshape(b, -1), 1, flat_i)
    return {
        "scores": det_scores,
        "class_ids": flat_i // top_k + 1,  # the background offset again
        "boxes": _rows(boxes, anchor_i),
        "ins_coef": _rows(ins_coef, anchor_i),
        "grasp_coef": _rows(grasp_coef, anchor_i),
        "valid": det_scores > NEG / 2,
    }


def _post(protos, cls_pred, box_pred, ins_coef, grasp_coef, *, anchors,
          nms_score_thre, nms_iou_thre, top_k, max_detections, score_keep, ori_h,
          ori_w, num_peaks, with_maps) -> Dict[str, torch.Tensor]:
    """The post body over a batch: protos [B, ph, pw, P], cls_pred [B, N, C],
    box_pred [B, N, 4], ins_coef [B, N, P], grasp_coef [B, N, 4, P]."""
    b = cls_pred.shape[0]
    input_size = max(ori_h, ori_w)
    scores = cls_pred[..., 1:].transpose(1, 2)  # [B, C-1, N]
    maxs = scores.max(dim=1, keepdim=True).values
    scores = torch.where(maxs > nms_score_thre, scores, NEG)
    boxes = decode(box_pred, anchors)
    det = fast_nms(scores, boxes, ins_coef, grasp_coef, top_k, nms_iou_thre,
                   max_detections)
    det["valid"] = det["valid"] & (det["scores"] > score_keep)
    k = max_detections
    inside = torch.stack([box_inside_mask(det["boxes"][i], *protos.shape[1:3])
                          for i in range(b)]).permute(0, 3, 1, 2)  # [B, K, ph, pw]

    def proto_maps(coef, sigmoid):  # [B, K, ph, pw], cropped
        m = torch.einsum("bhwp,bkp->bkhw", protos, coef)
        if sigmoid:
            m = torch.sigmoid(m)
        return torch.where(inside, m, 0.0)

    def to_full(m):  # [B, K, ph, pw] -> [B, K, ori_h, ori_w]
        m = resize_bilinear(m[..., None], (input_size, input_size), False)[..., 0]
        return m[..., :ori_h, :ori_w]

    ins_masks = to_full(proto_maps(det["ins_coef"], True)) > 0.5
    gc = det["grasp_coef"]
    qua_p = proto_maps(gc[:, :, 0], True)
    sin_p = proto_maps(gc[:, :, 1], False)
    cos_p = proto_maps(gc[:, :, 2], False)
    wid_p = proto_maps(gc[:, :, 3], True)
    qua = gaussian_blur(to_full(qua_p), 2.0)
    pr, pc, valid5 = (x.reshape(b, k, num_peaks) for x in
                      find_peaks(qua.reshape(b * k, ori_h, ori_w), num_peaks))
    sin_at = _sample_bilinear_at(sin_p, pr, pc, input_size)
    cos_at = _sample_bilinear_at(cos_p, pr, pc, input_size)
    wid_at = _sample_bilinear_at(wid_p, pr, pc, input_size)
    rects5 = grasp_rects_from_values(pr, pc, torch.atan2(sin_at, cos_at) / 2.0, wid_at)
    out = {
        "cls": det["class_ids"],
        "scores": det["scores"],
        "det_valid": det["valid"],
        "bboxes": det["boxes"] * float(ori_w),
        "ins_masks": ins_masks,
        "grasp_rects": rects5,
        "grasp_valid": valid5,
    }
    if with_maps:
        sin_f, cos_f = to_full(sin_p), to_full(cos_p)
        out["grasp_masks"] = (qua, torch.atan2(sin_f, cos_f) / 2.0, to_full(wid_p))
    return out


def make_ssg_post_processing(anchors: np.ndarray, num_protos: int = 32,
                             nms_score_thre: float = 0.05, nms_iou_thre: float = 0.5,
                             top_k: int = 200, max_detections: int = 100,
                             score_keep: float = 0.3, ori_hw=(480, 640),
                             num_peaks: int = 5, batched: bool = False,
                             with_maps: bool | None = None):
    """Returns ``post(output) -> detection dict``.

    ``batched=False``: a batch-1 forward output in, arrays with a leading
    [max_detections] axis out; a larger batch raises.  ``batched=True``:
    every output keeps the leading [B].  ``with_maps`` adds the full
    resolution (qua, ang, wid) maps; by default on for batch-1 and off for
    batched, whose Jacquard check needs only the rects."""
    anchors_t = torch.as_tensor(np.asarray(anchors, np.float32))
    ori_h, ori_w = ori_hw
    kw = dict(nms_score_thre=nms_score_thre, nms_iou_thre=nms_iou_thre, top_k=top_k,
              max_detections=max_detections, score_keep=score_keep, ori_h=ori_h,
              ori_w=ori_w, num_peaks=num_peaks,
              with_maps=(not batched) if with_maps is None else with_maps)

    @torch.no_grad()
    def post(output: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ins_coef = output["ins_coef_pred"].float()
        grasp_coef = output.get("grasp_coef_pred")
        if grasp_coef is None:
            grasp_coef = ins_coef.new_zeros(ins_coef.shape[:-1] + (4, ins_coef.shape[-1]))
        if not batched and output["cls_pred"].shape[0] != 1:
            raise ValueError(
                f"batch-1 post-processing got batch {output['cls_pred'].shape[0]}"
                " — build make_ssg_post_processing(batched=True) for batch-N")
        out = _post(output["protos"].float(), output["cls_pred"].float(),
                    output["box_pred"].float(), ins_coef, grasp_coef.float(),
                    anchors=anchors_t.to(ins_coef.device), **kw)
        if batched:
            return out
        return {k: tuple(m[0] for m in v) if isinstance(v, tuple) else v[0]
                for k, v in out.items()}

    return post
