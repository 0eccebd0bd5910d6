"""OCID-VLG sample preprocessing (reference utils/dataset.py:843-914,
crog_tpu/data/ocid_vlg.py:183 ``preprocess``) in the four wire formats,
what the host ships to the card per sample:

  * ``rawlb``: the image letterboxed on the host as uint8, the mask as bits
    and the grasp rects as raster parameters; the targets are rasterized,
    blurred and warped on the card (``data/rawwire.py``).  Fewest bytes.
  * ``raw``: as rawlb with the unwarped image, warped on the card too.
  * ``compact``: the host warps everything and ships uint8 planes; the
    /255, CLIP normalization and sin/cos run on the card
    (``data/compact.py``).  Bit-exact to legacy.
  * ``legacy``: the float32 host pipeline of the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from crog_tpu_torch.ops.affine import letterbox_transform, warp_affine_np
from crog_tpu_torch.utils.tokenizer import tokenize

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

WIRE_FORMATS = ("rawlb", "raw", "compact", "legacy")


def check_wire_format(wire_format: str) -> None:
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"unknown wire_format {wire_format!r}; expected one of "
                         f"{WIRE_FORMATS}")


def wire_kwargs(wire_format: str) -> Dict:
    """The dataset arguments of a wire format: ``compact`` and ``raw``
    (True for raw, "lb" for rawlb), as crog_tpu's train_crog.py builds
    them."""
    check_wire_format(wire_format)
    return {"compact": wire_format == "compact",
            "raw": {"raw": True, "rawlb": "lb"}.get(wire_format, False)}


def preprocess(
    img, msk, grasp_masks, sentence, input_size, word_length, compact: bool = False,
    raw=False, rects=None, max_rects: int = 16, width_factor: float = 100.0,
) -> Dict:
    """Letterbox warp + normalize.  Every plane is uint8 until the final
    conversions (img is warped as uint8 with the cv2-parity kernel; the
    grasp maps come out of ``generate_masks`` as uint8, including ``ang``
    which holds integer degrees).

    ``raw`` (True, or "lb" to letterbox the image here) ships the unwarped
    planes and the raster parameters of ``rects`` instead
    (``data/rawwire.py``); ``compact`` ships the warped uint8 planes as
    ``img_u8`` and ``planes_u8`` (mask, qua, ang, wid) (``data/compact.py``);
    otherwise the legacy float32 arrays."""
    ins_mask = (
        (msk.astype(np.float64) * 255).astype(np.uint8) if msk.max() <= 1.0
        else msk
    )
    ori_size = img.shape[:2]
    mat, mat_inv = letterbox_transform(ori_size, input_size)
    border = tuple((CLIP_MEAN * 255).tolist())
    out = {
        "word": tokenize(sentence, word_length, True)[0],
        "inverse": mat_inv.astype(np.float32),
        "ori_size": np.asarray(ori_size, np.int32),
    }
    if raw:
        from crog_tpu_torch.data.rawwire import pack_mask_bits, pack_raster_params

        out["raw_mask_bits"] = pack_mask_bits(ins_mask)
        if raw == "lb":
            if ori_size[1] % 8:
                raise ValueError(
                    f"the rawlb wire reads the source frame off the mask bit "
                    f"plane; width {ori_size[1]} is not a multiple of 8")
            out["lb_img_u8"] = warp_affine_np(img, mat, input_size, "cubic",
                                              border_value=border)
        else:
            out["raw_img_u8"] = np.ascontiguousarray(img)
        if rects is not None:
            out["rect_corners"], out["rect_vals"] = pack_raster_params(
                np.asarray(rects), max_rects, width_factor)
        return out
    img_w = warp_affine_np(img, mat, input_size, "cubic", border_value=border)
    planes = [ins_mask]
    if grasp_masks is not None:
        planes += [grasp_masks["qua"], grasp_masks["ang"], grasp_masks["wid"]]
    planes_w = warp_affine_np(np.stack(planes, axis=-1), mat, input_size, "linear")
    if compact:
        out["img_u8"] = img_w
        out["planes_u8"] = planes_w
        return out
    img_f = img_w.astype(np.float32) / 255.0
    out["img"] = (img_f - CLIP_MEAN) / CLIP_STD  # HWC fp32
    out["mask"] = planes_w[..., 0].astype(np.float32) / 255.0
    if grasp_masks is not None:
        ang_rad = planes_w[..., 2].astype(np.float32) * np.pi / 180.0
        out.update(
            qua=planes_w[..., 1].astype(np.float32) / 255.0,
            wid=planes_w[..., 3].astype(np.float32) / 255.0,
            ang=ang_rad,
            sin=np.sin(2.0 * ang_rad),
            cos=np.cos(2.0 * ang_rad),
        )
    return out
