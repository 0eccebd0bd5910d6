"""OCID-VLG sample preprocessing (reference utils/dataset.py:843-914).

Only the legacy wire format is ported: the host letterbox-warps the image
and the target planes and ships float32 arrays.  The compact, raw and rawlb
formats wait for their own slice of the port (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from crog_tpu_torch.ops.affine import letterbox_transform, warp_affine_np
from crog_tpu_torch.utils.tokenizer import tokenize

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

WIRE_FORMATS_TO_PORT = ("compact", "raw", "rawlb")


def check_wire_format(wire_format: str) -> None:
    """Raise for a wire format the port does not implement yet."""
    if wire_format in WIRE_FORMATS_TO_PORT:
        raise NotImplementedError(
            f"wire_format {wire_format!r} is not ported yet (ROADMAP queue 1, "
            "item 4: raw-wire device unpack and input pipeline); use "
            "--opts wire_format legacy"
        )
    if wire_format != "legacy":
        raise ValueError(f"unknown wire_format {wire_format!r}")


def preprocess(
    img, msk, grasp_masks, sentence, input_size, word_length
) -> Dict:
    """Letterbox warp + normalize, the legacy branch of the reference's
    preprocessing: every plane is uint8 until the final conversions (img is
    warped as uint8 with the cv2-parity kernel; the grasp maps come out of
    ``generate_masks`` as uint8, including ``ang`` which holds integer
    degrees)."""
    ins_mask = (
        (msk.astype(np.float64) * 255).astype(np.uint8) if msk.max() <= 1.0
        else msk
    )
    ori_size = img.shape[:2]
    mat, mat_inv = letterbox_transform(ori_size, input_size)
    border = tuple((CLIP_MEAN * 255).tolist())
    img_w = warp_affine_np(img, mat, input_size, "cubic", border_value=border)
    planes = [ins_mask]
    if grasp_masks is not None:
        planes += [grasp_masks["qua"], grasp_masks["ang"], grasp_masks["wid"]]
    planes_w = warp_affine_np(np.stack(planes, axis=-1), mat, input_size, "linear")
    img_f = img_w.astype(np.float32) / 255.0
    out = {
        "word": tokenize(sentence, word_length, True)[0],
        "inverse": mat_inv.astype(np.float32),
        "ori_size": np.asarray(ori_size, np.int32),
        "img": (img_f - CLIP_MEAN) / CLIP_STD,  # HWC fp32
        "mask": planes_w[..., 0].astype(np.float32) / 255.0,
    }
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
