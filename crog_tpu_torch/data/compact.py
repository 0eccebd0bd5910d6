"""Compact uint8 wire format, unpacked on the device.

Counterpart of crog_tpu/data/compact.py.  Every CROG input is exactly
representable as uint8 until its last conversions (the image is warped as
uint8, the grasp maps leave ``GraspTransforms.generate_masks`` as uint8,
``ang`` in integer degrees), so the host ships ``img_u8`` [B,S,S,3] and
``planes_u8`` [B,S,S,{1,4}] (mask, or mask/qua/ang/wid) and the /255, CLIP
normalization, degrees -> radians and sin/cos(2 theta) run on the card.
Each conversion is a gather from a 256-entry table built on the host with
the legacy path's own numpy expressions, so the result is bit-equal to the
legacy host pipeline.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from crog_tpu_torch.data.ocid_vlg import CLIP_MEAN, CLIP_STD

COMPACT_KEYS = ("img_u8", "planes_u8")  # planes: mask, qua, ang, wid


def _tables() -> Dict[str, np.ndarray]:
    """The 256-entry conversion tables, with the exact host operations of
    ``ocid_vlg.preprocess`` (same order, same dtypes)."""
    v = np.arange(256, dtype=np.uint8)
    over255 = v.astype(np.float32) / 255.0
    img = np.stack([(over255 - CLIP_MEAN[c]) / CLIP_STD[c] for c in range(3)])
    ang_rad = v.astype(np.float32) * np.pi / 180.0
    return {"over255": over255, "img": img, "ang": ang_rad,
            "sin": np.sin(2.0 * ang_rad), "cos": np.cos(2.0 * ang_rad)}


_TAB = _tables()


@lru_cache(maxsize=None)
def table(name: str, device: torch.device) -> torch.Tensor:
    """Table ``name`` as a tensor on ``device`` (copied there once)."""
    return torch.from_numpy(_TAB[name]).to(device)


def normalize_image(img8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] -> CLIP-normalized f32 through the per-channel table."""
    tab = table("img", img8.device)
    idx = img8.long()
    return torch.stack([tab[c][idx[..., c]] for c in range(3)], dim=-1)


def is_compact(batch: Dict) -> bool:
    return "img_u8" in batch


def unpack_compact_host(batch: Dict) -> Dict:
    """Numpy twin of ``unpack_compact``: identical tables, identical values."""
    if not is_compact(batch):
        return batch
    img8 = np.asarray(batch["img_u8"])
    planes = np.asarray(batch["planes_u8"])
    out = {k: v for k, v in batch.items() if k not in COMPACT_KEYS}
    out["img"] = np.stack([_TAB["img"][c][img8[..., c]] for c in range(3)], axis=-1)
    out["mask"] = _TAB["over255"][planes[..., 0]]
    if planes.shape[-1] == 4:
        ang8 = planes[..., 2]
        out["qua"] = _TAB["over255"][planes[..., 1]]
        out["wid"] = _TAB["over255"][planes[..., 3]]
        out["ang"] = _TAB["ang"][ang8]
        out["sin"] = _TAB["sin"][ang8]
        out["cos"] = _TAB["cos"][ang8]
    return out


def unpack_compact(batch: Dict) -> Dict:
    """uint8 wire batch (tensors on the device) -> the dense float batch the
    model sees, bit-equal to the legacy host conversions."""
    planes = batch["planes_u8"].long()
    over255 = table("over255", planes.device)
    out = {k: v for k, v in batch.items() if k not in COMPACT_KEYS}
    out["img"] = normalize_image(batch["img_u8"])
    out["mask"] = over255[planes[..., 0]]
    if planes.shape[-1] == 4:
        ang8 = planes[..., 2]
        out["qua"] = over255[planes[..., 1]]
        out["wid"] = over255[planes[..., 3]]
        out["ang"] = table("ang", planes.device)[ang8]
        out["sin"] = table("sin", planes.device)[ang8]
        out["cos"] = table("cos", planes.device)[ang8]
    return out
