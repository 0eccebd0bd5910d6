"""OCID-Grasp batches for SSG.

Counterpart of crog_tpu/data/ocid_grasp.py ``collate_ssg`` (434), the legacy
(dense) collate.  The OCID-Grasp reader, its augmentor and the raw wire are
not ported: ``OCIDGraspDataset`` raises.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class OCIDGraspDataset:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the OCID-Grasp reader is not ported yet (ROADMAP queue 1); use "
            "dataset synthetic"
        )


def collate_ssg(samples: List[Dict], max_objs: int = 24) -> Dict:
    """Pad the ragged object axis to ``max_objs``: the dense ground-truth
    layout ``ssg_losses`` takes.  The semantic head's targets are built in
    the loss from the instance masks and labels."""
    b = len(samples)
    s = samples[0]["rgb"].shape[0]
    maps = lambda: np.zeros((b, max_objs, s, s), np.float32)
    out = {
        "img": np.zeros((b, s, s, 4 if "depth" in samples[0] else 3), np.float32),
        "boxes": np.zeros((b, max_objs, 4), np.float32),
        "labels": np.zeros((b, max_objs), np.int32),
        "obj_valid": np.zeros((b, max_objs), bool),
        "ins_masks": maps(),
        "grasp_qua": maps(),
        "grasp_sin": maps(),
        "grasp_cos": maps(),
        "grasp_wid": maps(),
        "ins_grasp_rects": [],
        "ori_size": np.stack([x["ori_size"] for x in samples]),
    }
    for i, d in enumerate(samples):
        out["img"][i, :, :, :3] = d["rgb"]
        if "depth" in d:
            out["img"][i, :, :, 3] = d["depth"]
        m = min(d["bboxes"].shape[0], max_objs)
        out["boxes"][i, :m] = d["bboxes"][:m, :4]
        out["labels"][i, :m] = d["labels"][:m] if len(d["labels"]) else 0
        out["obj_valid"][i, :m] = True
        out["ins_masks"][i, :m] = d["ins_masks"][:m]
        for k in ("qua", "sin", "cos", "wid"):
            out[f"grasp_{k}"][i, :m] = d["grasp_masks"][k][:m]
        out["ins_grasp_rects"].append(d.get("ins_grasp_rects", []))
    return out
