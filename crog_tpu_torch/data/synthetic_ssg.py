"""Synthetic OCID-Grasp-style scenes for SSG, no download needed.

Counterpart of crog_tpu/data/synthetic_ssg.py ``SyntheticOCIDGrasp`` (15):
deterministic scenes (a seeded ``np.random.RandomState`` per sample) of 2-4
rotated-rectangle objects with per-instance masks, boxes, labels, grasp
rects and grasp maps, in the per-sample layout that
``data/ocid_grasp.py:collate_ssg`` batches.  The frame-level synthetic of
the JAX package (``SyntheticOCIDGraspFrames``) needs the augmentor and the
raw wire and is not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from crog_tpu_torch.data.grasp_transforms import GraspTransforms
from crog_tpu_torch.ops.rects import box_points, polygon_mask


class SyntheticOCIDGrasp:
    def __init__(self, num_samples: int = 64, split: str = "training_0",
                 img_size: int = 544, num_classes: int = 32, with_depth: bool = True,
                 seed: int = 0):
        self.num_samples = num_samples
        self.img_size = img_size
        self.num_classes = num_classes
        self.with_depth = with_depth
        self.seed = seed + (0 if split == "training_0" else 50_000)
        self.gt = GraspTransforms(width=img_size, height=img_size)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, n: int) -> Dict:
        s = self.img_size
        rng = np.random.RandomState(self.seed + n)
        img = rng.uniform(0.3, 0.5, (s, s, 3)).astype(np.float32)
        depth = rng.uniform(0.4, 0.6, (s, s)).astype(np.float32)
        num_obj = rng.randint(2, 5)
        boxes, labels, masks = [], [], []
        grasp_rects, qua_l, ang_l, wid_l = [], [], [], []
        sem = np.zeros((s, s), np.float32)
        for _ in range(num_obj):
            cls = rng.randint(1, self.num_classes)
            cx, cy = rng.uniform(0.2 * s, 0.8 * s, 2)
            w, h = rng.uniform(0.08 * s, 0.25 * s, 2)
            theta = rng.uniform(-80, 80)
            corners = box_points(((cx, cy), (w, h), theta))
            mask = polygon_mask(corners[:, 1], corners[:, 0], (s, s))
            img[mask] = rng.rand(3)
            sem[mask] = cls
            ys, xs = np.nonzero(mask)
            if len(ys) == 0:
                continue
            boxes.append([xs.min() / s, ys.min() / s, (xs.max() + 1) / s,
                          (ys.max() + 1) / s])
            labels.append(cls)
            masks.append(mask.astype(np.float32))
            rects = np.asarray([[cx, cy, min(h * 0.9, 99.0), 20.0, -theta, cls]],
                               np.float32)
            grasp_rects.append(rects)
            gm = self.gt.generate_masks(rects)
            qua_l.append(gm["qua"] / 255.0)
            ang_l.append(gm["ang"].astype(np.float32) * np.pi / 180.0)
            wid_l.append(gm["wid"] / 255.0)
        ang = np.asarray(ang_l, np.float32)
        return {
            "rgb": img,
            "depth": depth,
            "ori_size": np.asarray([s, s], np.int32),
            "bboxes": np.concatenate([np.asarray(boxes, np.float32),
                                      np.asarray(labels, np.float32)[:, None]], axis=1),
            "labels": np.asarray(labels, np.int32),
            "ins_masks": np.asarray(masks, np.float32),
            "sem_mask": sem,
            "ins_grasp_rects": grasp_rects,
            "grasp_masks": {
                "qua": np.asarray(qua_l, np.float32),
                "ang": ang,
                "wid": np.asarray(wid_l, np.float32),
                "sin": np.sin(2 * ang),
                "cos": np.cos(2 * ang),
            },
        }
