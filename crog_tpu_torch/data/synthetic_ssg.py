"""Synthetic OCID-Grasp-style scenes for SSG, no download needed.

Counterpart of crog_tpu/data/synthetic_ssg.py ``SyntheticOCIDGrasp`` (15):
deterministic scenes (a seeded ``np.random.RandomState`` per sample) of 2-4
rotated-rectangle objects with per-instance masks, boxes, labels, grasp
rects and grasp maps, in the per-sample layout that
``data/ocid_grasp.py:collate_ssg`` batches; and ``SyntheticOCIDGraspFrames``
(93): scenes at OCID's camera frame (480 x 640) that go through the same
host pipeline as the on-disk reader, the legacy one or the raw wire.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

import numpy as np

from crog_tpu_torch.data.grasp_transforms import GraspTransforms
from crog_tpu_torch.data.ocid_grasp import DataAugmentor, finalize_legacy
from crog_tpu_torch.data.ssg_rawwire import pack_ssg_raw
from crog_tpu_torch.ops.rects import box_points, polygon_mask


class SyntheticOCIDGrasp:
    """Scenes made directly at ``img_size``^2 in the collate layout: its
    ground-truth rects are in that frame."""

    def __init__(self, num_samples: int = 64, split: str = "training_0",
                 img_size: int = 544, num_classes: int = 32, with_depth: bool = True,
                 seed: int = 0):
        self.num_samples = num_samples
        self.img_size = img_size
        self.num_classes = num_classes
        self.with_depth = with_depth
        self.seed = seed + (0 if split == "training_0" else 50_000)
        self.gt = GraspTransforms(width=img_size, height=img_size)
        self.ori_hw = (img_size, img_size)

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


class SyntheticOCIDGraspFrames:
    """OCID-Grasp-layout scenes at the camera frame size ``frame_hw`` that go
    through the on-disk reader's host pipeline: per-instance raster and
    ``DataAugmentor`` (legacy), or ``pack_ssg_raw`` (``raw``).  Each
    scene's draws come from a seeded ``np.random.RandomState``, its object
    count from ``objects`` ([low, high), the reference's 2-4 by default);
    the augmentation from ``rng``."""

    def __init__(self, num_samples: int = 64, split: str = "training_0",
                 img_size: int = 544, frame_hw=(480, 640), num_classes: int = 32,
                 seed: int = 0, raw: bool = False, max_objs: int = 24,
                 max_rects: int = 16, rng: Optional[random.Random] = None,
                 objects: Tuple[int, int] = (2, 5)):
        self.num_samples = num_samples
        self.img_size = img_size
        self.frame_hw = tuple(frame_hw)
        self.ori_hw = self.frame_hw  # the ground-truth rects' frame
        self.num_classes = num_classes
        self.seed = seed + (0 if split == "training_0" else 50_000)
        self.raw = raw
        self.max_objs = max_objs
        self.max_rects = max_rects
        self.objects = objects
        self.grasp_transforms = GraspTransforms(width=frame_hw[1], height=frame_hw[0])
        self.augmentor = DataAugmentor(
            img_size, "train" if split == "training_0" else "test", rng)

    def __len__(self):
        return self.num_samples

    def load_pre(self, n: int) -> Dict:
        h0, w0 = self.frame_hw
        rng = np.random.RandomState(self.seed + n)
        # BGR 0-255 with integer values, as the reader's uint8 PNG decode
        rgb = np.full((h0, w0, 3), float(rng.randint(90, 130)), np.float32)
        depth = rng.uniform(0.3, 0.7, (h0, w0)).astype(np.float32)
        num_obj = rng.randint(*self.objects)
        boxes, labels, masks, grasp_rects = [], [], [], []
        for _ in range(num_obj):
            cls = rng.randint(1, self.num_classes)
            cx = rng.uniform(0.2 * w0, 0.8 * w0)
            cy = rng.uniform(0.2 * h0, 0.8 * h0)
            w, h = rng.uniform(40, 110), rng.uniform(30, 80)
            theta = rng.uniform(-80, 80)
            corners = box_points(((cx, cy), (w, h), theta))
            mask = polygon_mask(corners[:, 1], corners[:, 0], (h0, w0))
            if not mask.any():
                continue
            rgb[mask] = rng.randint(0, 256, 3).astype(np.float32)
            ys, xs = np.nonzero(mask)
            boxes.append([float(xs.min()), float(ys.min()), float(xs.max() + 1),
                          float(ys.max() + 1), float(cls)])
            labels.append(cls)
            masks.append(mask.astype(np.float32))
            rects = [[cx, cy, min(h * 0.9, 99.0), 20.0, float(rng.uniform(-85, 85)),
                      float(cls)] for _ in range(rng.randint(1, 4))]
            grasp_rects.append(np.asarray(rects, np.float32))
        return {
            "rgb": rgb,
            "depth": depth,
            "ori_size": np.asarray([h0, w0], np.int32),
            "bboxes": np.asarray(boxes, np.float32).reshape(-1, 5),
            "labels": np.asarray(labels, np.int32),
            "ins_masks": np.asarray(masks, np.float32).reshape(-1, h0, w0),
            "ins_grasp_rects": grasp_rects,
        }

    def __getitem__(self, n: int) -> Dict:
        pre = self.load_pre(n)
        if self.raw:
            return pack_ssg_raw(pre, self.augmentor, self.max_objs, self.max_rects)
        return finalize_legacy(pre, self.augmentor, self.grasp_transforms)
