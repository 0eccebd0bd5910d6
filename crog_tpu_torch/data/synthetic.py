"""Synthetic OCID-VLG-style dataset.

Generates deterministic cluttered scenes (colored rectangles on a table
background) with referring expressions and grasp rectangles, flowing through
the same GraspTransforms + letterbox preprocessing as the real dataset, so
the eval path runs without the OCID-VLG download.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from crog_tpu_torch.data.grasp_transforms import GraspTransforms
from crog_tpu_torch.data.ocid_vlg import preprocess
from crog_tpu_torch.ops.rects import box_points, polygon_mask

_COLORS = {
    "red": (200, 40, 40),
    "green": (40, 170, 60),
    "blue": (40, 70, 200),
    "yellow": (210, 200, 40),
    "white": (230, 230, 230),
}
_SHAPES = ["box", "can", "ball", "banana", "bowl"]


class SyntheticOCIDVLG:
    def __init__(
        self,
        num_samples: int = 256,
        split: str = "train",
        input_size: int = 416,
        word_length: int = 17,
        ori_hw=(480, 640),
        seed: int = 0,
        compact: bool = False,
        raw=False,
        max_rects: int = 16,
    ):
        """``compact`` and ``raw`` (True, or "lb") pick the wire format
        (``ocid_vlg.preprocess``); ``max_rects`` bounds the raw wire's
        grasp rects per sample."""
        self.compact = compact
        self.raw = raw
        self.max_rects = max_rects
        self.num_samples = num_samples
        self.split = split
        self.input_size = (input_size, input_size)
        self.word_length = word_length
        self.ori_h, self.ori_w = ori_hw
        self.max_ori_size = tuple(ori_hw)
        self.seed = seed + {"train": 0, "val": 10_000, "test": 20_000}.get(
            split, 0
        )
        self.transform_grasp = GraspTransforms(
            width=self.ori_w, height=self.ori_h
        )

    def __len__(self):
        return self.num_samples

    def _scene(self, n: int):
        rng = np.random.RandomState(self.seed + n)
        img = np.full(
            (self.ori_h, self.ori_w, 3), rng.randint(90, 130), np.uint8
        )
        img = (img + rng.randint(-8, 8, img.shape)).clip(0, 255).astype(np.uint8)
        num_obj = rng.randint(2, 5)
        objs = []
        for i in range(num_obj):
            color = list(_COLORS)[rng.randint(len(_COLORS))]
            shape = _SHAPES[rng.randint(len(_SHAPES))]
            cx = rng.uniform(100, self.ori_w - 100)
            cy = rng.uniform(90, self.ori_h - 90)
            w = rng.uniform(40, 110)
            h = rng.uniform(30, 80)
            theta = rng.uniform(-85, 85)
            corners = box_points(((cx, cy), (w, h), theta))
            mask = polygon_mask(
                corners[:, 1], corners[:, 0], (self.ori_h, self.ori_w)
            )
            img[mask] = _COLORS[color]
            objs.append(dict(
                color=color, shape=shape, cx=cx, cy=cy, w=w, h=h, theta=theta,
                mask=mask,
            ))
        tgt = rng.randint(num_obj)
        o = objs[tgt]
        sent = f"pick up the {o['color']} {o['shape']}"
        # grasps across the object center, 4-point rects (reference format)
        grasps_pts = []
        for k in range(rng.randint(1, 4)):
            gw = o["h"] * 0.9
            gh = 20.0
            ang = -o["theta"]
            pts = box_points(((o["cx"], o["cy"]), (gw, gh), ang))
            grasps_pts.append(pts)
        return img, objs[tgt]["mask"], np.asarray(grasps_pts), sent

    def __getitem__(self, n: int) -> Dict:
        img, msk, grasp_pts, sent = self._scene(n)
        grasps = self.transform_grasp(grasp_pts.astype(np.float64), 1)
        # the raw wires rasterize the grasp maps on the card
        grasp_masks = None if self.raw else self.transform_grasp.generate_masks(grasps)
        sample = preprocess(
            img, msk, grasp_masks, sent, self.input_size, self.word_length,
            self.compact, self.raw, grasps, self.max_rects,
            self.transform_grasp.width_factor,
        )
        sample.update(
            grasps=grasps,
            sentence=sent,
            sent_id=n,
            scene_id=f"synthetic,{n:06d}.png",
            target="synthetic",
        )
        return sample
