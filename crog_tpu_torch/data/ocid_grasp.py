"""OCID-Grasp for SSG: the on-disk reader, its augmentor and the legacy
(dense) collate.

Counterpart of crog_tpu/data/ocid_grasp.py.  Per scene: RGB (kept in BGR
order), inverted-normalized depth (1 - d/max), the instance decomposition
of the semantic mask into per-instance masks, boxes and labels, the
per-class grasp rect files, and instance <-> grasp matching (a grasp whose
centre lies inside the instance mask).  Then either the legacy host path
(``finalize_legacy``: per-instance grasp-map raster, ``DataAugmentor``,
sin/cos of the degree-unit angle canvas) or the raw wire
(``data/ssg_rawwire.py:pack_ssg_raw``: the augmentation drawn here and
replayed on the device).

``DataAugmentor`` draws from the ``random.Random`` it is given, in the
JAX package's call order: a ``random.Random(s)`` gives the stream that the
JAX package's global ``random.seed(s)`` gives, so both packages draw the
same parameters for the same seed.  The host arithmetic is numpy and
bit-identical to the JAX package's.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from crog_tpu_torch.data.grasp_transforms import GraspTransforms
from crog_tpu_torch.data.ocid_classes import CNAMES
from crog_tpu_torch.data.ocid_vlg import CLIP_MEAN
from crog_tpu_torch.data.ssg_rawwire import pack_ssg_raw
from crog_tpu_torch.ops.resize import resize_np

OCID_HW = (480, 640)  # the camera frame of every OCID scene


def instance_decomposition(sem_mask: np.ndarray, ins_mask: np.ndarray):
    """Per-instance (bbox [M, 5] x1,y1,x2,y2,cls, label [M], mask [M, H, W])
    from the semantic and instance id masks; OCID's instance ids are unique
    per instance, so each region is one (class, id) pair."""
    labels: List[int] = []
    bboxes: List[List[float]] = []
    masks: List[np.ndarray] = []
    for cls_id in np.unique(sem_mask):
        if cls_id == 0:
            continue
        cls_ins = np.where(sem_mask == cls_id, ins_mask, 0)
        for ins_id in np.unique(cls_ins):
            if ins_id == 0:
                continue
            m = cls_ins == ins_id
            ys, xs = np.nonzero(m)
            if len(ys) == 0:
                continue
            labels.append(int(cls_id))
            # regionprops' bbox (minr, minc, maxr+1, maxc+1) as x1,y1,x2,y2
            bboxes.append([float(xs.min()), float(ys.min()), float(xs.max() + 1),
                           float(ys.max() + 1), float(cls_id)])
            masks.append(m.astype(np.float32))
    return (np.asarray(bboxes, np.float32).reshape(-1, 5),
            np.asarray(labels, np.int32),
            np.asarray(masks, np.float32).reshape(-1, *sem_mask.shape))


def parse_grasp_file(path: str, cls_id: int) -> List[List[float]]:
    """A 4-corner-point text file (one "x y" pair per line) -> (cx, cy, w,
    h, theta, cls) rects."""
    rects = []
    pts: List[tuple] = []
    with open(path) as f:
        for line in f:
            x, y = line.strip().split(" ")
            pts.append((float(x), float(y)))
            if len(pts) == 4:
                p1, p2, p3, p4 = pts
                cx = (p1[0] + p3[0]) / 2
                cy = (p1[1] + p3[1]) / 2
                w = np.hypot(p1[0] - p4[0], p1[1] - p4[1])
                h = np.hypot(p1[0] - p2[0], p1[1] - p2[1])
                theta = np.arctan2(p4[0] - p1[0], p4[1] - p1[1]) * 180 / np.pi
                theta = theta - 90 if theta > 0 else theta + 90
                rects.append([cx, cy, w, h, theta, int(cls_id)])
                pts = []
    return rects


def _bgr_hsv(img: np.ndarray) -> np.ndarray:
    """cv2's float32 BGR -> HSV: H in [0, 360), S in [0, 1], V as given."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    h = np.zeros_like(maxc)
    mask = delta > 0
    rc = np.where(mask, (maxc - r) / np.maximum(delta, 1e-12), 0)
    gc = np.where(mask, (maxc - g) / np.maximum(delta, 1e-12), 0)
    bc = np.where(mask, (maxc - b) / np.maximum(delta, 1e-12), 0)
    h = np.where(maxc == r, bc - gc, h)
    h = np.where((maxc == g) & (maxc != r), 2.0 + rc - bc, h)
    h = np.where((maxc == b) & (maxc != r) & (maxc != g), 4.0 + gc - rc, h)
    h = (h * 60.0) % 360.0
    return np.stack([h, s, v], axis=-1)


def _hsv_bgr(img: np.ndarray) -> np.ndarray:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    h = (h % 360.0) / 60.0
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([b, g, r], axis=-1)


class DataAugmentor:
    """Photometric distortion and mirror (train), pad to square, resize.

    ``draw`` takes every random parameter from ``rng`` in the reference's
    call order (coins, conditional uniforms, mirror, pad offset); ``apply``
    is deterministic given them, so the raw wire draws on the host and
    replays the same augmentation on the device
    (``data/ssg_rawwire.py:unpack_ssg_raw``).  ``__call__`` is
    ``apply(d, draw())``.
    """

    def __init__(self, img_size: int, mode: str = "train",
                 rng: Optional[random.Random] = None):
        self.img_size = img_size
        self.mode = mode
        self.mean = CLIP_MEAN
        self.rng = rng if rng is not None else random.Random()

    def draw(self, h: int, w: int) -> Dict:
        p = {"b_delta": 0.0, "c_factor": 1.0, "h1": 0.0, "h2": 0.0,
             "mirror": 0, "pad_y0": 0, "pad_x0": 0}
        if self.mode == "train":
            rng = self.rng
            if rng.randint(0, 1):
                p["b_delta"] = rng.uniform(-32, 32)
            if rng.randint(0, 1):
                p["c_factor"] = rng.uniform(0.7, 1.3)
            p["h1"] = rng.uniform(-15, 15)
            p["h2"] = rng.uniform(-15, 15)
            p["mirror"] = rng.randint(0, 1)
            if h < w:
                p["pad_y0"] = rng.randint(0, w - h)
            elif h > w:
                p["pad_x0"] = rng.randint(0, h - w)
        return p

    def _photometric_distort(self, d: Dict, p: Dict):
        img = d["rgb"].astype(np.float32)
        img = np.clip(img + p["b_delta"], 0.0, 255.0)
        img = np.clip(img * p["c_factor"], 0.0, 255.0)
        hsv = _bgr_hsv(img)
        # kept as the reference does it: its saturation step shifts channel
        # 0, so the hue moves twice and the saturation never does; the
        # trained models saw exactly this distribution
        hsv[..., 0] = (hsv[..., 0] + p["h1"]) % 360.0
        hsv[..., 0] = (hsv[..., 0] + p["h2"]) % 360.0
        d["rgb"] = np.clip(_hsv_bgr(hsv), 0.0, 255.0)

    def _mirror(self, d: Dict, p: Dict):
        if p["mirror"]:
            width = d["rgb"].shape[1]
            d["rgb"] = d["rgb"][:, ::-1]
            d["depth"] = d["depth"][:, ::-1]
            d["ins_masks"] = d["ins_masks"][:, :, ::-1]
            for k in ("qua", "ang", "wid"):
                d["grasp_masks"][k] = d["grasp_masks"][k][:, :, ::-1]
            b = d["bboxes"][:, :4].copy()
            d["bboxes"][:, 0] = width - b[:, 2]
            d["bboxes"][:, 2] = width - b[:, 0]

    def _pad_to_square(self, d: Dict, p: Dict):
        h, w = d["rgb"].shape[:2]
        if h == w:
            return
        size = max(h, w)
        y0, x0 = p["pad_y0"], p["pad_x0"]
        pad_img = np.zeros((size, size, 3), np.float32)
        pad_img[:, :] = self.mean  # the 0-1 mean on a 0-255 image, as the reference pads
        pad_img[y0:y0 + h, x0:x0 + w] = d["rgb"]
        d["rgb"] = pad_img

        def pad(x):
            out = np.zeros(x.shape[:-2] + (size, size), np.float32)
            out[..., y0:y0 + h, x0:x0 + w] = x
            return out

        d["depth"] = pad(d["depth"])
        d["ins_masks"] = pad(d["ins_masks"])
        for k in ("qua", "ang", "wid"):
            d["grasp_masks"][k] = pad(d["grasp_masks"][k])
        d["bboxes"][:, [0, 2]] += x0
        d["bboxes"][:, [1, 3]] += y0

    def _resize(self, d: Dict):
        s = self.img_size
        scale = s / d["rgb"].shape[0]
        d["rgb"] = resize_np(d["rgb"], (s, s))
        d["depth"] = resize_np(d["depth"], (s, s))

        def rs(stack):
            return np.stack([resize_np(m, (s, s)) for m in stack]) if len(stack) else stack

        d["ins_masks"] = rs(d["ins_masks"])
        for k in ("qua", "ang", "wid"):
            d["grasp_masks"][k] = rs(d["grasp_masks"][k])
        d["bboxes"][:, :4] *= scale

    def apply(self, d: Dict, p: Dict):
        if self.mode == "train":
            self._photometric_distort(d, p)
            self._mirror(d, p)
        self._pad_to_square(d, p)
        self._resize(d)
        h, w = d["rgb"].shape[:2]
        d["bboxes"][:, [0, 2]] /= w
        d["bboxes"][:, [1, 3]] /= h
        # /255 then BGR -> RGB, in HWC
        d["rgb"] = np.ascontiguousarray(d["rgb"].astype(np.float32)[:, :, ::-1] / 255.0)
        return d

    def __call__(self, d: Dict):
        return self.apply(d, self.draw(*d["rgb"].shape[:2]))


def finalize_legacy(pre: Dict, augmentor: DataAugmentor,
                    grasp_transforms: GraspTransforms) -> Dict:
    """A pre-augment sample -> the dense legacy train sample: per-instance
    grasp maps rasterized and blurred on the host, the augmentor, then
    sin/cos of the degree-unit angle canvas (a reference quirk, kept)."""
    d = dict(pre)
    stacks = [grasp_transforms.generate_masks(r) for r in pre["ins_grasp_rects"]]
    hw = pre["rgb"].shape[:2]
    d["grasp_masks"] = {
        "qua": np.asarray([g["qua"] / 255.0 for g in stacks]).reshape(-1, *hw),
        "ang": np.asarray([g["ang"] for g in stacks], np.float32).reshape(-1, *hw),
        "wid": np.asarray([g["wid"] / 255.0 for g in stacks]).reshape(-1, *hw),
    }
    augmentor(d)
    d["grasp_masks"]["sin"] = np.sin(2 * d["grasp_masks"]["ang"])
    d["grasp_masks"]["cos"] = np.cos(2 * d["grasp_masks"]["ang"])
    return d


class OCIDGraspDataset:
    """An OCID-Grasp tree: ``data_split/<split>.txt`` lists "scene,image"
    lines; each scene holds rgb/, depth/, seg_mask_labeled_combi/,
    seg_mask_instances_combi/ and Annotations_per_class/<stem>/<cls>/.
    ``raw`` selects the raw wire (``pack_ssg_raw``) over the legacy sample.
    ``rng`` is the augmentor's random stream (train split only)."""

    ori_hw = OCID_HW

    def __init__(self, root_dir: str, split: str, img_size: int = 544,
                 depth_factor: float = 1000.0, with_depth: bool = True,
                 with_grasp_masks: bool = True, raw: bool = False, max_objs: int = 24,
                 max_rects: int = 16, rng: Optional[random.Random] = None):
        self.root_dir = root_dir
        self.split = split
        self.img_size = img_size
        self.depth_factor = depth_factor
        self.with_depth = with_depth
        self.with_grasp_masks = with_grasp_masks
        self.raw = raw
        self.max_objs = max_objs
        self.max_rects = max_rects
        self.grasp_transforms = GraspTransforms()
        self.num_classes = len(CNAMES)
        self.augmentor = DataAugmentor(
            img_size, "train" if split == "training_0" else "test", rng)
        with open(os.path.join(root_dir, "data_split", split + ".txt")) as f:
            self.meta = [x.strip().split(",") for x in f.readlines()]

    def __len__(self):
        return len(self.meta)

    def load_pre(self, index: int) -> Dict:
        """The scene before augmentation: BGR f32 0-255 rgb, depth, the
        kept instances (those with a matched grasp) and their rects."""
        scene_id, img_f = self.meta[index]
        base = os.path.join(self.root_dir, scene_id)
        rgb = np.asarray(Image.open(os.path.join(base, "rgb", img_f)).convert("RGB")
                         )[..., ::-1].astype(np.float32)
        d: Dict = {"scene_id": scene_id, "img_f": img_f, "rgb": rgb,
                   "ori_size": np.asarray(rgb.shape[:2], np.int32)}
        depth = np.asarray(Image.open(os.path.join(base, "depth", img_f))).astype(
            np.float32) / self.depth_factor
        d["depth"] = 1.0 - depth / depth.max()
        sem = np.asarray(Image.open(os.path.join(base, "seg_mask_labeled_combi", img_f)))
        ins = np.asarray(Image.open(os.path.join(base, "seg_mask_instances_combi", img_f)))
        bboxes, labels, masks = instance_decomposition(sem, ins)
        d["sem_mask"] = sem.astype(np.float32)

        anno = os.path.join(base, "Annotations_per_class", img_f[:-4])
        raw_rects: List[List[float]] = []
        if os.path.isdir(anno):
            for cls_id in os.listdir(anno):
                gp = os.path.join(anno, cls_id, img_f[:-4] + ".txt")
                if os.path.exists(gp):
                    raw_rects += parse_grasp_file(gp, int(cls_id))

        keep_boxes, keep_labels, keep_masks, grasp_rects = [], [], [], []
        for box, mask, label in zip(bboxes, masks, labels):
            matched = [r for r in raw_rects
                       if int(r[-1]) == int(box[4]) and mask[int(r[1]), int(r[0])] > 0]
            if matched:
                keep_boxes.append(box)
                keep_labels.append(label)
                keep_masks.append(mask)
                grasp_rects.append(np.asarray(matched, np.float32))
        d["bboxes"] = np.asarray(keep_boxes, np.float32).reshape(-1, 5)
        d["labels"] = np.asarray(keep_labels, np.int32)
        d["ins_masks"] = np.asarray(keep_masks, np.float32).reshape(-1, *rgb.shape[:2])
        d["ins_grasp_rects"] = grasp_rects
        return d

    def __getitem__(self, index: int) -> Dict:
        pre = self.load_pre(index)
        if self.raw:
            return pack_ssg_raw(pre, self.augmentor, self.max_objs, self.max_rects)
        return finalize_legacy(pre, self.augmentor, self.grasp_transforms)

    def visualization(self, index: int, tgt_dir: str):
        """Ground-truth figures of one legacy sample under ``tgt_dir``: the
        raw data (RGB, depth, semantic mask) and per instance its mask and
        grasp maps.  Needs matplotlib."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        d = finalize_legacy(self.load_pre(index), self.augmentor, self.grasp_transforms)
        os.makedirs(tgt_dir, exist_ok=True)
        fig = plt.figure(figsize=(25, 10))
        for i, (data, title, kw) in enumerate(
                ((np.clip(d["rgb"], 0.0, 1.0), "RGB", {}),
                 (d["depth"], "Depth", dict(cmap="gray")),
                 (d["sem_mask"], "Segm Mask", {})), start=1):
            ax = fig.add_subplot(1, 3, i)
            ax.imshow(data, **kw)
            ax.set_title(title)
            ax.axis("off")
        plt.tight_layout()
        plt.savefig(os.path.join(tgt_dir, "raw-data.png"))
        plt.close(fig)

        panels = (("ins", {}), ("qua", dict(cmap="jet", vmin=0, vmax=1)),
                  ("sin", dict(cmap="rainbow", vmin=-1, vmax=1)),
                  ("cos", dict(cmap="rainbow", vmin=-1, vmax=1)),
                  ("wid", dict(cmap="jet", vmin=0, vmax=1)))
        for i in range(d["ins_masks"].shape[0]):
            fig = plt.figure(figsize=(20, 2))
            maps = {"ins": d["ins_masks"][i],
                    **{k: d["grasp_masks"][k][i] for k in ("qua", "sin", "cos", "wid")}}
            for j, (key, kw) in enumerate(panels, start=1):
                ax = fig.add_subplot(1, 5, j)
                ax.imshow(maps[key], **kw)
                ax.set_title(key)
                ax.axis("off")
            plt.tight_layout()
            plt.savefig(os.path.join(tgt_dir, f"instance-{i}.png"))
            plt.close(fig)
        return tgt_dir


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
