"""OCID-VLG: the on-disk reader ``OCIDVLGDataset`` (counterpart of
crog_tpu/data/ocid_vlg.py:33) and the sample preprocessing it shares with
the synthetic scenes (reference utils/dataset.py:843-914,
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

import json
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image

from crog_tpu_torch.data.grasp_transforms import GraspTransforms
from crog_tpu_torch.data.ocid_classes import CNAMES, SUBNAMES, SUB_TO_CLASS
from crog_tpu_torch.native import warp_affine
from crog_tpu_torch.ops.affine import letterbox_transform
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
            out["lb_img_u8"] = warp_affine(img, mat, input_size, "cubic",
                                           border_value=border)
        else:
            out["raw_img_u8"] = np.ascontiguousarray(img)
        if rects is not None:
            out["rect_corners"], out["rect_vals"] = pack_raster_params(
                np.asarray(rects), max_rects, width_factor)
        return out
    img_w = warp_affine(img, mat, input_size, "cubic", border_value=border)
    planes = [ins_mask]
    if grasp_masks is not None:
        planes += [grasp_masks["qua"], grasp_masks["ang"], grasp_masks["wid"]]
    planes_w = warp_affine(np.stack(planes, axis=-1), mat, input_size, "linear")
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


class OCIDVLGDataset:
    """An OCID-VLG tree: ``refer/<version>/<split>_expressions.json`` lists
    the referring expressions (scene "seq,image", target box x, y, w, h,
    grasp corner points, target instance id and name, sentence); each scene
    holds rgb/, depth/ and seg_mask_instances_combi/ PNGs.  Images decode
    with PIL.  ``compact`` and ``raw`` (True, or "lb") pick the wire format
    (``preprocess``)."""

    split_map = {
        "train": "train_expressions.json",
        "val": "val_expressions.json",
        "test": "test_expressions.json",
        # the reference's test configs name the test split 'val-test'
        "val-test": "test_expressions.json",
    }

    def __init__(self, root_dir: str, split: str, input_size: int = 416,
                 word_length: int = 17, with_depth: bool = True,
                 with_segm_mask: bool = True, with_grasp_masks: bool = True,
                 version: str = "multiple",
                 transform_grasp: Optional[GraspTransforms] = None,
                 compact: bool = False, raw=False, max_rects: int = 16):
        self.compact = compact
        self.raw = raw
        self.max_rects = max_rects
        self.root_dir = root_dir
        self.split = split
        self.refer_dir = os.path.join(root_dir, "refer", version)
        self.input_size = (input_size, input_size)
        self.word_length = word_length
        self.with_depth = with_depth
        self.with_segm_mask = with_segm_mask
        self.with_grasp_masks = with_grasp_masks
        self.transform_grasp = transform_grasp or GraspTransforms()
        self.class_instance_names = SUBNAMES
        self.class_names = CNAMES
        self.instance_idx_to_class_idx = SUB_TO_CLASS
        # every OCID capture is 480x640; the eval step un-warps each sample
        # inside a canvas of this size
        self.max_ori_size = (480, 640)
        self._load_split()

    def _load_split(self):
        with open(os.path.join(self.refer_dir, self.split_map[self.split])) as f:
            refer_data = json.load(f)
        self.items = []
        self.sent_to_index = {}
        for n, item in enumerate(refer_data["data"]):
            seq_path, im_name = item["image_filename"].split(",")
            self.items.append(dict(
                seq_path=seq_path, im_name=im_name, scene_id=item["image_filename"],
                bbox=item["box"], grasps=item["grasps"], objID=item["answer"],
                target=item["target"], sentence=item["question"],
                program=item.get("program"), sent_id=item["question_index"],
            ))
            self.sent_to_index[item["question_index"]] = n

    def __len__(self):
        return len(self.items)

    def _png(self, it, sub: str) -> np.ndarray:
        return np.asarray(Image.open(
            os.path.join(self.root_dir, it["seq_path"], sub, it["im_name"])))

    def _rgb(self, it) -> np.ndarray:
        p = os.path.join(self.root_dir, it["seq_path"], "rgb", it["im_name"])
        return np.asarray(Image.open(p).convert("RGB"))

    def _grasps(self, it) -> np.ndarray:
        """The item's grasps as [M, 6] (cx, cy, w, h, theta, instance)."""
        return self.transform_grasp(np.asarray(it["grasps"], np.float64),
                                    self.class_instance_names[it["target"]])

    def __getitem__(self, n: int) -> Dict:
        it = self.items[n]
        img = self._rgb(it)
        grasps = self._grasps(it)
        msk = self._png(it, "seg_mask_instances_combi") == it["objID"]
        # the raw wires rasterize the grasp maps on the card
        grasp_masks = (self.transform_grasp.generate_masks(grasps)
                       if self.with_grasp_masks and not self.raw else None)
        sample = preprocess(
            img, msk, grasp_masks, it["sentence"], self.input_size, self.word_length,
            self.compact, self.raw, grasps if self.with_grasp_masks else None,
            self.max_rects, self.transform_grasp.width_factor,
        )
        x, y, w, h = it["bbox"]
        sample.update(
            grasps=grasps, sentence=it["sentence"], target=it["target"],
            objID=it["objID"], bbox=np.asarray([x, y, x + w, y + h]),
            sent_id=it["sent_id"], scene_id=it["scene_id"],
        )
        if self.with_depth:
            sample["depth"] = self._png(it, "depth").astype(np.float32) / 1000.0
        return sample

    def get_annotated_image(self, n: int) -> np.ndarray:
        """The RGB frame with the target box (green) and the ground-truth
        grasp rects drawn."""
        from crog_tpu_torch.utils.visualization import _draw_line, draw_grasp_rects

        it = self.items[n]
        out = draw_grasp_rects(self._rgb(it), self._grasps(it))
        x, y, w, h = it["bbox"]
        for p0, p1 in (((x, y), (x + w, y)), ((x + w, y), (x + w, y + h)),
                       ((x + w, y + h), (x, y + h)), ((x, y + h), (x, y))):
            _draw_line(out, p0, p1, (0, 255, 0))
        return out

    def visualization(self, n: int, save_path: str):
        """Ground-truth figure of sample ``n`` (RGB, depth, mask, annotated
        frame, grasp maps) as ``<save_path>/sample_<n>.png``.  Needs
        matplotlib and a legacy sample."""
        from crog_tpu_torch.utils.visualization import visualize_gt_sample

        return visualize_gt_sample(self[n], os.path.join(save_path, f"sample_{n}.png"),
                                   annotated=self.get_annotated_image(n))
