"""RefOCIDGrasp, the older CROG dataset (counterpart of
crog_tpu/data/ref_ocid.py:42; reference utils/dataset.py:110-603).

``<mode>_expressions.json`` at the root maps each ref id to its class,
scene path, box and sentence.  The referred instance is the one of that
class whose bounding box overlaps the ref's box most (plain rectangle IoU:
the reference's shapely polygon IoU of axis-aligned boxes is the same
number); its grasps are the class's rects whose centre lies inside the
instance mask.  Samples are OCID-VLG's legacy float arrays
(``data/ocid_vlg.py:preprocess``).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
from PIL import Image

from crog_tpu_torch.data.grasp_transforms import GraspTransforms
from crog_tpu_torch.data.ocid_classes import CNAMES
from crog_tpu_torch.data.ocid_grasp import parse_grasp_file
from crog_tpu_torch.data.ocid_vlg import preprocess


def _rect_iou(a, b) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / union if union > 0 else 0.0


class RefOCIDGraspDataset:
    def __init__(self, root_path: str, input_size: int = 416, word_length: int = 17,
                 mode: str = "train"):
        with open(os.path.join(root_path, f"{mode}_expressions.json")) as f:
            self.meta_data = json.load(f)
        self.root_path = root_path
        self.keys = list(self.meta_data.keys())
        self.input_size = (input_size, input_size)
        self.word_length = word_length
        self.mode = mode
        self.cls_names = CNAMES
        self.transform_grasp = GraspTransforms()

    def __len__(self):
        return len(self.keys)

    def _png(self, scene_path: str, sub: str) -> np.ndarray:
        return np.asarray(Image.open(
            os.path.join(self.root_path, scene_path.replace("rgb", sub))))

    @staticmethod
    def _match_mask(bbox, ins_masks, cls_mask) -> np.ndarray:
        """The instance of the class whose bounding box best overlaps the
        ref's box (reference _match_masks_with_ref, utils/dataset.py:294-325)."""
        cls_ins = np.where(cls_mask, ins_masks, 0)
        best_iou, best_id = 0.0, 0
        for ins_id in np.unique(cls_ins):
            if ins_id == 0:
                continue
            ys, xs = np.nonzero(cls_ins == ins_id)
            iou = _rect_iou(bbox, (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1))
            if iou > best_iou:
                best_iou, best_id = iou, ins_id
        return cls_ins == best_id

    def __getitem__(self, index: int) -> Dict:
        key = self.keys[index]
        ref = self.meta_data[key]
        obj_cls = int(self.cls_names[ref["class"]])
        scene_path = ref["scene_path"]
        img = np.asarray(
            Image.open(os.path.join(self.root_path, scene_path)).convert("RGB"))
        sem = self._png(scene_path, "seg_mask_labeled_combi")
        ins = self._png(scene_path, "seg_mask_instances_combi")
        stem = os.path.basename(scene_path)[:-4]
        grasp_path = os.path.join(
            self.root_path, scene_path.replace("rgb", "Annotations_per_class")[:-4],
            str(obj_cls), stem + ".txt")
        rects = parse_grasp_file(grasp_path, obj_cls) if os.path.exists(grasp_path) else []

        bbox = ref["bbox"]
        if isinstance(bbox, str):
            # reference _load_bbox (utils/dataset.py:346-350): "[a, b, c, d]",
            # read as corner coordinates (:294-299)
            bbox = [int(v) for v in bbox.replace("[", "").replace("]", "").split(",")]
        x1, y1, x2, y2 = bbox
        mask = self._match_mask((x1, y1, x2, y2), ins, sem == obj_cls)
        grasps = np.asarray([r for r in rects if mask[int(r[1]), int(r[0])]],
                            np.float64).reshape(-1, 6)
        sample = preprocess(img, mask, self.transform_grasp.generate_masks(grasps),
                            ref["sentence"], self.input_size, self.word_length)
        sample.update(grasps=grasps, sentence=ref["sentence"], target=ref["class"],
                      bbox=np.asarray([x1, y1, x2, y2]), sent_id=key,
                      scene_id=scene_path)
        return sample
