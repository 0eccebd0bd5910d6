"""RefCOCO-family referring segmentation (counterpart of
crog_tpu/data/refcoco.py:27): the CRIS-inherited flow the reference kept
beside OCID-VLG, read from record shards (``data/shards.py``) that hold the
encoded image bytes, the mask and the sentences.  The letterbox and the
normalization are OCID-VLG's; the samples are mask-only (legacy float
arrays), for ``validate_without_grasp`` and the ``use_grasp_masks=False``
ablation.
"""

from __future__ import annotations

import io
import os
import random
from typing import Dict

import numpy as np
from PIL import Image

from crog_tpu_torch.data.ocid_vlg import CLIP_MEAN, CLIP_STD
from crog_tpu_torch.data.shards import ShardReader
from crog_tpu_torch.native import warp_affine
from crog_tpu_torch.ops.affine import letterbox_transform
from crog_tpu_torch.utils.tokenizer import tokenize


class RefCOCODataset:
    """``<shard_dir>/<split>`` records with ``img_bytes``, ``mask`` and
    ``sents``.  The train split draws one sentence per sample from
    ``random.Random(seed)`` (the JAX package draws from the global
    ``random``: ``random.seed(seed)`` there gives the same choices); the
    other splits take the first (the CRIS convention)."""

    def __init__(self, shard_dir: str, split: str = "train", input_size: int = 416,
                 word_length: int = 17, seed: int = 0):
        self.reader = ShardReader(os.path.join(shard_dir, split))
        self.split = split
        self.input_size = (input_size, input_size)
        self.word_length = word_length
        self.rng = random.Random(seed)
        # COCO images are at most 640 px on a side; the eval step un-warps
        # each sample inside a canvas of this size
        self.max_ori_size = (640, 640)

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, n: int) -> Dict:
        rec = self.reader[n]
        img = np.asarray(Image.open(io.BytesIO(rec["img_bytes"])).convert("RGB"))
        mask = np.asarray(rec["mask"], np.uint8)
        sents = rec["sents"]
        if isinstance(sents, np.ndarray):
            sents = [str(s) for s in sents.tolist()]
        sent = self.rng.choice(sents) if self.split == "train" else sents[0]

        ori_size = img.shape[:2]
        mat, mat_inv = letterbox_transform(ori_size, self.input_size)
        border = tuple((CLIP_MEAN * 255).tolist())
        img_w = warp_affine(img, mat, self.input_size, "cubic", border)
        mask_w = warp_affine((mask * 255).astype(np.uint8) if mask.max() <= 1 else mask,
                             mat, self.input_size, "linear")
        return {
            "img": (img_w.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD,
            "mask": mask_w.astype(np.float32) / 255.0,
            "word": tokenize(sent, self.word_length, True)[0],
            "inverse": mat_inv.astype(np.float32),
            "ori_size": np.asarray(ori_size, np.int32),
            "sentence": sent,
            "sent_id": n,
        }
