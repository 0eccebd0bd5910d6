"""Build RefCOCO record shards from tools/data_process.py's output, on the
port's crog_tpu_torch/data/shards.py (counterpart of tools/folder2lmdb.py;
the reference's tools/folder2lmdb.py:35-71 wrote pyarrow-serialized LMDB).

    python3 tools/torch_folder2lmdb.py -j <anns/refcoco> -i <coco_images> \\
        -m <masks/refcoco> -o <shards/refcoco> [-s train]

One record per referred object, under its ``seg_id``: the encoded image
bytes, the mask binarized at 127, the sentences, the category and the image
name, in the shard format ``crog_tpu_torch.data.refcoco.RefCOCODataset``
reads.  The backend is LMDB when the ``lmdb`` package is importable, else a
directory shard, as the JAX package's tool chooses.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crog_tpu_torch.data.shards import ShardWriter  # noqa: E402


def folder2shard(json_dir, img_dir, mask_dir, output_dir, split):
    with open(os.path.join(json_dir, f"{split}.json")) as f:
        anns = json.load(f)
    backend = "lmdb" if importlib.util.find_spec("lmdb") else "dir"
    writer = ShardWriter(os.path.join(output_dir, split), backend)
    for i, item in enumerate(anns):
        with open(os.path.join(img_dir, item["img_name"]), "rb") as f:
            img_bytes = f.read()
        mask = np.asarray(Image.open(os.path.join(mask_dir, item["mask_name"])))
        writer.put(str(item["seg_id"]), {
            "img_bytes": img_bytes,
            "mask": (mask > 127).astype(np.uint8),
            "sents": np.asarray(item["sents"]),
            "cat": int(item["cat"]),
            "img_name": item["img_name"],
        })
        if (i + 1) % 1000 == 0:
            print(f"{split}: {i + 1}/{len(anns)}")
    writer.close()
    print(f"wrote {len(anns)} records ({writer.backend}) to "
          f"{os.path.join(output_dir, split)}")


def main(argv=None):
    p = argparse.ArgumentParser(description="RefCOCO records into shards (PyTorch port)")
    p.add_argument("-j", "--json-dir", required=True)
    p.add_argument("-i", "--img-dir", required=True)
    p.add_argument("-m", "--mask-dir", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("-s", "--split", default="train")
    a = p.parse_args(argv)
    folder2shard(a.json_dir, a.img_dir, a.mask_dir, a.output_dir, a.split)


if __name__ == "__main__":
    main()
