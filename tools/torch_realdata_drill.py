"""Import-day drill for the port: real OCID-VLG data and a trained
reference ``.pth`` -> metric table, in one command (counterpart of
tools/realdata_drill.py).

    python3 tools/torch_realdata_drill.py --data-dir /data/OCID-VLG \\
        --pth /ckpts/best_iou_model.pth [--version multiple] [--split test] \\
        [--config config/OCID-VLG/crog_multiple_r50.yaml] [--device cuda] [--opts ...]

1) validates the dataset layout the reader expects (reference
utils/dataset.py:704-766: refer/<version>/<split>_expressions.json and the
scene files the first expression points at), 2) runs the port's eval CLI,
``python -m crog_tpu_torch.test_crog``, with the ``.pth`` as ``resume`` (the
port loads the reference state dict directly), and 3) parses its ``Final:``
line and prints the metric table (IoU, Pr@50-90, J@1, J@5).  A failed eval,
or one without a ``Final:`` line, exits nonzero.

``--fixture`` is the smoke test: the real-format 2-scene tree of
tests/ocid_fixture.py (real PNGs, expressions JSON, grasp annotation txts)
and a reference-schema ``.pth`` of the port's own ``build_crog`` with
``random_init_`` seeded by the config's ``manual_seed`` (state dict keys
prefixed ``module.`` as the reference's DDP checkpoints are), in a
temporary directory, through the same pipeline on the train split.
``--opts`` go to the eval (and to the fixture's model, so that the two
match).  ``--device`` defaults to ``cuda``; the eval CLI raises without a
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

METRICS = ("IoU", "Pr@50", "Pr@60", "Pr@70", "Pr@80", "Pr@90", "J@1", "J@5")


def validate_layout(data_dir: str, version: str, split: str) -> dict:
    """Check the OCID-VLG tree the reader will walk; returns a summary."""
    refer = os.path.join(data_dir, "refer", version, f"{split}_expressions.json")
    if not os.path.isfile(refer):
        raise SystemExit(
            f"[drill] missing {refer} — expected the reference layout "
            "refer/<version>/<split>_expressions.json "
            "(reference utils/dataset.py:704-710)")
    with open(refer) as f:
        items = json.load(f)["data"]  # the reader's schema, data/ocid_vlg.py
    if not items:
        raise SystemExit(f"[drill] {refer} holds zero expressions")
    first = items[0]
    seq_path, im_name = first["image_filename"].split(",")
    missing = [os.path.join(seq_path, sub, im_name)
               for sub in ("rgb", "depth", "seg_mask_instances_combi")
               if not os.path.isfile(os.path.join(data_dir, seq_path, sub, im_name))]
    if missing:
        raise SystemExit(f"[drill] scene files missing: {missing[:4]}")
    return {"expressions": len(items), "first_keys": sorted(first.keys()),
            "missing_scene_files": missing}


def make_fixture(tmp: str, config: str, opts) -> tuple:
    """The 2-scene fixture tree and a reference-schema ``.pth`` of seeded
    random weights for ``config`` with ``opts``."""
    import torch

    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
    from crog_tpu_torch.models.crog import build_crog, random_init_

    spec = importlib.util.spec_from_file_location(
        "ocid_fixture", os.path.join(REPO, "tests", "ocid_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    data_dir = os.path.join(tmp, "OCID-VLG")
    fixture.build_ocid_tree(data_dir, num_scenes=2, version="multiple")
    cfg = load_cfg_from_cfg_file(config)
    if opts:
        cfg = merge_cfg_from_list(cfg, list(opts))
    model = random_init_(build_crog(cfg, torch.float32),
                         torch.Generator().manual_seed(cfg.manual_seed))
    pth = os.path.join(tmp, "fixture_model.pth")
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd, "epoch": 0}, pth)
    return data_dir, pth


def run_eval(config: str, data_dir: str, pth: str, split: str, version: str, extra_opts,
             device: str = "cuda", output_folder: str | None = None) -> str:
    """The eval CLI on the tree and checkpoint; returns its ``Final:``
    metrics."""
    cmd = [sys.executable, "-m", "crog_tpu_torch.test_crog", "--config", config,
           "--device", device, "--opts", "root_path", data_dir, "dataset", "OCID-VLG",
           "version", version, "test_split", split, "resume", pth,
           "exp_name", "realdata_drill"]
    if output_folder:
        cmd += ["output_folder", output_folder]
    cmd += list(extra_opts or [])
    print("[drill] running:", " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          env=env)
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"[drill] eval failed rc={proc.returncode}")
    m = re.search(r"Final: (IoU=.*)$", proc.stdout, re.M)
    if not m:
        raise SystemExit("[drill] no Final metric line in eval output")
    return m.group(1).strip()


def metric_table(final: str) -> dict:
    """``IoU=12.34  Pr@50=...`` -> {metric: value}; every metric of
    METRICS must be there."""
    table = {k: float(v) for k, v in re.findall(r"(\S+?)=(-?[\d.]+|nan)", final)}
    missing = [k for k in METRICS if k not in table]
    if missing:
        raise SystemExit(f"[drill] metrics missing from the Final line: {missing}")
    return table


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="real-data drill (PyTorch port)")
    p.add_argument("--data-dir", help="real OCID-VLG root")
    p.add_argument("--pth", help="trained reference checkpoint (.pth)")
    p.add_argument("--config", default="config/OCID-VLG/crog_multiple_r50.yaml")
    p.add_argument("--version", default="multiple")
    p.add_argument("--split", default="test")
    p.add_argument("--device", default="cuda")
    p.add_argument("--fixture", action="store_true",
                   help="smoke mode: the 2-scene fixture tree and a seeded random "
                        "reference-schema .pth in place of real data")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        if a.fixture:
            data_dir, pth = make_fixture(tmp, a.config, a.opts)
            split, version, out = "train", "multiple", os.path.join(tmp, "exp")
        else:
            if not (a.data_dir and a.pth):
                raise SystemExit("--data-dir and --pth required (or --fixture for the "
                                 "smoke test)")
            data_dir, pth, split, version, out = a.data_dir, a.pth, a.split, a.version, None
        summary = validate_layout(data_dir, version, split)
        print(f"[drill] layout OK: {json.dumps(summary)}", flush=True)
        final = run_eval(a.config, data_dir, pth, split, version, a.opts, a.device, out)
    table = metric_table(final)
    print("\n================ DRILL RESULT ================")
    print(f"split={split} version={version} device={a.device}")
    for k in METRICS:
        print(f"  {k:6s} {table[k]:8.2f}")
    print("reference comparison: paper table (arXiv 2311.05779) — IoU/J@1 within ~1pt = "
          "checkpoint load + eval stack healthy")
    print("==============================================", flush=True)
    return table


if __name__ == "__main__":
    main()
