"""The port's train CLI, ``python -m crog_tpu_torch.train_crog``, on the
CPU at a small size: it trains, evaluates and saves ``last_model``; and
without a card ``--device cuda`` (the default) raises."""

import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _cli(*extra, tmp):
    return [
        sys.executable, "-m", "crog_tpu_torch.train_crog",
        "--config", "config/OCID-VLG/crog_synthetic_r50.yaml", *extra,
        "--opts", "wire_format", "legacy", "synthetic_samples", "4", "batch_size", "2",
        "batch_size_val", "2", "input_size", "128", "epochs", "1", "print_freq", "1",
        "output_folder", str(tmp), "exp_name", "cli",
    ]


def test_train_cli_on_cpu_trains_evaluates_and_saves(tmp_path):
    out = subprocess.run(_cli("--device", "cpu", tmp=tmp_path), cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = re.findall(r"Loss ([-\d.naif]+) ", out.stderr)
    assert len(losses) == 2 and all(math.isfinite(float(v)) for v in losses), out.stderr[-3000:]
    assert "Evaluation: Epoch=[1/1]" in out.stderr
    ckpt = tmp_path / "cli" / "last_model"
    assert ckpt.is_file()
    payload = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert payload["step"] == 2 and payload["meta"]["epoch"] == 1
    assert "backbone.visual.conv1.weight" in payload["state_dict"]
    ckpt.unlink()  # ~1.7 GB of full-width weights and Adam moments


def test_train_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(_cli(tmp=tmp_path), cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
