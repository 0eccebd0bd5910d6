"""The port's SSG train CLI, ``python -m crog_tpu_torch.train_ssg``, on the
CPU at 128^2 with resnet_layers (1, 1, 1, 1): one epoch trains, evaluates
(J@1/J@5) and saves ``last_model``; the config's raw wire format raises and
names ``legacy``; without a card ``--device cuda`` (the default) raises."""

import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _cli(*extra, tmp, wire="legacy"):
    return [
        sys.executable, "-m", "crog_tpu_torch.train_ssg",
        "--config", "config/OCID-Grasp/ssg_r50.yaml", *extra,
        "--opts", "dataset", "synthetic", "wire_format", wire, "synthetic_samples", "4",
        "img_size", "128", "resnet_layers", "[1,1,1,1]", "num_classes", "8",
        "masks_to_train", "8", "batch_size", "2", "batch_size_val", "2", "epochs", "1",
        "val_freq", "1", "print_freq", "1", "output_folder", str(tmp), "exp_name", "cli",
    ]


def test_ssg_train_cli_on_cpu_trains_evaluates_and_saves(tmp_path):
    out = subprocess.run(_cli("--device", "cpu", tmp=tmp_path), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = re.findall(r"Loss ([-\d.naif]+) ", out.stderr)
    assert len(losses) == 2 and all(math.isfinite(float(v)) for v in losses), out.stderr[-3000:]
    for term in ("loss_cls", "loss_ins", "loss_sem", "loss_qua", "loss_wid"):
        assert term in out.stderr
    assert re.search(r"SSG Evaluation: Epoch=\[1/1\]  J_index@1: [\d.]+  J_index@5",
                     out.stderr)
    ckpt = tmp_path / "cli" / "last_model"
    assert ckpt.is_file()
    payload = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert payload["step"] == 2 and payload["meta"]["epoch"] == 1
    assert "prediction_layers.grasp_coef_layer.0.weight" in payload["state_dict"]


@pytest.mark.parametrize("extra,wire,message", [
    (("--device", "cpu"), "raw", "pass wire_format legacy"),
    ((), "legacy", "no CUDA device"),
])
def test_ssg_train_cli_refuses(tmp_path, extra, wire, message):
    if not extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(_cli(*extra, tmp=tmp_path, wire=wire), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert message in out.stderr, out.stderr[-2000:]
