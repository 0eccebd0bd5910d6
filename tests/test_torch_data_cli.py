"""The port's host side: synthetic samples identical to the JAX package's,
the import isolation of crog_tpu_torch (no jax, no crog_tpu), and the eval
CLI ``python -m crog_tpu_torch.test_crog``."""

import ast
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crog_tpu.data.synthetic import SyntheticOCIDVLG as JaxSynthetic
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "crog_tpu_torch"
LEGACY_KEYS = ("img", "mask", "inverse", "ori_size", "word", "grasps",
               "qua", "wid", "ang", "sin", "cos")


@pytest.mark.parametrize("size,index", [(128, 0), (128, 3), (416, 1)])
def test_synthetic_sample_equals_jax_package(size, index):
    """Same seed and index -> bit-identical legacy sample (the JAX package
    warps through its native host ops where built; the port's numpy warp
    reproduces them exactly on these scenes)."""
    ref = JaxSynthetic(num_samples=8, split="val", input_size=size)[index]
    got = SyntheticOCIDVLG(num_samples=8, split="val", input_size=size)[index]
    for k in LEGACY_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert got["sentence"] == ref["sentence"]


def test_unported_wire_formats_raise():
    for fmt in ("compact", "raw", "rawlb"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SyntheticOCIDVLG(num_samples=1, wire_format=fmt)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_crog_tpu_ast():
    banned = re.compile(r"^(jax|jaxlib|flax|optax|orbax|crog_tpu)(\.|$)")
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert not banned.match(n), f"{path.relative_to(ROOT)} imports {n}"


def test_port_imports_neither_jax_nor_crog_tpu_at_runtime():
    code = (
        "import importlib, pkgutil, sys\n"
        "import crog_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(crog_tpu_torch.__path__, "
        "'crog_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'crog_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _cli(*extra, tmp):
    return [
        sys.executable, "-m", "crog_tpu_torch.test_crog",
        "--config", "config/OCID-VLG/crog_synthetic_r50.yaml", *extra,
        "--opts", "wire_format", "legacy", "synthetic_samples", "4",
        "batch_size_val", "3", "input_size", "128", "output_folder", str(tmp),
    ]


def test_cli_on_cpu_prints_finite_iou(tmp_path):
    out = subprocess.run(_cli("--device", "cpu", tmp=tmp_path), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    m = re.search(r"Final: IoU=([-\d.naif]+)", out.stderr)
    assert m and math.isfinite(float(m.group(1))), out.stderr[-3000:]


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(_cli(tmp=tmp_path), cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_cli_rejects_unported_wire_format(tmp_path):
    cmd = _cli("--device", "cpu", tmp=tmp_path)
    cmd[cmd.index("legacy")] = "rawlb"
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "NotImplementedError" in out.stderr


def test_chip_smoke_refuses_without_a_card():
    """No card: chip_smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    cannot import the port and fails."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
