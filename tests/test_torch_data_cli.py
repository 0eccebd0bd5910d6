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
from crog_tpu_torch.data.ocid_vlg import wire_kwargs
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "crog_tpu_torch"
LEGACY_KEYS = ("img", "mask", "inverse", "ori_size", "word", "grasps",
               "qua", "wid", "ang", "sin", "cos")


@pytest.mark.parametrize("size,index", [(128, 0), (128, 3), (416, 1)])
def test_synthetic_sample_equals_jax_package(size, index):
    """Same seed and index -> bit-identical legacy sample (both packages
    warp, fill and blur through their native host ops, the same C++)."""
    ref = JaxSynthetic(num_samples=8, split="val", input_size=size)[index]
    got = SyntheticOCIDVLG(num_samples=8, split="val", input_size=size)[index]
    for k in LEGACY_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert got["sentence"] == ref["sentence"]


@pytest.mark.parametrize("fmt", ["compact", "raw", "rawlb", "unknown"])
def test_synthetic_wire_formats_equal_jax_package(fmt):
    """Same seed and index -> bit-identical samples in each wire format the
    configs name (uint8 planes, mask bits, raster parameters); an unknown
    format raises ValueError."""
    if fmt == "unknown":
        with pytest.raises(ValueError, match="unknown wire_format"):
            wire_kwargs("jpeg")
        return
    kw = wire_kwargs(fmt)
    ref = JaxSynthetic(num_samples=4, split="val", input_size=128, **kw)[1]
    got = SyntheticOCIDVLG(num_samples=4, split="val", input_size=128, **kw)[1]
    assert set(got) == set(ref)
    dense = [k for k, v in ref.items() if isinstance(v, np.ndarray)]
    assert "img" not in dense and len(dense) >= 5
    for k in dense:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("torch_*.py")))


def test_import_checks_cover_the_readers_loader_and_tools():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for f in ("data/ocid_vlg.py", "data/cache.py", "data/loader.py", "data/shards.py",
              "data/refcoco.py", "data/ref_ocid.py", "test_diff_refer_types.py",
              "native/__init__.py", "utils/metrics.py", "utils/profiling.py"):
        assert f"crog_tpu_torch/{f}" in names, f
    assert "tools/torch_latency.py" in names


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
        "sys.path.insert(0, 'tools'); import torch_latency\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'crog_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _cli(*extra, tmp, wire=("wire_format", "legacy")):
    return [
        sys.executable, "-m", "crog_tpu_torch.test_crog",
        "--config", "config/OCID-VLG/crog_synthetic_r50.yaml", *extra,
        "--opts", *wire, "synthetic_samples", "4",
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


def test_cli_on_cpu_runs_the_configs_rawlb_wire(tmp_path):
    """The config as written: its rawlb wire unpacked on the device and its
    s2d stem, with --fused-stem (the K6/K6b twins on the CPU)."""
    out = subprocess.run(_cli("--device", "cpu", "--fused-stem", tmp=tmp_path, wire=()),
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "wire_format: rawlb" in out.stderr and "stem_s2d: True" in out.stderr
    m = re.search(r"Final: IoU=([-\d.naif]+)", out.stderr)
    assert m and math.isfinite(float(m.group(1))), out.stderr[-3000:]


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


def _synthetic_cfg(*opts):
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list

    cfg = load_cfg_from_cfg_file("config/OCID-VLG/crog_synthetic_r50.yaml")
    cfg = merge_cfg_from_list(cfg, ["input_size", "64", *opts])
    del cfg["wire_format"]
    cfg.pop("synthetic_samples", None)
    return cfg


@pytest.mark.parametrize("compact_transfer,wire", [(None, "compact"), (True, "compact"),
                                                   (False, "legacy")])
def test_build_dataset_wire_default_as_jax_package(compact_transfer, wire):
    """Without ``wire_format`` the JAX package's train_crog.py:73-76 ships
    compact (``compact_transfer``, default True), legacy only when
    ``compact_transfer`` is False."""
    from crog_tpu_torch.test_crog import build_dataset

    cfg = _synthetic_cfg()
    if compact_transfer is not None:
        cfg["compact_transfer"] = compact_transfer
    sample = build_dataset(cfg, "val")[0]
    assert ("img_u8" in sample) == (wire == "compact")
    assert ("img" in sample) == (wire == "legacy")


def test_build_dataset_synthetic_sizes_as_jax_package():
    """train_crog.py:87: 512 train samples, 128 for any other split, unless
    ``synthetic_samples`` says otherwise."""
    from crog_tpu_torch.test_crog import build_dataset

    cfg = _synthetic_cfg()
    assert [len(build_dataset(cfg, s)) for s in ("train", "val", "test")] == [512, 128, 128]
    cfg["synthetic_samples"] = 6
    assert len(build_dataset(cfg, "train")) == 6


def test_build_dataset_reads_the_tree_and_caches(tmp_path):
    """``dataset OCID-VLG`` reads the tree at ``root_path`` (the config's
    version); ``cache_samples`` True wraps it in a 4 GiB SampleCache, a
    number in a cache of that many bytes."""
    from crog_tpu_torch.data.cache import SampleCache
    from crog_tpu_torch.data.ocid_vlg import OCIDVLGDataset
    from crog_tpu_torch.test_crog import build_dataset
    from tests.ocid_fixture import build_ocid_tree

    build_ocid_tree(tmp_path, num_scenes=1)
    cfg = _synthetic_cfg("dataset", "OCID-VLG")
    cfg["root_path"] = str(tmp_path)
    ds = build_dataset(cfg, "val-test")
    assert isinstance(ds, OCIDVLGDataset) and len(ds) == 4
    cfg["cache_samples"] = True
    ds = build_dataset(cfg, "val")
    assert isinstance(ds, SampleCache) and ds.max_bytes == 4 << 30
    assert ds.max_ori_size == (480, 640)
    cfg["cache_samples"] = 1000
    assert build_dataset(cfg, "val").max_bytes == 1000
