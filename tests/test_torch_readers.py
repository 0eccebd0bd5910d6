"""The port's on-disk readers against the JAX package's, on the same
real-format OCID tree (``tests/ocid_fixture.py``, 2 scenes, 8 referring
expressions) and the same RefCOCO record shards: OCID-VLG in each wire
format, its annotated frame, RefOCIDGrasp, RefCOCO (val: the first
sentence; train: the port's ``random.Random(s)`` against the JAX package's
global ``random.seed(s)``), and shards written by either package read by
the other.

Tolerances: integer and uint8 fields exact; float fields to 1e-6 (the
same numpy arithmetic; both packages warp, fill and blur through their
native host ops, the same C++).
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

from crog_tpu.data import shards as JS
from crog_tpu.data.ocid_vlg import OCIDVLGDataset as JaxOCIDVLG
from crog_tpu.data.ref_ocid import RefOCIDGraspDataset as JaxRefOCID
from crog_tpu.data.refcoco import RefCOCODataset as JaxRefCOCO
from crog_tpu_torch.data import shards as TS
from crog_tpu_torch.data.ocid_vlg import OCIDVLGDataset, wire_kwargs
from crog_tpu_torch.data.ref_ocid import RefOCIDGraspDataset
from crog_tpu_torch.data.refcoco import RefCOCODataset
from tests.ocid_fixture import build_ocid_tree

RES = 128


@pytest.fixture(scope="module")
def ocid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocid")
    build_ocid_tree(root, num_scenes=2)
    return str(root)


def assert_sample_equal(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray):
            g = np.asarray(g)
            assert g.dtype == r.dtype and g.shape == r.shape, (k, g.dtype, r.dtype)
            if np.issubdtype(r.dtype, np.floating):
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            assert g == r, k


@pytest.mark.parametrize("wire", ["rawlb", "raw", "compact", "legacy"])
def test_ocid_vlg_samples_equal_jax_package(ocid_root, wire):
    kw = wire_kwargs(wire)
    ref = JaxOCIDVLG(ocid_root, "val", input_size=RES, **kw)
    got = OCIDVLGDataset(ocid_root, "val", input_size=RES, **kw)
    assert len(got) == len(ref) == 8
    assert got.max_ori_size == ref.max_ori_size == (480, 640)
    assert got.sent_to_index == ref.sent_to_index
    for n in range(len(ref)):
        assert_sample_equal(got[n], ref[n])


def test_ocid_vlg_split_map(ocid_root):
    """'val-test' (the reference test configs' split) reads the test file;
    an unknown split raises."""
    for split in ("train", "val", "test", "val-test"):
        got = OCIDVLGDataset(ocid_root, split, input_size=RES)
        assert [it["sent_id"] for it in got.items] == \
            [it["sent_id"] for it in JaxOCIDVLG(ocid_root, split, input_size=RES).items]
    with pytest.raises(KeyError):
        OCIDVLGDataset(ocid_root, "holdout")


def test_annotated_image_equals_jax_package(ocid_root):
    ref = JaxOCIDVLG(ocid_root, "test", input_size=RES)
    got = OCIDVLGDataset(ocid_root, "test", input_size=RES)
    for n in (0, 5):
        a, b = got.get_annotated_image(n), ref.get_annotated_image(n)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_ref_ocid_samples_equal_jax_package(ocid_root):
    ref = JaxRefOCID(ocid_root, input_size=RES, mode="val")
    got = RefOCIDGraspDataset(ocid_root, input_size=RES, mode="val")
    assert len(got) == len(ref) == 8
    for n in range(len(ref)):
        assert_sample_equal(got[n], ref[n])
        assert len(got[n]["grasps"]) == 2


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _records(n=5, seed=2):
    rng = np.random.RandomState(seed)
    sizes = [(60, 80), (100, 64), (90, 90), (64, 120), (72, 56)]
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        yield str(i), {
            "img_bytes": _png_bytes((rng.rand(h, w, 3) * 255).astype(np.uint8)),
            "mask": (rng.rand(h, w) > 0.6).astype(np.uint8),
            "sents": np.asarray([f"sample {i}", f"the thing {i}", "left one"]),
            "cat": i, "img_name": f"{i}.jpg",
        }


def _write(writer_cls, path):
    w = writer_cls(str(path), backend="dir")
    for key, rec in _records():
        w.put(key, rec)
    w.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_shards_read_across_packages(tmp_path, writer, reader):
    """Directory shards are byte-identical between the packages and each
    reads the other's."""
    mods = {"jax": JS, "port": TS}
    _write(mods[writer].ShardWriter, tmp_path / "w")
    _write(mods[reader].ShardWriter, tmp_path / "r")
    names = sorted(p.name for p in (tmp_path / "w").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "r").iterdir())
    for name in names:
        assert (tmp_path / "w" / name).read_bytes() == (tmp_path / "r" / name).read_bytes()
    r = mods[reader].ShardReader(str(tmp_path / "w"))
    want = dict(_records())
    assert r.keys == list(want)
    for key, rec in zip(r.keys, r):
        assert rec["img_bytes"] == want[key]["img_bytes"]
        np.testing.assert_array_equal(rec["mask"], want[key]["mask"])
        assert list(rec["sents"]) == list(want[key]["sents"])
        assert rec["cat"] == want[key]["cat"] and rec["img_name"] == want[key]["img_name"]


def test_lmdb_shard_without_lmdb_raises(tmp_path):
    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="lmdb"):
            TS.ShardReader(str(tmp_path))
        with pytest.raises(RuntimeError, match="lmdb"):
            TS.ShardWriter(str(tmp_path / "x"), backend="lmdb")
    else:
        w = TS.ShardWriter(str(tmp_path / "x"), backend="lmdb")
        w.put("a", {"v": np.arange(3)})
        w.close()
        np.testing.assert_array_equal(TS.ShardReader(str(tmp_path / "x"))[0]["v"],
                                      np.arange(3))


@pytest.mark.parametrize("split,seed", [("val", 0), ("train", 3), ("train", 11)])
def test_refcoco_samples_equal_jax_package(tmp_path, split, seed):
    _write(TS.ShardWriter, tmp_path / "refcoco" / split)
    root = str(tmp_path / "refcoco")
    random.seed(seed)
    ref = JaxRefCOCO(root, split, input_size=RES)
    ref_samples = [ref[n] for n in range(len(ref))]
    got = RefCOCODataset(root, split, input_size=RES, seed=seed)
    assert got.max_ori_size == ref.max_ori_size == (640, 640)
    got_samples = [got[n] for n in range(len(got))]
    for g, r in zip(got_samples, ref_samples):
        assert_sample_equal(g, r)
    if split == "val":
        assert [s["sentence"] for s in got_samples] == [f"sample {i}" for i in range(5)]
