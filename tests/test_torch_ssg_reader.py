"""The port's OCID-Grasp reader (crog_tpu_torch/data/ocid_grasp.py
``OCIDGraspDataset``) and SSG's figures against the JAX package, on the
tree tests/ocid_fixture.py writes in OCID's on-disk layout (480 x 640 PNGs,
16-bit depth and id masks, per-class grasp files), as
tests/test_dataset_readers.py drives the JAX reader.

The reader is numpy and PIL in both packages: its samples must be equal bit
for bit, legacy and raw, on both splits, with the augmentation drawn from a
``random.Random(s)`` in the port and after ``random.seed(s)`` in JAX.  The
raw samples' unpack is held to the JAX unpack as in
tests/test_torch_ssg_wire.py (1e-5; the binarized maps may flip at a 0.5
tie on at most 0.1% of elements; sin/cos 2e-4).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crog_tpu.data import ssg_rawwire as JW
from crog_tpu.data.ocid_grasp import OCIDGraspDataset as JDataset
from crog_tpu.utils.visualization import draw_grasp_rects as j_draw
from crog_tpu_torch.data import ssg_rawwire as TW
from crog_tpu_torch.data.ocid_grasp import OCIDGraspDataset, collate_ssg
from crog_tpu_torch.engine.ssg_engine import visualization
from crog_tpu_torch.models.ssg_eval import make_ssg_post_processing
from crog_tpu_torch.utils.visualization import draw_grasp_rects
from tests.ocid_fixture import H, W, build_ocid_tree
from tests.test_torch_ssg_wire import SIN_COS_TOL, assert_same_tree

IMG = 128
SPLITS = ("training_0", "validation_0")


@pytest.fixture(scope="module")
def ocid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocid")
    build_ocid_tree(root, num_scenes=2)
    return str(root)


def _pair(root, split, raw, seed=5):
    """Both scenes of ``split`` from each package's reader."""
    kw = dict(img_size=IMG, raw=raw, max_objs=6)
    jd = JDataset(root, split, **kw)
    td = OCIDGraspDataset(root, split, rng=random.Random(seed), **kw)
    random.seed(seed)
    return [jd[i] for i in range(len(jd))], [td[i] for i in range(len(td))]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("raw", [False, True])
def test_reader_samples_match_jax(ocid_root, split, raw):
    js, ts = _pair(ocid_root, split, raw)
    assert len(ts) == 2
    assert_same_tree(ts, js)
    if raw:
        assert ts[0]["ssg_img_u8"].shape == (H, W, 3)
        assert ts[0]["obj_valid"].sum() == 2  # both objects have matched grasps
    else:
        assert ts[0]["rgb"].shape == (IMG, IMG, 3)
        assert sorted(ts[0]["labels"].tolist()) == [1, 3]
        assert ts[0]["grasp_masks"]["qua"].max() > 0


def test_reader_raw_batch_unpacks_like_jax(ocid_root):
    """The reader's raw training batch (480 x 640 -> 128^2) through the
    port's unpack and the JAX unpack, with the train step's pad_objs and
    emit_ds."""
    _, ts = _pair(ocid_root, "training_0", True)
    batch = TW.collate_ssg_raw(ts)
    kw = dict(pad_objs=6, emit_ds=True)
    ref = JW.unpack_ssg_raw({k: jnp.asarray(v) for k, v in batch.items()
                             if isinstance(v, np.ndarray)}, IMG, **kw)
    got = TW.unpack_ssg_raw({k: torch.from_numpy(v) for k, v in batch.items()
                             if isinstance(v, np.ndarray)}, IMG, **kw)
    assert set(got) == set(ref)
    for k, r in ref.items():
        r, g = np.asarray(r), got[k].numpy()
        assert g.shape == r.shape, k
        if k in ("ins_ds", "sem_ds"):
            assert (g != r).mean() <= 1e-3, k
        elif k == "grasp_ds":  # qua, sin, cos, wid
            for i in range(4):
                np.testing.assert_allclose(g[:, i], r[:, i], rtol=0,
                                           atol=SIN_COS_TOL if i in (1, 2) else 1e-5)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=k)
    assert got["ins_ds"].sum() > 0 and got["grasp_ds"][:, 0].max() > 0


def test_reader_frame_and_legacy_collate(ocid_root):
    """The reader's frame is OCID's camera frame, which the post-processing
    maps predictions into; its legacy samples collate to the dense layout."""
    ds = OCIDGraspDataset(ocid_root, "validation_0", img_size=IMG)
    assert ds.ori_hw == (H, W) and ds.num_classes == 32
    batch = collate_ssg([ds[0], ds[1]], max_objs=8)
    assert batch["img"].shape == (2, IMG, IMG, 4) and batch["obj_valid"].sum() == 4


def test_draw_grasp_rects_matches_jax():
    r = np.random.RandomState(0)
    img = r.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    rects = [[r.uniform(0, 160), r.uniform(0, 120), r.uniform(10, 60), r.uniform(5, 30),
              r.uniform(-90, 90)] for _ in range(6)]
    got = draw_grasp_rects(img, rects)
    np.testing.assert_array_equal(got, j_draw(img, rects))
    assert (got != img).any()


def test_visualizations_write_their_pngs(ocid_root, tmp_path):
    """ssg_engine.visualization renders a val batch's first sample through
    the batch-1 post-processing; OCIDGraspDataset.visualization writes the
    raw-data figure and one figure per instance."""
    from tests.test_torch_ssg import _outputs

    anchors, out = _outputs(2, b=1)
    post = make_ssg_post_processing(anchors, ori_hw=(IMG, IMG), max_detections=10,
                                    top_k=20)
    img = torch.rand(1, IMG, IMG, 4)
    fwd = lambda batch: ({k: torch.from_numpy(x) for k, x in out.items()}, img)
    path = visualization([{}], post, fwd, 3, str(tmp_path / "vis"), random.Random(0))
    assert path.endswith("ssg_epoch0003.png") and (tmp_path / "vis" /
                                                    "ssg_epoch0003.png").stat().st_size

    ds = OCIDGraspDataset(ocid_root, "validation_0", img_size=IMG)
    ds.visualization(0, str(tmp_path / "gt"))
    names = sorted(p.name for p in (tmp_path / "gt").iterdir())
    assert names == ["instance-0.png", "instance-1.png", "raw-data.png"]
