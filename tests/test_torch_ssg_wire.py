"""The port's SSG raw wire (crog_tpu_torch/data/ssg_rawwire.py) and the
frame-level synthetic against the JAX package, on the CPU, at the geometry
of tests/test_ssg_rawwire.py (48 x 64 frames, S = 64, M = 6 slots).

Tolerances, each stated where it is used.  The host side is numpy in both
packages and must give equal bits: ``pack_ssg_raw``'s arrays,
``collate_ssg_raw``'s slot trim, ``transform_boxes_host`` and
``finalize_legacy``'s dense sample, with the augmentation drawn from a
``random.Random(s)`` in the port and after ``random.seed(s)`` in JAX.  The
unpack is f32 in both, summed in another order: the image, masks, quality
and width to 1e-5 (values of order 1); the binarized ``ins_ds`` /
``sem_ds`` may flip only where the downsampled mask sits on 0.5 (at most
0.1% of the elements); sin/cos of the degree-unit angle canvas to 2e-4
(derived at ``SIN_COS_TOL``).
"""

import copy
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.data import ssg_rawwire as JW
from crog_tpu.data.ocid_grasp import collate_ssg as j_collate
from crog_tpu.data.synthetic_ssg import SyntheticOCIDGraspFrames as JFrames
from crog_tpu.engine import ssg_engine as JE
from crog_tpu.engine.crog_engine import TrainState
from crog_tpu.engine.optim import make_optimizer as j_optimizer
from crog_tpu.models import ssg_loss as JL
from crog_tpu.models.ssg import SSG as JSSG
from crog_tpu_torch.data import ssg_rawwire as TW
from crog_tpu_torch.data.ocid_grasp import collate_ssg
from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGraspFrames
from crog_tpu_torch.engine import ssg_engine as TE
from crog_tpu_torch.engine.optim import make_optimizer
from crog_tpu_torch.models import ssg_loss as TL
from crog_tpu_torch.models.convert import load_numpy_state_dict, ssg_state_dict_from_flax
from crog_tpu_torch.models.ssg import SSG
from tests.torch_port_helpers import assert_close_scaled, randomize

FRAME = (48, 64)
S = 64
M = 6
SPLITS = ("training_0", "validation_0")
# The warped angle canvas holds degrees (up to 180): each of its two f32
# products sums a few weights <= 1 times values <= 180, so the two packages'
# summation orders differ by a few roundings of 180 * 2^-24 ~ 1.1e-5; sin and
# cos of 2 * angle move by at most twice that per rounding, plus their own
# f32 error at arguments up to 360 (a few 1e-7).  Eight such roundings: 2e-4.
SIN_COS_TOL = 2e-4


def _samples(split, raw, n=3, seed=7, frame=FRAME, img_size=S, **kw):
    """n samples of the frame-level synthetic from each package, the
    augmentation drawn alike."""
    args = dict(num_samples=n, frame_hw=frame, img_size=img_size, split=split, **kw)
    if raw:
        args.update(raw=True, max_objs=M, max_rects=4)
    jd, td = JFrames(**args), SyntheticOCIDGraspFrames(**args, rng=random.Random(seed))
    random.seed(seed)
    return [jd[i] for i in range(n)], [td[i] for i in range(n)]


def assert_same_tree(got, ref, path=""):
    """Equal bits, dtypes and structure of nested dicts / lists of arrays."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            assert_same_tree(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_tree(g, r, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert got == ref, path


def _tensors(batch, to):
    return {k: to(v) for k, v in batch.items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("raw", [False, True])
def test_frames_samples_match_jax(split, raw):
    """pack_ssg_raw's wire sample (raw) or finalize_legacy's dense sample
    (legacy), every array equal, for the same drawn augmentation; then
    collate_ssg_raw's slot trim, or collate_ssg."""
    js, ts = _samples(split, raw)
    assert_same_tree(ts, js)
    if raw:
        ref, got = JW.collate_ssg_raw(js), TW.collate_ssg_raw(ts)
        assert ref["obj_valid"].shape[1] < M  # 2-4 objects: the trim engaged
    else:
        ref, got = j_collate(js, max_objs=M), collate_ssg(ts, max_objs=M)
    assert_same_tree(got, ref)


@pytest.mark.parametrize("mirror", [0, 1])
def test_transform_boxes_host_matches_jax(mirror):
    r = np.random.RandomState(mirror)
    boxes = np.sort(r.uniform(0, 480, (5, 4)).astype(np.float32), axis=-1)
    for h0, w0 in ((480, 640), (640, 480)):
        p = {"mirror": mirror, "pad_y0": int(r.randint(0, 160)),
             "pad_x0": int(r.randint(0, 160))}
        np.testing.assert_array_equal(TW.transform_boxes_host(boxes, p, h0, w0),
                                      JW.transform_boxes_host(boxes, p, h0, w0))


def test_photometric_distort_matches_jax():
    """The card's HSV distortion on random BGR frames and parameters (hue
    shifts across the 0/360 wrap included) against the JAX package's, to
    1e-3 of 255 (f32 divisions in another order near hue sector edges)."""
    r = np.random.RandomState(0)
    img = r.randint(0, 256, (4, 24, 32, 3)).astype(np.float32)
    aug = np.zeros((4, 7), np.float32)
    aug[:, 0] = r.uniform(-32, 32, 4)
    aug[:, 1] = r.uniform(0.7, 1.3, 4)
    aug[:, 2:4] = r.uniform(-15, 15, (4, 2))
    ref = jax.vmap(JW._photometric_distort_j)(jnp.asarray(img), jnp.asarray(aug))
    got = TW._photometric_distort(torch.from_numpy(img), torch.from_numpy(aug))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3 * 255)


def _assert_unpack_matches_jax(batch, kw):
    """Both packages' unpack of one packed batch: the same keys, shapes and
    dtypes; image and masks to 1e-5, sin/cos to SIN_COS_TOL, the binarized
    maps differing in at most 1e-3 of the elements.  Returns the port's."""
    ref = JW.unpack_ssg_raw(_tensors(batch, jnp.asarray), S, **kw)
    got = TW.unpack_ssg_raw(_tensors(batch, torch.from_numpy), S, **kw)
    assert set(got) == set(ref)
    for k, r in ref.items():
        r, g = np.asarray(r), got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.shape, r.shape)
        if k in ("ins_ds", "sem_ds"):
            assert (g != r).mean() <= 1e-3, k
        elif k in ("grasp_sin", "grasp_cos"):
            np.testing.assert_allclose(g, r, rtol=0, atol=SIN_COS_TOL, err_msg=k)
        elif k == "grasp_ds":  # qua, sin, cos, wid downsampled
            for i in range(4):
                np.testing.assert_allclose(g[:, i], r[:, i], rtol=0,
                                           atol=SIN_COS_TOL if i in (1, 2) else 1e-5)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=k)
    return got


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("targets,emit_ds", [(True, False), (True, True), (False, False),
                                             (False, True)])
def test_unpack_matches_jax(split, targets, emit_ds):
    """unpack_ssg_raw on one packed batch of 3, padded to M slots, against
    the JAX unpack: the same keys, shapes and values."""
    _, ts = _samples(split, True)
    batch = TW.collate_ssg_raw(ts)
    kw = dict(targets=targets, pad_objs=M, emit_ds=emit_ds)
    got = _assert_unpack_matches_jax(batch, kw)
    if emit_ds and targets:
        assert got["grasp_ds"].shape == (3, 4, M, S // 4, S // 4)


@pytest.mark.parametrize("emit_ds", [False, True])
def test_unpack_matches_jax_over_several_chunks(emit_ds):
    """Frames of M objects each fill all M slots, so the unpack takes
    instance_chunk 4, then the last 2: against the JAX unpack on the same
    packed batch, to the tolerances of test_unpack_matches_jax."""
    ds = SyntheticOCIDGraspFrames(num_samples=2, frame_hw=FRAME, img_size=S, raw=True,
                                  max_objs=M, max_rects=4, rng=random.Random(3),
                                  objects=(M, M + 1))
    batch = TW.collate_ssg_raw([ds[i] for i in range(2)])
    assert batch["obj_valid"].all() and batch["obj_valid"].shape[1] == M
    _assert_unpack_matches_jax(batch, dict(pad_objs=M, emit_ds=emit_ds, instance_chunk=4))


@pytest.mark.parametrize("split", SPLITS)
def test_unpack_matches_the_legacy_host_path(split):
    """The port's raw wire against the port's legacy host pipeline with the
    same drawn augmentation (tests/test_ssg_rawwire.py's tolerances): boxes
    to 1e-6, image and masks to 2e-5, sin/cos to 1e-3, quality and width
    within the legacy path's uint8 quantization (2.5/255)."""
    seed = 11
    for i in range(2):
        args = dict(num_samples=4, frame_hw=FRAME, img_size=S, split=split)
        leg = SyntheticOCIDGraspFrames(**args, rng=random.Random(seed + i))[i]
        raw = SyntheticOCIDGraspFrames(**args, raw=True, max_objs=M, max_rects=4,
                                       rng=random.Random(seed + i))[i]
        bl = collate_ssg([leg], max_objs=M)
        br = TW.collate_ssg_raw([raw])
        assert TW.is_ssg_raw(br) and not TW.is_ssg_raw(bl)
        out = TW.unpack_ssg_raw(_tensors(br, torch.from_numpy), S, pad_objs=M)
        np.testing.assert_allclose(out["boxes"].numpy(), bl["boxes"], atol=1e-6)
        np.testing.assert_array_equal(out["labels"].numpy(), bl["labels"])
        np.testing.assert_array_equal(out["obj_valid"].numpy(), bl["obj_valid"])
        for k, atol in (("img", 2e-5), ("ins_masks", 2e-5), ("grasp_sin", 1e-3),
                        ("grasp_cos", 1e-3), ("grasp_qua", 2.5 / 255),
                        ("grasp_wid", 2.5 / 255)):
            d = np.abs(out[k].numpy() - bl[k]).max()
            assert d < atol, (k, float(d))


# ------------------------------------------------------------ raw train step
IMG, CLASSES, K = 128, 8, 8
GEOM = dict(img_size=IMG, resnet_layers=(1, 1, 1, 1), num_classes=CLASSES)


def test_raw_train_step_matches_jax():
    """One make_ssg_train_step step on a raw batch (frames 96 x 128 ->
    128^2, 2 samples, unpacked with pad_objs and emit_ds) against the JAX
    step's unpack and loss, with the same positives: the 8 loss terms to
    1e-4 relative and each parameter's gradient to 2% relative L2 (plus 1e-6
    of the global norm), tests/test_torch_ssg.py's tolerances for a
    train-mode step over 2 images."""
    js, ts = _samples("training_0", True, n=2, seed=3, frame=(96, 128), img_size=IMG,
                      num_classes=CLASSES)
    batch = TW.collate_ssg_raw(ts)
    jm = JSSG(dtype=jnp.float32, **GEOM)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, IMG, IMG, 4)), train=True)
    v = randomize(jax.tree_util.tree_map(np.asarray, v))
    tm = SSG(**GEOM)
    load_numpy_state_dict(tm, ssg_state_dict_from_flax(v["params"], v["batch_stats"]))
    anchors = jm.anchors()
    rng = jax.random.PRNGKey(1)

    # JAX: the step's own unpack (pad_objs, emit_ds), then its loss's gradient
    tx = j_optimizer(v["params"], 3e-4, 1.0, [100], 0.95, 10, weight_decay=5e-4,
                     optimizer="adamw")
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              batch_stats=v["batch_stats"], tx=tx)
    _, jm_metrics = JE.make_ssg_train_step(jm, tx, anchors, {"masks_to_train": K},
                                           img_size=IMG, max_objs=M)(
        state, copy.deepcopy(batch), rng)
    dense = JW.unpack_ssg_raw(
        {k: jnp.asarray(batch[k]) for k in TW.SSG_RAW_STEP_KEYS if k in batch}, IMG,
        pad_objs=M, emit_ds=True)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          dense["img"], train=True, mutable=["batch_stats"])
        return JL.ssg_losses(out, dense, jnp.asarray(anchors), rng, masks_to_train=K)[0]

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(v["params"]))

    opt, sched = make_optimizer(tm, 3e-4, 1.0, [100], 0.95, 10, weight_decay=5e-4)
    step = TE.make_ssg_train_step(tm, opt, sched, anchors, {"masks_to_train": K},
                                  device="cpu", max_objs=M)
    prio = torch.tensor(np.array(jax.random.uniform(rng, (2, len(anchors)))))
    monkey = pytest.MonkeyPatch()
    monkey.setattr(TL, "draw_priority", lambda shape, generator=None: prio)
    try:
        metrics = step(batch)
    finally:
        monkey.undo()
    assert set(metrics) == set(jm_metrics) and len(metrics) == 9
    for k, r in jm_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(r), rtol=1e-4, err_msg=k)
    gref = ssg_state_dict_from_flax(jgrads, jax.tree_util.tree_map(np.zeros_like,
                                                                   v["batch_stats"]))
    gnorm = np.sqrt(sum(float(np.sum(np.square(g)))
                        for g in jax.tree_util.tree_leaves(jgrads)))
    for name, p in tm.named_parameters():
        err = np.linalg.norm(p.grad.numpy() - gref[name])
        assert err <= 2e-2 * np.linalg.norm(gref[name]) + 1e-6 * gnorm, name


def test_raw_eval_forward_unpacks_only_the_image():
    """make_ssg_eval_fwd on a raw batch sees the image the JAX eval unpack
    makes (to 1e-5) and runs the model on it."""
    _, ts = _samples("validation_0", True, n=2, frame=(96, 128), img_size=IMG)
    batch = TW.collate_ssg_raw(ts)
    tm = SSG(**GEOM)
    out, img = TE.make_ssg_eval_fwd(tm, "cpu")(batch)
    ref = JW.unpack_ssg_raw(_tensors(batch, jnp.asarray), IMG, targets=False)["img"]
    assert_close_scaled(img.numpy(), np.asarray(ref), 1e-5)
    assert out["protos"].shape[0] == 2
