"""The port's slice as a whole against the JAX package, on the CPU in fp32:
tiny CROG logits, the eval step's iou / rects / rects_valid,
``validate_with_grasp`` over synthetic val samples, and the weight carry
round trip (flax -> the port's state_dict -> crog_tpu's converter).

Tolerances: logits to 2e-5 of their largest magnitude (fp32 sums in another
order).  The eval outputs go through thresholds (mask > 0.35, quality peaks
> 0.4) that such noise could flip only at a pixel sitting on a threshold, so
IoU is held to 1e-3 and peak positions and validity exactly; rect values
(angle in degrees, width in px) to 1e-3 of their scale.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.engine.crog_engine import make_eval_step as jax_make_eval_step
from crog_tpu.engine.crog_engine import validate_with_grasp as jax_validate
from crog_tpu.models.convert import convert_crog_state_dict
from crog_tpu_torch.data.loader import DataLoader
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG
from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp
from crog_tpu_torch.models.convert import state_dict_from_flax
from tests.torch_port_helpers import (
    RES,
    assert_close_scaled,
    assert_step_matches_jax,
    inputs,
    jax_train_grads,
    port_train_step,
    tiny_pair,
    train_batch,
)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def batches():
    ds = SyntheticOCIDVLG(num_samples=4, split="val", input_size=RES)
    return list(DataLoader(ds, 3, pad_last_batch=True))  # 3 + (1 padded)


@pytest.fixture(scope="module")
def eval_steps(pair):
    jm, v, tm = pair
    return (jax_make_eval_step(jm, input_size=RES),
            make_eval_step(tm, input_size=RES, device="cpu"), v)


def test_crog_logits_match_flax(pair):
    jm, v, tm = pair
    img, word = inputs()
    ref = np.asarray(jm.apply(v, jnp.asarray(img), jnp.asarray(word), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(word)).numpy()
    assert got.shape == ref.shape == (2, RES // 4, RES // 4, 5)
    assert_close_scaled(got, ref, 2e-5)


def _compare_eval(got, ref):
    np.testing.assert_allclose(got["iou"].numpy(), np.asarray(ref["iou"]),
                               rtol=0, atol=1e-3)
    valid = np.asarray(ref["rects_valid"])
    np.testing.assert_array_equal(got["rects_valid"].numpy(), valid)
    g, r = got["rects"].numpy()[valid], np.asarray(ref["rects"])[valid]
    np.testing.assert_array_equal(g[:, :2], r[:, :2])  # peak x, y
    if len(r):
        assert_close_scaled(g, r, 1e-3)


def test_eval_step_matches_jax(eval_steps, batches):
    jstep, tstep, v = eval_steps
    for batch in batches:
        _compare_eval(tstep(batch), jstep(v, batch))


class _FixedPreds(torch.nn.Module):
    def __init__(self, preds):
        super().__init__()
        self.preds = torch.nn.Parameter(torch.from_numpy(preds), requires_grad=False)

    def forward(self, img, word):
        return self.preds


def test_eval_postprocess_matches_jax(batches):
    """Engineered maps with clear peaks and a border peak, through both
    post-processing pipelines.  (Exact ties do not survive the resample
    bit-identically; ``test_find_peaks_matches_jax`` holds the ties.)"""
    batch = batches[0]
    b, s = len(batch["word"]), RES // 4
    r = np.random.RandomState(3)
    preds = r.randn(b, s, s, 5).astype(np.float32)
    preds[..., 1] = -4.0
    preds[0, 10, 12, 1], preds[0, 20, 5, 1] = 3.0, 2.5
    preds[1, 1, 1, 1] = 5.0  # at the border of the 32x32 map
    preds[1, 16, 16, 1] = 2.0
    preds[2, 9, 9, 1], preds[2, 25, 20, 1] = 1.5, 1.0

    class Jax:
        @staticmethod
        def apply(variables, img, word, train=False):
            return jnp.asarray(preds)

    ref = jax_make_eval_step(Jax, input_size=RES)({}, batch)
    got = make_eval_step(_FixedPreds(preds), input_size=RES)(batch)
    _compare_eval(got, ref)
    assert np.asarray(ref["rects_valid"]).any()


def test_validate_with_grasp_matches_jax(eval_steps, batches):
    jstep, tstep, v = eval_steps
    jax_ious = []
    ref = jax_validate(
        batches, jstep, v,
        on_batch=lambda b, out, n: jax_ious.extend(np.asarray(out["iou"])[:n]),
    )
    got = validate_with_grasp(batches, tstep)
    assert len(got["iou_list"]) == len(jax_ious) == 4
    np.testing.assert_allclose(got["iou_list"], jax_ious, rtol=0, atol=1e-3)
    for key in ("j_index@1", "j_index@5"):
        assert got[key] == ref[key], key
    assert got["prec"] == ref["prec"]


def test_weight_carry_round_trip(pair):
    """flax params -> the port's state_dict -> crog_tpu's converter returns
    the original leaves, and the port's CROG holds exactly those keys."""
    _, v, tm = pair
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    assert set(sd) == set(tm.state_dict())
    params, stats = convert_crog_state_dict(sd)
    for tree, orig in ((params, v["params"]), (stats, v["batch_stats"])):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        want = dict(jax.tree_util.tree_leaves_with_path(orig))
        assert set(got) == set(want)
        for k, leaf in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(k))


def test_single_mask_variant_loads_and_runs():
    """use_grasp_masks=False: the 1-task projector, same carry path."""
    jm, v, tm = tiny_pair(use_grasp_masks=False)
    img, word = inputs(batch=1)
    ref = np.asarray(jm.apply(v, jnp.asarray(img), jnp.asarray(word), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(word)).numpy()
    assert got.shape[-1] == 1
    assert_close_scaled(got, ref, 2e-5)


def test_wo_contrastive_eval_and_train_step_match_jax():
    """crog_multiple_r50_wo_contrastive.yaml's model (``use_contrastive:
    False``: no decoder, the FPN's output straight into the projector),
    tiny: the eval logits to 2e-5 of their scale (as
    test_crog_logits_match_flax holds the full model) and one train step
    against crog_tpu's (``assert_step_matches_jax``) at 4 samples.  Without
    the decoder the text tower's gradient arrives only through the FPN's
    txt_proj BatchNorm, which over 2 samples maps each channel to about
    +-1 and passes back only a cancellation residue: there a 1e-7 relative
    change of the image moves crog_tpu's own text-tower gradients by 1.4%
    (relative L2) and the port sits 3.3% from it, while at 4 samples the
    worst gradient (of norm above 1e-3) is 0.77% from crog_tpu's."""
    from crog_tpu_torch.config import load_cfg_from_cfg_file

    cfg = load_cfg_from_cfg_file("config/OCID-VLG/crog_multiple_r50_wo_contrastive.yaml")
    assert cfg.use_contrastive is False and cfg.use_grasp_masks is True
    jm, v, tm = tiny_pair(use_contrastive=False)
    assert not hasattr(tm, "decoder")
    img, word = inputs()
    ref = np.asarray(jm.apply(v, jnp.asarray(img), jnp.asarray(word), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(word)).numpy()
    assert got.shape == ref.shape == (2, RES // 4, RES // 4, 5)
    assert_close_scaled(got, ref, 2e-5)
    batch = train_batch(4)
    assert_step_matches_jax(port_train_step(copy.deepcopy(tm), batch),
                            jax_train_grads(jm, v, batch))


def test_find_peaks_matches_jax():
    """Exact ties (two equal peaks, a plateau), a peak on the border, an
    all-below-threshold map and a constant map, with per-sample valid
    sizes: positions and validity must be identical."""
    from crog_tpu.ops.peaks import find_peaks as jax_find_peaks
    from crog_tpu_torch.ops.peaks import find_peaks

    q = np.zeros((5, 24, 30), np.float32)
    q[0, 5, 7] = q[0, 15, 20] = 0.9
    q[1, 8:11, 8:11] = 0.7
    q[1, 0, 3] = 1.0
    q[2] = 0.1
    q[3] = 0.5  # constant: skimage's trivial-image rule gives no peaks
    q[4, 12, 25] = 0.8  # outside sample 4's valid width of 24
    q[4, 12, 10] = 0.6
    hw = np.array([[24, 30]] * 4 + [[24, 24]], np.int32)
    ref = jax_find_peaks(jnp.asarray(q), 5, valid_hw=jnp.asarray(hw))
    got = find_peaks(torch.from_numpy(q), 5, valid_hw=torch.from_numpy(hw))
    valid = np.asarray(ref[2])
    np.testing.assert_array_equal(got[2].numpy(), valid)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(r)[valid])
    assert valid[0].sum() == 2 and not valid[2:4].any()
