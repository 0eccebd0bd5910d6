"""The port's SSG slice against the JAX package, on the CPU in fp32, at a
tiny geometry (128^2, resnet_layers (1, 1, 1, 1), 8 classes,
masks_to_train 8): weights carried by ``ssg_state_dict_from_flax`` (and
back through ``convert_ssg_state_dict``), the forward in eval and train
mode, the 8 loss terms and every parameter's gradient with the same
positive priorities, one whole ``make_ssg_train_step`` step, the
post-processing in batched and batch-1 modes, and the synthetic data and
its collate.

Tolerances, each stated where it is used.  Eval-mode outputs to 1e-5 of
their scale (f32 convolutions in another order through ~20 layers).  Train
mode normalizes with batch statistics over 2 images, which amplifies
rounding: outputs to 1e-3 of their scale, the loss terms 1e-4 relative and
each gradient 2% relative L2 (plus 1e-6 of the global gradient norm), as
tests/test_torch_train.py holds CROG's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.data.ocid_grasp import collate_ssg as j_collate
from crog_tpu.data.synthetic_ssg import SyntheticOCIDGrasp as JData
from crog_tpu.engine import ssg_engine as JE
from crog_tpu.engine.crog_engine import TrainState
from crog_tpu.engine.optim import make_optimizer as j_optimizer
from crog_tpu.models import ssg_loss as JL
from crog_tpu.models.convert import convert_ssg_state_dict
from crog_tpu.models.ssg import SSG as JSSG
from crog_tpu.models.ssg_eval import make_ssg_post_processing as j_post
from crog_tpu_torch.data.ocid_grasp import collate_ssg
from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGrasp
from crog_tpu_torch.engine import ssg_engine as TE
from crog_tpu_torch.engine.optim import make_optimizer
from crog_tpu_torch.models import ssg_loss as TL
from crog_tpu_torch.models.convert import load_numpy_state_dict, ssg_state_dict_from_flax
from crog_tpu_torch.models.ssg import SSG
from crog_tpu_torch.models.ssg_eval import make_ssg_post_processing
from tests.torch_port_helpers import assert_close_scaled, randomize

IMG, CLASSES, K = 128, 8, 8
GEOM = dict(img_size=IMG, resnet_layers=(1, 1, 1, 1), num_classes=CLASSES)
DENSE = ("boxes", "labels", "obj_valid", "ins_masks", "grasp_qua", "grasp_sin",
         "grasp_cos", "grasp_wid")
T = torch.from_numpy


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(flax SSG, its randomized variables, the port's SSG with the same
    weights, a collated synthetic batch of 2), fp32."""
    batch = j_collate([JData(num_samples=2, img_size=IMG, num_classes=CLASSES, seed=3)[i]
                       for i in range(2)], max_objs=8)
    jm = JSSG(dtype=jnp.float32, **GEOM)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(batch["img"]), train=True)
    v = randomize(_tree_np(v))
    tm = SSG(**GEOM)
    load_numpy_state_dict(tm, ssg_state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm, batch


def test_synthetic_data_and_collate_match_jax():
    """The port's synthetic scenes and legacy collate give the JAX
    package's arrays bit for bit."""
    ref = j_collate([JData(num_samples=3, img_size=96, num_classes=CLASSES, seed=5)[i]
                     for i in range(3)], max_objs=6)
    ds = SyntheticOCIDGrasp(num_samples=3, img_size=96, num_classes=CLASSES, seed=5)
    got = collate_ssg([ds[i] for i in range(3)], max_objs=6)
    assert set(got) == set(ref)
    for k, r in ref.items():
        if k == "ins_grasp_rects":
            for gs, rs in zip(got[k], r):
                for g, x in zip(gs, rs):
                    np.testing.assert_array_equal(g, x)
        else:
            np.testing.assert_array_equal(got[k], r, err_msg=k)


def test_state_dict_round_trip_through_convert_ssg(pair):
    """ssg_state_dict_from_flax then convert_ssg_state_dict(strict=True)
    gives back the flax trees; the port's module names are the reference
    schema (a strict load of the same dict)."""
    _, v, tm, _ = pair
    sd = ssg_state_dict_from_flax(v["params"], v["batch_stats"])
    params, stats = convert_ssg_state_dict(sd, strict=True)
    ref_p, ref_s = v["params"], v["batch_stats"]
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(ref_p)
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(ref_s)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(ref_p)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(ref_s)):
        np.testing.assert_array_equal(a, b)
    assert set(tm.state_dict()) == set(sd)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(pair, train):
    """Every output's shape, dtype and values; anchors identical."""
    jm, v, tm, batch = pair
    tm = copy.deepcopy(tm)
    np.testing.assert_array_equal(tm.anchors(), jm.anchors())
    img = batch["img"]
    if train:
        ref, mut = jm.apply(v, jnp.asarray(img), train=True, mutable=["batch_stats"])
        got = tm.train()(T(img))
        tol = 1e-3  # batch statistics over 2 images
    else:
        ref = jm.apply(v, jnp.asarray(img), train=False)
        got = tm.eval()(T(img))
        tol = 1e-5
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].dtype == torch.float32, k
        assert_close_scaled(got[k].detach().numpy(), np.asarray(r), tol, k)
    if train:  # the running statistics moved as flax's did
        new = ssg_state_dict_from_flax(v["params"], _tree_np(mut["batch_stats"]))
        for name, buf in tm.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                assert_close_scaled(buf.numpy(), new[name], 1e-5, name)


def test_bf16_train_outputs_keep_coefficients_in_compute_dtype(pair):
    _, _, tm, batch = pair
    tm = copy.deepcopy(tm)
    tm.dtype = torch.bfloat16
    out = tm.train()(T(batch["img"]))
    assert out["ins_coef_pred"].dtype == torch.bfloat16
    assert out["grasp_coef_pred"].dtype == torch.bfloat16
    assert out["protos"].dtype == out["seg_pred"].dtype == torch.float32


def _jax_losses_and_grads(jm, v, batch, rng):
    dense = {k: jnp.asarray(batch[k]) for k in DENSE}
    anchors = jnp.asarray(jm.anchors())

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(batch["img"]), train=True, mutable=["batch_stats"])
        total, d = JL.ssg_losses(out, dense, anchors, rng, masks_to_train=K)
        return total, d

    (total, d), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return float(total), {k: float(x) for k, x in d.items()}, _tree_np(grads)


def _priority(rng, batch, n):
    """The positives' priorities the JAX package draws from ``rng``."""
    return torch.tensor(np.array(jax.random.uniform(rng, (len(batch["img"]), n))))


def test_losses_and_gradients_match_jax(pair):
    """ssg_losses' 8 terms and the gradient of every parameter, through the
    train-mode forward, with the JAX package's positives."""
    jm, v, tm, batch = pair
    tm = copy.deepcopy(tm).train()
    rng = jax.random.PRNGKey(7)
    ref_total, ref_d, jgrads = _jax_losses_and_grads(jm, v, batch, rng)
    anchors = T(jm.anchors())
    out = tm(T(batch["img"]))
    total, d = TL.ssg_losses(out, {k: T(batch[k]) for k in DENSE}, anchors,
                             priority=_priority(rng, batch, len(anchors)), masks_to_train=K)
    assert set(d) == set(ref_d) and len(d) == 8
    # f32 sums in another order through batch-statistics BatchNorm
    np.testing.assert_allclose(total.item(), ref_total, rtol=1e-4)
    for k, r in ref_d.items():
        np.testing.assert_allclose(d[k].item(), r, rtol=1e-4, err_msg=k)
    total.backward()
    gref = ssg_state_dict_from_flax(jgrads, jax.tree_util.tree_map(np.zeros_like,
                                                                   v["batch_stats"]))
    gnorm = np.sqrt(sum(float(np.sum(np.square(g)))
                        for g in jax.tree_util.tree_leaves(jgrads)))
    checked = 0
    for name, p in tm.named_parameters():
        err = np.linalg.norm(p.grad.numpy() - gref[name])
        assert err <= 2e-2 * np.linalg.norm(gref[name]) + 1e-6 * gnorm, name
        checked += 1
    assert checked == len(jax.tree_util.tree_leaves(jgrads))


def test_train_step_matches_jax(pair):
    """One make_ssg_train_step step (AdamW, weight decay 5e-4): the loss
    terms, every parameter update and the BatchNorm statistics against the
    JAX step with the same positives."""
    jm, v, tm, batch = pair
    tm = copy.deepcopy(tm)
    lr, wd = 3e-4, 5e-4
    tx = j_optimizer(v["params"], lr, 1.0, [100], 0.95, 10, weight_decay=wd,
                     optimizer="adamw")
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              batch_stats=v["batch_stats"], tx=tx)
    rng = jax.random.PRNGKey(1)
    new_state, jm_metrics = JE.make_ssg_train_step(jm, tx, jm.anchors(),
                                                   {"masks_to_train": K})(state, batch, rng)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    opt, sched = make_optimizer(tm, lr, 1.0, [100], 0.95, 10, weight_decay=wd)
    step = TE.make_ssg_train_step(tm, opt, sched, jm.anchors(), {"masks_to_train": K},
                                  device="cpu")
    prio = _priority(rng, batch, len(jm.anchors()))
    monkey = pytest.MonkeyPatch()
    monkey.setattr(TL, "draw_priority", lambda shape, generator=None: prio)
    try:
        metrics = step(batch)
    finally:
        monkey.undo()
    for k, r in jm_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(r), rtol=1e-4, err_msg=k)
    new = ssg_state_dict_from_flax(_tree_np(new_state.params),
                                   _tree_np(new_state.batch_stats))
    for name, p in tm.named_parameters():
        # Adam's first update is about lr * sign(g), and the gradients agree
        # to about 1% of their scale (test_losses_and_gradients_match_jax):
        # a gradient below that may flip its sign and its update by 2 lr
        # (+ decay).  Where it is above a tenth of the parameter's largest
        # gradient, the updates agree
        upd = (p.detach() - before[name]).numpy()
        err = np.abs(upd - (new[name] - before[name].numpy()))
        assert err.max() <= 2 * lr * (1 + 1e-3), name
        g = np.abs(p.grad.numpy())
        real = g > 0.1 * g.max()  # none where the gradient is 0 (a dead ReLU)
        assert not real.any() or err[real].mean() <= 0.05 * lr, name
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert_close_scaled(buf.numpy(), new[name], 1e-5, name)


def _outputs(seed, b=2):
    """A seeded eval-mode output dict at 128^2 whose class scores clear the
    0.3 keep threshold for a few anchors."""
    anchors = JSSG(**GEOM).anchors()
    n = len(anchors)
    r = np.random.RandomState(seed)
    logits = r.randn(b, n, CLASSES).astype(np.float32)
    logits[:, r.choice(n, 30, replace=False), r.randint(1, CLASSES)] += 4.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return anchors, {
        "protos": np.maximum(r.randn(b, 32, 32, 32), 0).astype(np.float32),
        "cls_pred": (e / e.sum(-1, keepdims=True)).astype(np.float32),
        "box_pred": (r.randn(b, n, 4) * 0.5).astype(np.float32),
        "ins_coef_pred": np.tanh(r.randn(b, n, 32)).astype(np.float32),
        "grasp_coef_pred": np.tanh(r.randn(b, n, 4, 32)).astype(np.float32),
    }


POST_KW = dict(ori_hw=(IMG, IMG), max_detections=10, top_k=20)


def _compare_post(got, ref):
    for k in ("cls", "det_valid", "grasp_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("scores", "bboxes", "grasp_rects"):
        assert_close_scaled(got[k].numpy(), np.asarray(ref[k]), 1e-5, k)
    # a mask pixel whose f32 probability sits on 0.5 may flip
    diff = (got["ins_masks"].numpy() != np.asarray(ref["ins_masks"])).mean()
    assert diff <= 1e-4, diff


@pytest.mark.parametrize("batched", [True, False])
def test_post_processing_matches_jax(batched):
    """Fast-NMS, mask assembly and grasp peaks on the same outputs; the
    batch-1 mode per sample, with its full-resolution maps."""
    anchors, out = _outputs(0)
    if batched:
        ref = j_post(anchors, batched=True, **POST_KW)({k: jnp.asarray(x) for k, x in out.items()})
        got = make_ssg_post_processing(anchors, batched=True, **POST_KW)(
            {k: T(x) for k, x in out.items()})
        assert got["det_valid"].any()
        _compare_post(got, ref)
        return
    jp, tp = j_post(anchors, **POST_KW), make_ssg_post_processing(anchors, **POST_KW)
    for i in range(2):
        ref = jp({k: jnp.asarray(x[i:i + 1]) for k, x in out.items()})
        got = tp({k: T(x[i:i + 1]) for k, x in out.items()})
        _compare_post(got, ref)
        for g, r in zip(got["grasp_masks"], ref["grasp_masks"]):
            assert_close_scaled(g.numpy(), np.asarray(r), 1e-5)
    with pytest.raises(ValueError, match="batched=True"):
        tp({k: T(x) for k, x in out.items()})


def test_validate_counts_objects_like_jax(pair):
    """validate's per-object J@1/J@5 over the synthetic val batch, the same
    detections fed to both engines."""
    _, _, _, batch = pair
    anchors, out = _outputs(1)
    args = type("A", (), {"epochs": 1})()
    jres = JE.validate([batch], j_post(anchors, batched=True, **POST_KW),
                       lambda v, b: ({k: jnp.asarray(x) for k, x in out.items()}, None),
                       None, 1, args)
    tres = TE.validate([batch], make_ssg_post_processing(anchors, batched=True, **POST_KW),
                       lambda b: ({k: T(x) for k, x in out.items()}, None), 1, args)
    assert tres == jres
