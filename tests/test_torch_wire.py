"""The port's wire formats against the JAX package, on the CPU: the compact
tables (crog_tpu_torch/data/compact.py), the raw wire's mask bits, raster
parameters, rasterizer and device unpack (crog_tpu_torch/data/rawwire.py),
the engine's dispatch, and one tiny-CROG train step and eval step on a rawlb
batch with the s2d stem through the K6/K6b twins (``fused_stem``) against
``crog_tpu``'s ``make_train_step`` / ``make_eval_step``.

Tolerances: table lookups, bit unpacking and the int32 rasterizer are held
bit-exact; the raw unpack's warps are f32 matrix products summed in another
order, held to 1e-5 of each plane's largest magnitude against the JAX
unpack, and to the legacy path's uint8 quantizations (about 2/255 on the
targets) against the legacy host pipeline.  The train and eval steps are
held as in tests/test_torch_train.py and tests/test_torch_crog.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.data import rawwire as JR
from crog_tpu.data.compact import unpack_compact as jax_unpack_compact
from crog_tpu.engine import crog_engine as JE
from crog_tpu.engine import optim as JO
from crog_tpu.models import crog as JM
from crog_tpu_torch.data import rawwire as TR
from crog_tpu_torch.data.compact import unpack_compact, unpack_compact_host
from crog_tpu_torch.data.loader import DataLoader, collate_crog, device_put_crog
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG
from crog_tpu_torch.engine import optim as TO
from crog_tpu_torch.engine.crog_engine import make_eval_step, make_train_step
from crog_tpu_torch.models import crog as TM
from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax
from tests.torch_port_helpers import GEOMETRY, RES, TINY, assert_close_scaled, inputs, randomize

ORI = (120, 160)
S = 64
TARGETS = ("mask", "qua", "wid", "sin", "cos")


def _rects(seed, m):
    r = np.random.RandomState(seed)
    return np.stack([r.uniform(20, ORI[1] - 20, m), r.uniform(20, ORI[0] - 20, m),
                     r.uniform(10, 60, m), r.uniform(8, 25, m), r.uniform(-89, 89, m),
                     np.ones(m)], axis=1)


def test_rasterize_bit_identical_to_jax():
    """Three samples of 1-5 random rects (padded to 8) and one pair that
    overlaps, so a later rect overwrites an earlier one."""
    sets = [_rects(s, m) for s, m in ((0, 5), (1, 3), (2, 1))]
    sets.append(np.asarray([[50, 50, 40, 16, 10, 1], [55, 52, 30, 14, -30, 1]], np.float64))
    packed = [TR.pack_raster_params(r, 8) for r in sets]
    for (c, v), r in zip(packed, sets):
        jc, jv = JR.pack_raster_params(r, 8)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(v, jv)
    corners = np.stack([c for c, _ in packed])
    vals = np.stack([v for _, v in packed])
    ref = JR._rasterize(jnp.asarray(corners), jnp.asarray(vals), *ORI)
    got = TR._rasterize(torch.from_numpy(corners), torch.from_numpy(vals), *ORI)
    for name, g, r in zip(("pos", "ang", "wid"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert (got[1][3] > 0).sum() > 0


def test_pack_raster_params_keeps_last():
    rects = np.stack([np.full(6, i, np.float64) + [50, 50, 20, 10, 0, 1] for i in range(6)])
    corners, vals = TR.pack_raster_params(rects, 4)
    assert vals[:, 2].sum() == 4
    np.testing.assert_array_equal(corners[3], TR.pack_raster_params(rects[5:6], 4)[0][0])


@pytest.mark.parametrize("w", [160, 157, 153])
def test_mask_bits_round_trip(w):
    """Every width remainder mod 8, unbatched and batched; the bits equal
    the JAX package's and unpack like its ``unpack_mask_bits``."""
    m = (np.random.RandomState(w).rand(9, w) > 0.5).astype(np.uint8) * 255
    bits = TR.pack_mask_bits(m)
    np.testing.assert_array_equal(bits, JR.pack_mask_bits(m))
    assert bits.shape == (9, (w + 7) // 8) and bits.dtype == np.uint8
    np.testing.assert_array_equal(TR.unpack_mask_bits(torch.from_numpy(bits), w).numpy(),
                                  m // 255)
    batched = TR.unpack_mask_bits(torch.from_numpy(bits)[None], w)[0]
    np.testing.assert_array_equal(batched.numpy(), np.asarray(JR.unpack_mask_bits(
        jnp.asarray(bits)[None], w))[0])


def test_pack_mask_bits_rejects_non_binary():
    m = np.zeros((4, 16), np.uint8)
    m[1, 3] = 7
    with pytest.raises(ValueError, match="binary"):
        TR.pack_mask_bits(m)


def test_unpack_compact_bit_exact():
    """The compact batch unpacks to the legacy batch bit for bit, on the
    device path and the host twin, and equals the JAX package's unpack."""
    legacy = collate_crog([SyntheticOCIDVLG(8, input_size=S)[i] for i in range(3)])
    comp = collate_crog([SyntheticOCIDVLG(8, input_size=S, compact=True)[i] for i in range(3)])
    got = unpack_compact(device_put_crog(comp, ("img_u8", "planes_u8", "word"), "cpu"))
    host = unpack_compact_host(comp)
    ref = jax_unpack_compact({k: jnp.asarray(comp[k]) for k in ("img_u8", "planes_u8")})
    for k in ("img", "mask", "qua", "wid", "ang", "sin", "cos"):
        np.testing.assert_array_equal(got[k].numpy(), legacy[k], err_msg=k)
        np.testing.assert_array_equal(host[k], legacy[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(ref[k]), legacy[k], err_msg=k)


@pytest.mark.parametrize("raw", [True, "lb"])
def test_unpack_raw_matches_jax_and_legacy(raw):
    """raw (image warped on the device) and rawlb (image letterboxed on the
    host): the port's unpack against the JAX package's on the same packed
    batch, and against the legacy host pipeline within its quantization
    epsilon; rawlb's image is bit-exact legacy."""
    legacy = collate_crog([SyntheticOCIDVLG(4, input_size=S, ori_hw=ORI)[i] for i in range(2)])
    ds = SyntheticOCIDVLG(4, input_size=S, ori_hw=ORI, raw=raw)
    batch = collate_crog([ds[i] for i in range(2)])
    keys = [k for k in TR.RAW_KEYS if k in batch] + ["word", "inverse", "ori_size"]
    got = TR.unpack_raw(device_put_crog(batch, keys, "cpu"), S)
    ref = JR.unpack_raw({k: jnp.asarray(batch[k]) for k in keys}, S)
    for k in ("img",) + TARGETS + ("ang",):
        g = got[k].numpy()
        assert g.shape == np.asarray(ref[k]).shape, k
        assert_close_scaled(g, np.asarray(ref[k]), 1e-5, k)
    np.testing.assert_array_equal(got["word"].numpy(), legacy["word"])
    if raw == "lb":
        np.testing.assert_array_equal(got["img"].numpy(), legacy["img"])
    else:
        assert np.abs(got["img"].numpy() - legacy["img"]).max() < 0.12
    for k, atol in (("mask", 0.06), ("qua", 0.03), ("wid", 0.03), ("sin", 0.2), ("cos", 0.2)):
        d = np.abs(got[k].numpy() - legacy[k])
        assert d.max() < atol and d.mean() < atol / 10, (k, d.max())


def test_device_put_crog_keeps_only_dense_keys():
    batch = collate_crog([SyntheticOCIDVLG(2, input_size=S, raw="lb")[i] for i in range(2)])
    out = device_put_crog(batch, ("lb_img_u8", "raw_mask_bits", "word", "img"), "cpu")
    assert set(out) == {"lb_img_u8", "raw_mask_bits", "word"}
    assert out["lb_img_u8"].dtype == torch.uint8
    np.testing.assert_array_equal(out["word"].numpy(), batch["word"])


# ------------------------------------------- the tiny CROG on a rawlb batch
@pytest.fixture(scope="module")
def tiny_s2d():
    """(flax CROG with the s2d stem through XLA, dropout 0, its randomized
    variables, the port's CROG with the same weights and ``fused_stem``)."""
    cfg = {**TINY, "dropout": 0.0}
    jm = JM.CROG(dtype=jnp.float32, stem_s2d=True, **GEOMETRY, **cfg)
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)),
        jnp.zeros((1, TINY["word_len"]), jnp.int32), train=False)
    v = randomize(jax.tree_util.tree_map(np.asarray, v))
    tm = TM.CROG(stem_s2d=True, fused_stem=True, **GEOMETRY, **cfg)
    load_numpy_state_dict(tm, state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm


def _rawlb_batch(split, n, noise: bool):
    batch = next(iter(DataLoader(
        SyntheticOCIDVLG(n, split=split, input_size=RES, raw="lb"), n,
        collate_fn=collate_crog)))
    # for the train step random pixels and unlike sentences, as
    # tests/test_torch_train.py feeds: the synthetic scenes' flat colour
    # fields leave the stem's train-mode BatchNorm over 2 samples
    # ill-conditioned (its gradients then move by ~1% between two fp32
    # summation orders of the same conv)
    if noise:
        rng = np.random.RandomState(42)
        batch["lb_img_u8"] = rng.randint(0, 256, batch["lb_img_u8"].shape).astype(np.uint8)
        batch["word"] = inputs(n)[1]
    return batch


def test_rawlb_train_step_matches_jax(tiny_s2d):
    """One train step of the tiny CROG on a rawlb batch (unpacked on the
    device; conv2/conv3 of the s2d stem through the K6/K6b twins): loss
    terms, metrics, every parameter's gradient and the BatchNorm statistics
    against ``crog_tpu``'s jitted step, tolerances of test_train_step_matches_jax."""
    jm, v, tm = tiny_s2d
    tm = copy.deepcopy(tm)
    batch = _rawlb_batch("train", 2, noise=True)
    assert "lb_img_u8" in batch and "img" not in batch
    tx = JO.make_optimizer(v["params"], 1e-3, 0.1, [5], 0.1, 1)
    state = JE.TrainState.create(apply_fn=jm.apply, params=v["params"],
                                 batch_stats=v["batch_stats"], tx=tx)
    jstep = JE.make_train_step(jm, tx)
    jdense = {k: jnp.asarray(batch[k]) for k in JE._TRAIN_KEYS_R if k in batch}

    def loss_fn(params):
        b = JE._unpack(jdense, RES)
        preds, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            b["img"], b["word"], train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return JM.crog_losses(preds, {k: b[k] for k in ("mask", "qua", "sin", "cos", "wid")})[0]

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(v["params"]))
    new_state, jmetrics = jstep(state, batch, jax.random.PRNGKey(0))
    opt, sched = TO.make_optimizer(tm, 1e-3, 0.1, [5], 0.1, 1)
    metrics = make_train_step(tm, opt, sched, device="cpu")(batch)
    for k in ("loss", "m_ins", "m_qua", "m_sin", "m_cos", "m_wid"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["iou"].item(), float(jmetrics["iou"]), atol=0.05)
    stats0 = jax.tree_util.tree_map(np.zeros_like, v["batch_stats"])
    gref = state_dict_from_flax(jgrads, stats0)
    gnorm = np.sqrt(sum(float(np.sum(g * g)) for g in jax.tree_util.tree_leaves(jgrads)))
    checked = 0
    for name, p in tm.named_parameters():
        if p.requires_grad:
            err = np.linalg.norm(p.grad.numpy() - gref[name])
            assert err <= 2e-2 * np.linalg.norm(gref[name]) + 1e-6 * gnorm, f"grad {name}"
            checked += 1
    assert checked == len(list(tm.parameters())) - 1
    new = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_state.params),
                               jax.tree_util.tree_map(np.asarray, new_state.batch_stats))
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            tol = 1e-3 if name.startswith("neck.norm_layer") else 1e-5
            assert_close_scaled(buf.numpy(), new[name], tol, name)


def test_rawlb_eval_step_matches_jax(tiny_s2d):
    """The eval step on a rawlb batch (unpacked on the device, the s2d stem
    through the twins) against ``crog_tpu``'s: IoU, peak positions and rects,
    as tests/test_torch_crog.py holds the legacy eval step."""
    jm, v, tm = tiny_s2d
    batch = _rawlb_batch("val", 3, noise=False)
    ref = JE.make_eval_step(jm, input_size=RES)(v, batch)
    got = make_eval_step(copy.deepcopy(tm).eval(), input_size=RES, device="cpu")(batch)
    np.testing.assert_allclose(got["iou"].numpy(), np.asarray(ref["iou"]), rtol=0, atol=1e-3)
    valid = np.asarray(ref["rects_valid"])
    np.testing.assert_array_equal(got["rects_valid"].numpy(), valid)
    g, r = got["rects"].numpy()[valid], np.asarray(ref["rects"])[valid]
    np.testing.assert_array_equal(g[:, :2], r[:, :2])
    if len(r):
        assert_close_scaled(g, r, 1e-3)


def test_train_step_same_on_legacy_and_compact(tiny_s2d):
    """The compact batch unpacks bit-exactly to the legacy one, so one train
    step gives the same loss from either."""
    _, _, tm = tiny_s2d
    losses = []
    for kw in ({}, {"compact": True}):
        ds = SyntheticOCIDVLG(2, split="train", input_size=RES, **kw)
        batch = collate_crog([ds[0], ds[1]])
        batch["word"] = inputs(2)[1]
        model = copy.deepcopy(tm)
        opt, sched = TO.make_optimizer(model, 1e-3, 0.1, [5], 0.1, 1)
        losses.append(make_train_step(model, opt, sched, device="cpu")(batch)["loss"].item())
    assert losses[0] == losses[1]
