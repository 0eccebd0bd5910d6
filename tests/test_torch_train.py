"""The port's training slice against the JAX package, on the CPU in fp32:
train-mode BatchNorm, the losses and batch metrics, the optimizer (param
groups, schedule, Adam / AdamW / clipping), the epoch sampler, checkpoints,
and one whole train step of the tiny CROG against
``crog_tpu.engine.crog_engine.make_train_step`` (dropout 0: the port's
counter-based masks cannot reproduce flax's draws).

Tolerances (fp32), each stated where it is used: elementwise and reduction
results to a few ulps (1e-6 .. 1e-5 of their scale).  The whole step is
held looser, because train-mode BatchNorm makes the tiny random network's
gradients ill-conditioned: with batch statistics over 2 samples (and
E[x^2] - E[x]^2 variances), a perturbation of the input image in its last
float32 bits moves the JAX package's own gradients by a few tenths of a
percent (relative L2 per parameter), about as much as the port differs
from it, while with BatchNorm on running statistics the two agree to a
few float32 ulps.  So each gradient is held to 2% relative L2 (plus 1e-6
of the global gradient norm, for gradients that are zero up to rounding),
the Adam update (lr * g / (|g| + eps), about lr * sign(g)) to 2 lr where
a near-zero gradient's sign flips and 0.05 lr on average.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.data.loader import EpochSampler as JaxEpochSampler
from crog_tpu.engine import crog_engine as JE
from crog_tpu.engine import optim as JO
from crog_tpu.models import crog as JM
from crog_tpu_torch.data.loader import DataLoader, EpochSampler
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG
from crog_tpu_torch.engine import checkpoint as ckpt
from crog_tpu_torch.engine import optim as TO
from crog_tpu_torch.engine.crog_engine import make_train_step, train_metrics
from crog_tpu_torch.models import crog as TM
from crog_tpu_torch.models.clip import BatchNorm
from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax
from tests.torch_port_helpers import (
    GEOMETRY,
    RES,
    TINY,
    assert_close_scaled,
    randomize,
    train_batch,
)

T = torch.from_numpy


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (2, 6)])
def test_train_batchnorm_matches_flax(shape):
    """NHWC and [B, C] (the FPN's txt_proj at B=2, where biased and
    unbiased variances differ 2x): output and updated running stats."""
    import flax.linen as nn

    c = shape[-1]
    x = _rand(0, *shape, scale=2.0) + 0.5
    scale, bias = 1 + _rand(1, c, scale=0.1), _rand(2, c, scale=0.1)
    mean0, var0 = _rand(3, c, scale=0.1), 0.5 + np.random.RandomState(4).rand(c)
    fb = nn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0.astype(np.float32)}}
    ref, mut = fb.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    cot = _rand(5, *shape)

    def f(x, params):
        y, _ = fb.apply({**variables, "params": params}, x, mutable=["batch_stats"])
        return jnp.vdot(y, cot)

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), variables["params"])
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(mean0))
        bn.running_var.copy_(T(var0))
    xt = T(x).requires_grad_()
    got = bn.train()(xt)
    dx, dw, db = torch.autograd.grad(got, (xt, bn.weight, bn.bias), T(cot))
    assert_close_scaled(got.detach().numpy(), np.asarray(ref), 1e-6)
    # dx to 1e-5 of the cotangent's scale: at B=2 the normalized pair is
    # +-1 whatever x is, so dx is zero up to rounding there
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=0,
                               atol=1e-5 * np.abs(cot).max(), err_msg="dx")
    assert_close_scaled(dw.numpy(), np.asarray(gp["scale"]), 1e-5, "dscale")
    assert_close_scaled(db.numpy(), np.asarray(gp["bias"]), 1e-5, "dbias")
    assert_close_scaled(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), 1e-6)
    assert_close_scaled(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), 1e-6)


# --------------------------------------------------------------- losses
@pytest.mark.parametrize("grasp", [True, False])
def test_losses_and_metrics_match_jax(grasp):
    """Targets at 4x the prediction size, resized by nearest inside."""
    b, s = 2, 16
    preds = _rand(0, b, s, s, 5, scale=2.0)
    r = np.random.RandomState(1)
    targets = {"mask": (r.rand(b, 4 * s, 4 * s) > 0.6).astype(np.float32)}
    for k in ("qua", "sin", "cos", "wid"):
        targets[k] = r.randn(b, 4 * s, 4 * s).astype(np.float32)
    ref_total, ref_dict = JM.crog_losses(jnp.asarray(preds),
                                         {k: jnp.asarray(v) for k, v in targets.items()}, grasp)
    total, loss_dict = TM.crog_losses(T(preds), {k: T(v) for k, v in targets.items()}, grasp)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-6)
    assert set(loss_dict) == set(ref_dict)
    for k, v in ref_dict.items():
        np.testing.assert_allclose(loss_dict[k].item(), float(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    small = targets["mask"][:, ::4, ::4]
    ref_iou, ref_pr = JE.train_metrics(jnp.asarray(preds[..., 0]), jnp.asarray(small))
    iou, pr = train_metrics(T(preds[..., 0]), T(small))
    np.testing.assert_allclose([iou.item(), pr.item()], [float(ref_iou), float(ref_pr)],
                               rtol=1e-6)


# ------------------------------------------------------------ optimizer
@pytest.fixture(scope="module")
def tiny():
    """(flax CROG with dropout 0, its randomized variables, the port's CROG
    holding the same weights), fp32."""
    cfg = {**TINY, "dropout": 0.0}
    jm = JM.CROG(dtype=jnp.float32, **GEOMETRY, **cfg)
    img = jnp.zeros((1, RES, RES, 3), jnp.float32)
    word = jnp.zeros((1, TINY["word_len"]), jnp.int32)
    v = jax.jit(jm.init, static_argnames=("train",))(jax.random.PRNGKey(0), img, word,
                                                    train=False)
    v = randomize(jax.tree_util.tree_map(np.asarray, v))
    tm = TM.CROG(**GEOMETRY, **cfg)
    load_numpy_state_dict(tm, state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm


def test_param_groups_match_param_group_label(tiny):
    """Every leaf's group in the port equals the JAX package's label for the
    flax leaf it was carried from; logit_scale is in no group."""
    _, v, tm = tiny
    flags = jax.tree_util.tree_map_with_path(
        lambda p, _: np.full(np.shape(_), JO.param_group_label(p) == "backbone",
                             np.float32), v["params"])
    sd = state_dict_from_flax(flags, jax.tree_util.tree_map(np.zeros_like, v["batch_stats"]))
    opt, _ = TO.make_optimizer(tm, 1e-4, 0.1, [1], 0.1, 1)
    group_of = {id(p): g["name"] for g in opt.param_groups for p in g["params"]}
    names = 0
    for name, p in tm.named_parameters():
        if name == "backbone.logit_scale":
            assert id(p) not in group_of and not p.requires_grad
            continue
        want = "backbone" if sd[name].all() else "rest"
        assert sd[name].all() or not sd[name].any(), name
        assert group_of[id(p)] == want, name
        names += 1
    # each of the 4 attention layers (2 text blocks, 2 in the decoder layer)
    # packs 6 flax leaves (q/k/v kernels and biases) into 2
    assert names == len(jax.tree_util.tree_leaves(v["params"])) - 4 * 4


def test_lr_schedule_matches_optax_at_boundaries():
    milestones, gamma, spe, lr = [2, 5], 0.1, 3, 1e-3
    ref = JO.multistep_schedule(lr, milestones, gamma, spe)
    fn = TO.multistep_factor(milestones, gamma, spe)
    for step in (0, 5, 6, 7, 14, 15, 16, 40):
        np.testing.assert_allclose(lr * fn(step), float(ref(step)), rtol=1e-6, err_msg=step)


@pytest.mark.parametrize("kind", ["adam", "adamw", "clipped"])
def test_update_matches_optax(kind):
    """Three updates on a random two-group tree, with a milestone after the
    second, against optax's chain."""
    r = np.random.RandomState(0)
    params = {"backbone": {"w": r.randn(4, 3).astype(np.float32)},
              "neck": {"w": r.randn(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda x: (r.randn(*x.shape) * 3).astype(np.float32),
                                    params) for _ in range(3)]
    wd = 0.01 if kind == "adamw" else 0.0
    max_norm = 1.0 if kind == "clipped" else 0.0
    tx = JO.make_optimizer(params, 1e-2, 0.1, [2], 0.5, 1, weight_decay=wd,
                           max_norm=max_norm)
    st, p = tx.init(params), params
    for g in grads:
        upd, st = tx.update(g, st, p)
        p = optax.apply_updates(p, upd)

    model = torch.nn.Module()
    model.backbone = torch.nn.Module()
    model.neck = torch.nn.Module()
    model.backbone.w = torch.nn.Parameter(T(params["backbone"]["w"].copy()))
    model.neck.w = torch.nn.Parameter(T(params["neck"]["w"].copy()))
    opt, sched = TO.make_optimizer(model, 1e-2, 0.1, [2], 0.5, 1, weight_decay=wd)
    for g in grads:
        model.backbone.w.grad = T(g["backbone"]["w"].copy())
        model.neck.w.grad = T(g["neck"]["w"].copy())
        if max_norm:
            TO.clip_by_global_norm_(list(model.parameters()), max_norm)
        opt.step()
        sched.step()
    np.testing.assert_allclose(model.backbone.w.detach().numpy(), p["backbone"]["w"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(model.neck.w.detach().numpy(), p["neck"]["w"], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("epoch,drop_last", [(0, True), (3, True), (1, False)])
def test_epoch_sampler_order_matches_jax(epoch, drop_last):
    ref = JaxEpochSampler(23, shuffle=True, seed=5, drop_last=drop_last, batch_size=4)
    got = EpochSampler(23, shuffle=True, seed=5, drop_last=drop_last, batch_size=4)
    ref.set_epoch(epoch)
    got.set_epoch(epoch)
    assert list(got.batches()) == list(ref.batches())
    assert len(got) == len(ref)


def test_shuffle_loader_collates_train_batches():
    loader = DataLoader(SyntheticOCIDVLG(num_samples=5, split="train", input_size=64),
                        2, shuffle=True, drop_last=True, seed=1)
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert batches[0]["img"].shape == (2, 64, 64, 3)
    for k in ("mask", "qua", "sin", "cos", "wid", "word"):
        assert len(batches[0][k]) == 2, k


# ------------------------------------------------------ whole train step
def test_train_step_matches_jax(tiny):
    """One step of the tiny CROG: loss and loss dict, iou/prec@50, every
    parameter's gradient (the flax grad tree carried to torch layout by
    ``state_dict_from_flax``), the updated params and BatchNorm stats."""
    jm, v, tm = tiny
    tm = copy.deepcopy(tm)
    batch = train_batch()
    lr, lr_multi = 1e-3, 0.1
    dense = {k: jnp.asarray(batch[k]) for k in JE._TRAIN_KEYS}
    targets = {k: dense[k] for k in ("mask", "qua", "sin", "cos", "wid")}

    def loss_fn(params):
        preds, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            dense["img"], dense["word"], train=True,
                            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JM.crog_losses(preds, targets)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(v["params"])
    tx = JO.make_optimizer(v["params"], lr, lr_multi, [5], 0.1, 1)
    state = JE.TrainState.create(apply_fn=jm.apply, params=v["params"],
                                 batch_stats=v["batch_stats"], tx=tx)
    new_state, jmetrics = JE.make_train_step(jm, tx)(state, batch, jax.random.PRNGKey(0))

    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    opt, sched = TO.make_optimizer(tm, lr, lr_multi, [5], 0.1, 1)
    metrics = make_train_step(tm, opt, sched, device="cpu")(batch)

    # the loss terms are means over 2 x 32 x 32 pixels of logits that reach
    # ~200 at these random weights: fp32 sums in another order, 1e-4 relative
    for k in ("loss", "m_ins", "m_qua", "m_sin", "m_cos", "m_wid"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    # IoU thresholds the mask at 0.35: a logit sitting on the threshold may
    # flip one pixel of a 32x32 map, which moves the batch IoU (x100) by
    # well under 0.05 here; Pr@50 must agree
    np.testing.assert_allclose(metrics["iou"].item(), float(jmetrics["iou"]), atol=0.05)
    assert metrics["prec@50"].item() == float(jmetrics["prec@50"])
    stats0 = jax.tree_util.tree_map(np.zeros_like, v["batch_stats"])
    gref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), stats0)
    new = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_state.params),
                               jax.tree_util.tree_map(np.asarray, new_state.batch_stats))
    gnorm = np.sqrt(sum(float(np.sum(np.square(g))) for g in
                        jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads))))
    checked = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            continue
        err = np.linalg.norm(p.grad.numpy() - gref[name])
        assert err <= 2e-2 * np.linalg.norm(gref[name]) + 1e-6 * gnorm, f"grad {name}"
        step_lr = lr * (lr_multi if TO.param_group_label(name) == "backbone" else 1.0)
        upd_err = np.abs((p.detach() - before[name]).numpy() - (new[name] - before[name].numpy()))
        assert upd_err.max() <= 2 * step_lr * (1 + 1e-3), f"update {name}"
        # where the gradient is zero up to rounding (the key bias of every
        # attention) the update is lr * sign(rounding noise): not compared
        real = np.abs(gref[name]) > 1e-6 * gnorm
        if real.any():
            assert upd_err[real].mean() <= 0.05 * step_lr, f"update {name}"
        checked += 1
    assert checked == len(before) - 1  # all but logit_scale
    # running stats: forward-only batch statistics, to 1e-5 of their scale,
    # except neck.norm_layer, which normalizes f5 * s with s the output of
    # the 2-sample txt_proj BatchNorm (measured 4e-4): 1e-3 there
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            tol = 1e-3 if name.startswith("neck.norm_layer") else 1e-5
            assert_close_scaled(buf.numpy(), new[name], tol, name)


# ---------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_and_optimizer_mismatch(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt, sched = TO.make_optimizer(model, 1e-3, 0.1, [1], 0.1, 2)
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    sched.step()
    path = ckpt.save_checkpoint(str(tmp_path), model, opt, 1, 1, 0.5, 0.25, {"Pr@50": 0.4})
    ckpt.copy_best(str(tmp_path), ckpt.LAST, ckpt.BEST_IOU)
    fresh = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    fopt, fsched = TO.make_optimizer(fresh, 1e-3, 0.1, [1], 0.1, 2)
    payload = ckpt.restore_checkpoint(str(tmp_path / ckpt.BEST_IOU), fresh, fopt)
    TO.set_schedule_step(fsched, payload["step"])
    assert payload["meta"]["best_iou"] == 0.5 and payload["step"] == 1
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    assert fopt.state_dict()["state"].keys() == opt.state_dict()["state"].keys()
    assert [g["lr"] for g in fopt.param_groups] == [g["lr"] for g in opt.param_groups]
    other = torch.optim.AdamW(fresh.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore_checkpoint(path, fresh, other)
