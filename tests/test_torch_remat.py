"""Activation checkpointing of the RN50 bottlenecks (``remat``) in the port
against the JAX package and against the port without it, on the CPU in
fp32 at the tiny geometry, dropout 0.

The JAX package wraps every bottleneck of layer1-layer4 in ``nn.remat``
(crog_tpu/models/clip.py:377-391): full, or ``"selective"``, which saves
only the conv outputs.  The port checkpoints the same blocks with
``torch.utils.checkpoint`` (``models/clip.py:checkpointed``), whose
recompute must neither update a BatchNorm's running statistics a second
time nor issue a second forward all-reduce (the two-rank case is
tests/test_torch_ddp.py::test_crog_train_step_on_two_ranks_matches_jax).

Tolerances, each stated where it is used: against the JAX package those of
tests/test_torch_train.py::test_train_step_matches_jax
(``assert_step_matches_jax``); against the port without remat, the
running statistics bit for bit (the forward is the same code on the same
values), the gradients to 1e-5 relative L2 (the recompute reruns the same
ops on the same inputs), the eval forward bit for bit.
"""

import copy
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.models import crog as JM
from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.models import clip
from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax
from crog_tpu_torch.models.crog import CROG, build_crog
from tests.torch_port_helpers import (
    GEOMETRY,
    RES,
    TINY,
    assert_step_matches_jax,
    inputs,
    jax_train_grads,
    port_train_step,
    randomize,
    train_batch,
)

CFG = {**TINY, "dropout": 0.0}
MODES = (True, "selective")
BLOCKS = sum(GEOMETRY["vision_layers"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small CPU steps: the suite runs
    several workers on the host's cores, where each worker's OpenMP team
    would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    """The flax CROG's randomized variables (numpy), initialized once: the
    remat variants hold the same parameter tree."""
    jm = JM.CROG(dtype=jnp.float32, **GEOMETRY, **CFG)
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3), jnp.float32),
        jnp.zeros((1, TINY["word_len"]), jnp.int32), train=False)
    return randomize(jax.tree_util.tree_map(np.asarray, v))


@pytest.fixture(scope="module")
def batch():
    return train_batch()


def _port(weights, remat):
    tm = CROG(**GEOMETRY, **CFG, remat=remat)
    load_numpy_state_dict(tm, state_dict_from_flax(weights["params"], weights["batch_stats"]))
    return tm


@pytest.fixture(scope="module")
def port_steps(weights, batch):
    """One port train step per remat mode on the same weights and batch:
    {mode: (loss, grads, buffers after)}."""
    return {mode: port_train_step(_port(weights, mode), batch)
            for mode in (False, *MODES)}


@pytest.mark.parametrize("mode", MODES)
def test_remat_train_step_matches_jax(weights, batch, port_steps, mode):
    """The port's step under ``remat`` against crog_tpu's CROG under the
    same ``remat``: the loss, every gradient, every running statistic."""
    jm = JM.CROG(dtype=jnp.float32, remat=mode, **GEOMETRY, **CFG)
    assert_step_matches_jax(port_steps[mode], jax_train_grads(jm, weights, batch))


@pytest.mark.parametrize("mode", MODES)
def test_remat_step_matches_the_step_without(port_steps, mode):
    """Against the port without remat: the loss and the running statistics
    bit for bit, each ``num_batches_tracked`` up by exactly 1 (a recompute
    that updated the statistics again would move them twice as far), the
    gradients to 1e-5 relative L2."""
    loss, grads, buffers = port_steps[mode]
    loss0, grads0, buffers0 = port_steps[False]
    assert loss == loss0
    assert list(buffers) == list(buffers0)
    for name, buf in buffers.items():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == 1, name  # 0 as carried from flax
        assert torch.equal(buf, buffers0[name]), name
    gnorm = float(torch.sqrt(sum(g.pow(2).sum() for g in grads0.values())))
    assert set(grads) == set(grads0)
    for name, g in grads.items():
        err = float((g - grads0[name]).norm())
        assert err <= 1e-5 * max(float(grads0[name].norm()), 1e-6 * gnorm), name


@pytest.fixture(scope="module")
def port_pair(weights):
    """(the port without remat, its eval logits on ``inputs``, the port
    built with ``remat=True``), the same weights."""
    off = _port(weights, False).eval()
    with torch.no_grad():
        logits = off(*(torch.from_numpy(a) for a in inputs()))
    return off, logits, _port(weights, True)


@pytest.mark.parametrize("mode", MODES)
def test_remat_keeps_eval_forward_and_state_dict(port_pair, mode):
    """The eval forward is bit-equal to the model's without remat, and the
    state_dicts hold the same keys in the same order: a checkpoint written
    with remat loads strictly into a model without, and back."""
    off, logits, on = port_pair
    on = copy.deepcopy(on).eval()
    on.backbone.visual.remat = mode
    assert list(on.state_dict()) == list(off.state_dict())
    on.load_state_dict(off.state_dict())
    copy.deepcopy(off).load_state_dict(on.state_dict())
    with torch.no_grad():
        assert torch.equal(on(*(torch.from_numpy(a) for a in inputs())), logits)


def _spy(monkeypatch):
    """Counts ``checkpointed`` calls and records, in forward passes (not
    recomputes), each op that selective remat's policy saves."""
    calls, saved = [], []
    run, policy = clip.checkpointed, clip._save_convs

    def checkpointed(block, x, remat):
        calls.append(remat)
        return run(block, x, remat)

    def save_convs(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return decision

    monkeypatch.setattr(clip, "checkpointed", checkpointed)
    monkeypatch.setattr(clip, "_save_convs", save_convs)
    return calls, saved


@pytest.mark.parametrize("mode", MODES)
def test_remat_checkpoints_only_bottlenecks_in_training(port_pair, monkeypatch, mode):
    """Train mode with grad: every bottleneck of layer1-layer4, and no
    other module, runs checkpointed; selective saves exactly the conv
    outputs (conv1, conv2, conv3 and the downsample conv of each block,
    crog_tpu's ``"bottleneck_conv"`` names).  An eval-mode forward, and a
    train-mode forward without grad, checkpoint nothing."""
    calls, saved = _spy(monkeypatch)
    tm = copy.deepcopy(port_pair[2]).train()
    tm.backbone.visual.remat = mode
    img, word = (torch.from_numpy(a) for a in inputs())
    tm(img, word).float().square().mean().backward()
    assert calls == [mode] * BLOCKS
    convs = sum(isinstance(m, clip.Conv2d) for b in tm.modules()
                if isinstance(b, clip.Bottleneck) for m in b.modules())
    assert saved == ([torch.ops.aten.convolution.default] * convs
                     if mode == "selective" else [])
    calls.clear()
    with torch.no_grad():
        tm(img, word)
        tm.eval()(img, word)
    assert calls == []


def test_build_crog_reads_remat_as_the_jax_package_does():
    """``build_crog`` takes ``bool(cfg.remat)`` (crog_tpu/models/crog.py:182):
    the configs' ``remat: False`` builds no remat, ``--opts remat True``
    full remat; a non-bool on the command line fails the config's type
    check, and an unknown mode raises in the constructor and at a forward,
    never running without recompute."""
    cfg = load_cfg_from_cfg_file("config/OCID-VLG/crog_synthetic_r50.yaml")
    assert build_crog(cfg).backbone.visual.remat is False
    on = build_crog(merge_cfg_from_list(cfg, ["remat", "True"]))
    assert on.backbone.visual.remat is True
    with pytest.raises(ValueError, match="Type mismatch"):
        merge_cfg_from_list(cfg, ["remat", "selective"])
    for bad in ("sometimes", 2, None):
        with pytest.raises(ValueError, match="remat must be one of"):
            CROG(**GEOMETRY, **CFG, remat=bad)
    tm = CROG(**GEOMETRY, **CFG).train()
    tm.backbone.visual.remat = "partial"
    with pytest.raises(ValueError, match="remat must be one of"):
        tm(*(torch.from_numpy(a) for a in inputs()))



def test_train_cli_runs_opts_remat_true(tmp_path, monkeypatch):
    """``train_crog --opts remat True``: the config's bool reaches the model
    through ``build_crog`` (its CROG cut to the tiny geometry), the log says
    which mode runs, and every train step checkpoints every bottleneck."""
    from crog_tpu_torch import train_crog
    from crog_tpu_torch.models import crog as crog_module

    monkeypatch.setattr(crog_module, "CROG", lambda **kw: CROG(**{**kw, **GEOMETRY, **CFG}))
    calls, _ = _spy(monkeypatch)
    train_crog.main([
        "--config", "config/OCID-VLG/crog_synthetic_r50.yaml", "--device", "cpu", "--opts",
        "remat", "True", "synthetic_samples", "2", "input_size", str(RES), "batch_size", "2",
        "batch_size_val", "2", "epochs", "1", "workers", "1", "workers_val", "1",
        "print_freq", "1", "evaluate", "False", "output_folder", str(tmp_path),
        "exp_name", "remat"])
    log = (tmp_path / "remat" / "train.log").read_text()
    assert "Remat (activation checkpointing of the RN50 bottlenecks): full" in log
    losses = re.findall(r"Loss ([-\d.naif]+) ", log)
    assert len(losses) == 1 and math.isfinite(float(losses[0])), log[-2000:]
    assert calls == [True] * BLOCKS
