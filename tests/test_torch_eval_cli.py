"""The slice as a whole against the JAX package, on the CPU at the tiny
geometry of tests/torch_port_helpers.py (RES 128) with the weights carried
over from the flax model: ``crog_tpu_torch.test_crog`` on an OCID-VLG tree
(``tests/ocid_fixture.py``, the config's rawlb wire, loader workers, the
put stage), ``validate_without_grasp`` on a RefCOCO shard, the refer-type
sweep, ``inference_with_grasp``'s PNGs on a rawlb batch, one epoch of
``crog_tpu_torch.train_crog`` on the tree, and a CLIP archive loaded into
the backbone.

Tolerances as tests/test_torch_crog.py: per-sample IoU within 1e-3 (fp32
sums in another order, thresholded), J@1, J@5 and Pr@K equal; logits to
2e-5 of their largest magnitude.
"""

import io
import math
import re

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from crog_tpu.data.loader import DataLoader as JaxDataLoader
from crog_tpu.data.loader import device_put_crog as jax_put
from crog_tpu.data.ocid_vlg import OCIDVLGDataset as JaxOCIDVLG
from crog_tpu.data.refcoco import RefCOCODataset as JaxRefCOCO
from crog_tpu.data.shards import ShardWriter
from crog_tpu.engine.crog_engine import make_eval_step as jax_make_eval_step
from crog_tpu.engine.crog_engine import validate_with_grasp as jax_validate
from crog_tpu.engine.crog_engine import validate_without_grasp as jax_validate_mask
from crog_tpu_torch import test_crog as port_test_crog
from crog_tpu_torch import train_crog as port_train_crog
from crog_tpu_torch.data.loader import DataLoader, DevicePut
from crog_tpu_torch.data.ocid_vlg import OCIDVLGDataset
from crog_tpu_torch.data.refcoco import RefCOCODataset
from crog_tpu_torch.engine.crog_engine import (
    inference_with_grasp,
    make_eval_step,
    validate_without_grasp,
)
from crog_tpu_torch.models.convert import (
    load_numpy_state_dict,
    load_torch_state_dict,
    merge_pretrained_clip,
    state_dict_from_flax,
)
from crog_tpu_torch.models.crog import CROG as TorchCROG
from crog_tpu_torch.test_diff_refer_types import evaluate_refer_types
from tests.ocid_fixture import build_ocid_tree
from tests.torch_port_helpers import GEOMETRY, RES, TINY, assert_close_scaled, inputs, tiny_pair

CONFIG = "config/OCID-VLG/crog_multiple_r50.yaml"


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def ocid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocid")
    build_ocid_tree(root, num_scenes=2)
    return str(root)


@pytest.fixture(scope="module")
def jax_step(pair):
    jm, v, _ = pair
    return jax_make_eval_step(jm, input_size=RES, ori_hw=(480, 640)), v


def _tiny_model(*_, **__):
    return TorchCROG(**GEOMETRY, **TINY)


def _jax_eval(ds, step, v, batch):
    loader = JaxDataLoader(ds, batch_size=batch, pad_last_batch=True, num_workers=2,
                           device_put_fn=lambda b: jax_put(b))
    ious = []
    ref = jax_validate(loader, step, v,
                       on_batch=lambda b, out, n: ious.extend(np.asarray(out["iou"])[:n]))
    return ref, ious


def test_eval_cli_on_the_tree_matches_jax(pair, jax_step, ocid_root, tmp_path, monkeypatch):
    """The config as written (rawlb wire, val-test split), cut to the tiny
    geometry, its resume file the flax weights."""
    _, v, _ = pair
    ckpt = tmp_path / "tiny.pth"
    torch.save({"state_dict": {k: torch.as_tensor(a) for k, a in
                               state_dict_from_flax(v["params"], v["batch_stats"]).items()}},
               ckpt)
    monkeypatch.setattr(port_test_crog, "build_crog", _tiny_model)
    got = port_test_crog.main([
        "--config", CONFIG, "--device", "cpu", "--opts", "root_path", ocid_root,
        "input_size", str(RES), "batch_size_val", "3", "workers_val", "2",
        "resume", str(ckpt), "output_folder", str(tmp_path), "exp_name", "eval"])
    step, v = jax_step
    ref, jax_ious = _jax_eval(JaxOCIDVLG(ocid_root, "val-test", input_size=RES, raw="lb"),
                              step, v, 3)
    assert len(got["iou_list"]) == len(jax_ious) == 8
    np.testing.assert_allclose(got["iou_list"], jax_ious, rtol=0, atol=1e-3)
    for key in ("j_index@1", "j_index@5", "prec"):
        assert got[key] == ref[key], key


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_validate_without_grasp_on_refcoco_matches_jax(pair, tmp_path):
    """Variable-resolution RefCOCO records (tests/test_shards_refcoco.py:69),
    un-warped into a 128^2 canvas."""
    jm, v, tm = pair
    rng = np.random.RandomState(2)
    w = ShardWriter(str(tmp_path / "refcoco" / "val"), backend="dir")
    for i, (h, wd) in enumerate([(60, 80), (100, 64), (90, 90), (64, 120), (72, 56)]):
        w.put(str(i), {"img_bytes": _png_bytes((rng.rand(h, wd, 3) * 255).astype(np.uint8)),
                       "mask": (rng.rand(h, wd) > 0.6).astype(np.uint8),
                       "sents": np.asarray([f"sample {i}"]), "cat": i, "img_name": f"{i}.jpg"})
    w.close()
    root = str(tmp_path / "refcoco")
    jloader = JaxDataLoader(JaxRefCOCO(root, "val", input_size=RES), batch_size=2,
                            pad_last_batch=True, num_workers=2, device_put_fn=jax_put)
    jstep = jax_make_eval_step(jm, input_size=RES, ori_hw=(128, 128))
    jax_ious = []
    ref = jax_validate(jloader, jstep, v, with_grasps=False,
                       on_batch=lambda b, out, n: jax_ious.extend(np.asarray(out["iou"])[:n]))
    assert ref == jax_validate_mask(jloader, jstep, v)
    with DataLoader(RefCOCODataset(root, "val", input_size=RES), 2, pad_last_batch=True,
                    num_workers=2, device_put_fn=DevicePut("cpu")) as loader:
        got = validate_without_grasp(
            loader, make_eval_step(tm, input_size=RES, ori_hw=(128, 128), device="cpu"))
    assert len(got["iou_list"]) == 5 and got["j1_hits"] == []
    np.testing.assert_allclose(got["iou_list"], jax_ious, rtol=0, atol=1e-3)
    assert got["prec"] == ref["prec"]


def test_refer_type_sweep_matches_jax(pair, jax_step, ocid_root):
    from test_diff_refer_types import evaluate_refer_types as jax_sweep

    _, _, tm = pair
    step, v = jax_step
    types = {"name": [0, 2, 5], "loc": [1, 3, 4, 6, 7, 99], "rel": [120, 121]}
    ref = jax_sweep(JaxOCIDVLG(ocid_root, "val-test", input_size=RES, raw="lb"), types,
                    step, v, batch_size=2, num_workers=2)
    got = evaluate_refer_types(
        OCIDVLGDataset(ocid_root, "val-test", input_size=RES, raw="lb"), types,
        make_eval_step(tm, input_size=RES, device="cpu"), batch_size=2, num_workers=2,
        device_put_fn=DevicePut("cpu"))
    assert set(got) == set(ref) == {"name", "loc"}
    for t in ref:
        assert len(got[t]["iou_list"]) == len([i for i in types[t] if i < 8])
        assert got[t]["iou"] == pytest.approx(ref[t]["iou"], abs=1e-3)
        for key in ("j_index@1", "j_index@5", "prec"):
            assert got[t][key] == ref[t][key], (t, key)


def test_inference_with_grasp_renders_rawlb_batches(pair, ocid_root, tmp_path):
    """One PNG per real sample of a rawlb split (5 samples at batch 3: the
    padded tail's copies are not drawn)."""
    pytest.importorskip("matplotlib")
    from crog_tpu_torch.test_diff_refer_types import Subset

    _, _, tm = pair
    ds = Subset(OCIDVLGDataset(ocid_root, "val", input_size=RES, raw="lb"), range(5))
    vis = tmp_path / "vis"
    with DataLoader(ds, 3, pad_last_batch=True, num_workers=2,
                    device_put_fn=DevicePut("cpu")) as loader:
        assert "lb_img_u8" in next(iter(loader))
        result = inference_with_grasp(loader, make_eval_step(tm, input_size=RES, device="cpu"),
                                      visualize=True, vis_dir=str(vis))
    assert len(result["iou_list"]) == 5
    assert sorted(p.name for p in vis.iterdir()) == \
        ["0000_00.png", "0000_01.png", "0000_02.png", "0001_00.png", "0001_01.png"]


def test_train_cli_one_epoch_on_the_tree(ocid_root, tmp_path, monkeypatch):
    monkeypatch.setattr(port_train_crog, "build_crog", _tiny_model)
    port_train_crog.main([
        "--config", CONFIG, "--device", "cpu", "--opts", "root_path", ocid_root,
        "input_size", str(RES), "batch_size", "4", "batch_size_val", "4", "epochs", "1",
        "workers", "2", "workers_val", "2", "print_freq", "1",
        "output_folder", str(tmp_path), "exp_name", "train"])
    log = (tmp_path / "train" / "train.log").read_text()
    losses = re.findall(r"Loss ([-\d.naif]+) ", log)
    assert len(losses) == 2 and all(math.isfinite(float(x)) for x in losses), log[-2000:]
    assert "Evaluation: Epoch=[1/1]" in log
    payload = torch.load(tmp_path / "train" / "last_model", map_location="cpu",
                         weights_only=False)
    assert payload["step"] == 2 and payload["meta"]["epoch"] == 1


class _Node(torch.nn.Module):
    def forward(self, x):
        return x


def _archive(sd, path, jit: bool):
    """A torch.jit (or plain) archive holding ``sd`` under its keys, in
    fp16 like the OpenAI release."""
    root = _Node()
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, _Node())
            node = getattr(node, m)
        t = t.half() if t.is_floating_point() else t
        if t.is_floating_point():
            node.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
        else:
            node.register_buffer(leaf, t)
    if jit:
        torch.jit.save(torch.jit.script(root), str(path))
    else:
        torch.save(root.state_dict(), str(path))
    return str(path)


@pytest.mark.parametrize("jit", [True, False])
def test_clip_archive_loads_like_jax_package(pair, tmp_path, jit):
    """A CLIP-schema archive (the backbone's keys without the ``connect``
    branch, plus the release's non-tensor entries) through crog_tpu's
    load_torch_state_dict -> convert_clip_state_dict -> merge_pretrained_clip
    and through the port's loader: equal backbone tensors and logits;
    ``connect`` keeps its init; a shape mismatch raises naming the key."""
    from crog_tpu.models import convert as JC

    jm, v, tm = pair
    g = torch.Generator().manual_seed(7)
    sd = {k: (torch.randn(t.shape, generator=g) * 0.05 + t if t.is_floating_point() else t)
          for k, t in tm.backbone.state_dict().items() if ".connect." not in k}
    sd.update(input_resolution=torch.tensor(RES), context_length=torch.tensor(77),
              vocab_size=torch.tensor(GEOMETRY["vocab_size"]))
    path = _archive(sd, tmp_path / "clip.pt", jit)

    params, stats = JC.convert_clip_state_dict(JC.load_torch_state_dict(path))
    jv = JC.merge_pretrained_clip({"params": v["params"], "batch_stats": v["batch_stats"]},
                                  params, stats)
    jv = jax.tree_util.tree_map(np.asarray, jv)
    want = state_dict_from_flax(jv["params"], jv["batch_stats"])

    model = TorchCROG(**GEOMETRY, **TINY)
    load_numpy_state_dict(model, state_dict_from_flax(v["params"], v["batch_stats"]))
    connect0 = {k: t.clone() for k, t in model.backbone.state_dict().items() if "connect" in k}
    keys = merge_pretrained_clip(model.eval(), load_torch_state_dict(path))
    assert len(keys) == len(sd) - 3 and "visual.attnpool.q_proj.weight" in keys
    got = model.state_dict()
    for k, t in want.items():
        if k.startswith("backbone.") and not k.endswith(("num_batches_tracked", "logit_scale")):
            np.testing.assert_array_equal(got[k].numpy(), t, err_msg=k)
    for k, t in connect0.items():
        assert torch.equal(model.backbone.state_dict()[k], t), k
    assert not np.array_equal(got["backbone.visual.conv1.weight"].numpy(),
                              state_dict_from_flax(v["params"], v["batch_stats"])
                              ["backbone.visual.conv1.weight"])

    img, word = inputs()
    ref = np.asarray(jm.apply(jv, jnp.asarray(img), jnp.asarray(word), train=False))
    with torch.no_grad():
        logits = model(torch.from_numpy(img), torch.from_numpy(word)).numpy()
    assert_close_scaled(logits, ref, 2e-5)

    bad = dict(load_torch_state_dict(path))
    bad["visual.conv1.weight"] = bad["visual.conv1.weight"][:, :, :1]
    with pytest.raises(ValueError, match="visual.conv1.weight"):
        merge_pretrained_clip(model, bad)


@pytest.mark.parametrize("fault", ["prefixed", "incomplete"])
def test_clip_archive_with_other_keys_raises_like_jax_package(pair, tmp_path, fault):
    """An archive whose keys are not CLIP's (a DDP ``module.`` prefix under
    ``state_dict``) or that lacks backbone tensors: crog_tpu's conversion
    raises KeyError, and so does the port's merge, naming the keys, before
    it loads anything."""
    from crog_tpu.models import convert as JC

    _, _, tm = pair
    sd = {k: t for k, t in tm.backbone.state_dict().items() if ".connect." not in k}
    if fault == "prefixed":
        sd = {"module." + k: t for k, t in sd.items()}
    else:
        gone = ("visual.attnpool.q_proj.weight", "visual.layer4.0.conv1.weight")
        sd = {k: t for k, t in sd.items() if k not in gone}
    path = tmp_path / "clip.pt"
    torch.save({"state_dict": sd}, str(path))

    with pytest.raises(KeyError):
        JC.convert_clip_state_dict(JC.load_torch_state_dict(str(path)))
    model = TorchCROG(**GEOMETRY, **TINY)
    before = {k: t.clone() for k, t in model.backbone.state_dict().items()}
    named = "q_proj.weight', 'visual.layer4.0.conv1" if fault == "incomplete" else "lacks"
    with pytest.raises(KeyError, match=named):
        merge_pretrained_clip(model, load_torch_state_dict(str(path)))
    for k, t in model.backbone.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_latency_tool_on_cpu(monkeypatch, capsys):
    """tools/torch_latency.py end to end at the tiny geometry, 3 chained
    forwards after 1 (the card's run: 400 after 100): both parameter
    dtypes timed, the parity line, no device memory figure off the card."""
    import importlib.util

    import crog_tpu_torch.models.crog as M

    spec = importlib.util.spec_from_file_location("torch_latency", "tools/torch_latency.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(M, "build_crog", _tiny_model)
    monkeypatch.setattr(tool, "ITERS", 4)
    monkeypatch.setattr(tool, "WARMUP", 1)
    results = tool.main(["--config", CONFIG, "--device", "cpu", "--opts", "input_size",
                         str(RES)])
    out = capsys.readouterr().out
    assert set(results) == {"float32", "bfloat16"}
    assert all(math.isfinite(v) and v > 0 for v in results.values())
    assert "bf16-params parity: max |logit delta|" in out
    assert "Peak Device Memory: not measured (no card)" in out and "device: cpu" in out
    if not torch.cuda.is_available():  # the default --device cuda refuses
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--config", CONFIG])


def test_rates_tool_alternates_trees(monkeypatch, capsys):
    """tools/torch_crog_rates.py with two trees runs each in a process of
    its own, in the order A B, B A, ..., and summarizes each tree; with no
    tree it prints its usage and returns 2; one run refuses without a
    card."""
    import importlib.util
    import json
    import subprocess
    import types

    spec = importlib.util.spec_from_file_location("torch_crog_rates",
                                                  "tools/torch_crog_rates.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    order = []

    def fake_run(cmd, **kw):
        tree = cmd[-1]
        order.append(tree)
        res = {"tree": tree, "train": 100.0 + len(order), "eval": 300.0, "fwd_ms": 30.0}
        return types.SimpleNamespace(returncode=0, stdout="[time] ...\n" + json.dumps(res),
                                     stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(tool, "PAIRS", 3)
    assert tool.main(["A", "B"]) == 0
    assert order == ["A", "B", "B", "A", "A", "B"]
    out = capsys.readouterr().out
    assert "[rates] A train: mean 103.33, least 101.00, largest 105.00 over 3 runs" in out
    assert "[rates] train: B below A in 1 of 3 pairs" in out
    assert tool.main([]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.one_run(".")


def test_refer_types_cli_on_the_tree(ocid_root, tmp_path, monkeypatch):
    """``python -m crog_tpu_torch.test_diff_refer_types`` in-process on the
    CPU: every type with indices in the split is reported; without a card
    the default --device cuda raises."""
    import json

    from crog_tpu_torch import test_diff_refer_types as cli

    types = tmp_path / "types.json"
    types.write_text(json.dumps({"name": [0, 1, 2], "attr": [3, 7], "mixed": [500]}))
    argv = ["--config", CONFIG, "--refer-types", str(types), "--opts", "root_path", ocid_root,
            "input_size", str(RES), "workers_val", "2", "output_folder", str(tmp_path)]
    monkeypatch.setattr(cli, "build_crog", _tiny_model)
    results = cli.main(argv[:2] + ["--device", "cpu"] + argv[2:])
    assert sorted(results) == ["attr", "name"]
    assert [len(results[t]["iou_list"]) for t in ("name", "attr")] == [3, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
