"""The port's tools on the CPU at a small size, against the JAX package's
where it has them: the SSG training supervisor (tools/
torch_ssg_train_supervisor.py, the cases of tests/test_supervisor.py on a
fake trainer, and a real tiny ``train_ssg`` with a planted out-of-memory
fault), the real-data drill (tools/torch_realdata_drill.py), the RefCOCO
shard builder (tools/torch_folder2lmdb.py, byte for byte against
tools/folder2lmdb.py), the profiler regions and their rollup
(tools/torch_profile_step.py), the roofline's FLOP count
(tools/torch_roofline.py), and that no new tool imports the JAX package."""

import contextlib
import copy
import json
import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list  # noqa: E402
from crog_tpu_torch.data.loader import DataLoader  # noqa: E402
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG  # noqa: E402
from crog_tpu_torch.engine.crog_engine import make_train_step  # noqa: E402
from crog_tpu_torch.engine.optim import make_optimizer  # noqa: E402
from crog_tpu_torch.engine.ssg_engine import make_ssg_train_step  # noqa: E402
from crog_tpu_torch.models.crog import CROG, random_init_  # noqa: E402
from crog_tpu_torch.models.ssg import build_ssg  # noqa: E402
from crog_tpu_torch.ops import work  # noqa: E402
from crog_tpu_torch.train_ssg import build_ssg_dataset, loss_config, ssg_collate  # noqa: E402
from tests.ocid_fixture import build_ocid_tree  # noqa: E402
from tools import torch_profile_step as ps  # noqa: E402
from tools.torch_ssg_train_supervisor import supervise  # noqa: E402

TINY = dict(word_len=17, word_dim=1024, vis_dim=512, fpn_in=(512, 1024, 1024),
            fpn_out=(256, 512, 1024), num_layers=1, num_head=8, dim_ffn=512, dropout=0.1)
GEOMETRY = dict(input_resolution=128, clip_resolution=128, vision_layers=(1, 1, 1, 1),
                transformer_layers=2, vocab_size=49408)
SSG_TINY = ("img_size", "128", "resnet_layers", "[1,1,1,1]", "num_classes", "8",
            "masks_to_train", "8")

# ------------------------------------------------------------ supervisor
FAKE_TRAINER = textwrap.dedent(
    """
    import json, os, sys
    # --opts k v ... as the real CLI parses them (later keys win)
    opts = {}
    if "--opts" in sys.argv:
        rest = sys.argv[sys.argv.index("--opts") + 1:]
        for k, v in zip(rest[::2], rest[1::2]):
            opts[k] = v
    bs = int(opts.get("batch_size", "32"))
    with open(os.environ["FAKE_LOG"], "a") as f:
        f.write(json.dumps({"batch_size": bs, "resume": opts.get("resume"),
                            "device": sys.argv[sys.argv.index("--device") + 1]}) + "\\n")
    if bs > int(os.environ.get("FAKE_MAX_OK", "4")):
        sys.stderr.write("torch.OutOfMemoryError: CUDA out of memory. Tried to "
                         "allocate 2.00 GiB\\n")
        sys.exit(1)
    sys.exit(0)
    """
)


@pytest.mark.parametrize("case", [
    # (batch, faults above, restarts, min batch) -> (ok, batches launched)
    # degrades 16 -> 8 -> 4, the batch that works
    ((16, 4, 4, 1), (True, [16, 8, 4])),
    # 16 -> 8 -> 4 -> 2, then the budget of 3 restarts is spent
    ((16, 0, 3, 2), (False, [16, 8, 4, 2])),
    # no degrade below the min batch: plain retries until the budget is spent
    ((4, 0, 2, 4), (False, [4, 4, 4])),
    # a child that runs to its end is launched once
    ((4, 8, 4, 1), (True, [4])),
], ids=["degrades_to_working_batch", "budget_exhausts", "retries_at_min_batch",
        "immediate_success"])
def test_supervisor_cases(tmp_path, monkeypatch, case):
    """The four cases of tests/test_supervisor.py on a fake trainer that
    fails as the card does, with torch.OutOfMemoryError."""
    (batch, max_ok, restarts, min_batch), (ok, want) = case
    script = tmp_path / "fake_trainer.py"
    script.write_text(FAKE_TRAINER)
    log = tmp_path / "launches.jsonl"
    monkeypatch.setenv("FAKE_LOG", str(log))
    monkeypatch.setenv("FAKE_MAX_OK", str(max_ok))
    monkeypatch.chdir(ROOT)
    rc = supervise("config/OCID-Grasp/ssg_r50.yaml",
                   ["batch_size", str(batch), "exp_name", "sup_test",
                    "output_folder", str(tmp_path)],
                   script=str(script), max_restarts=restarts, min_batch=min_batch,
                   device="cpu")
    launches = [json.loads(line) for line in log.read_text().splitlines()]
    assert (rc == 0) == ok
    assert [entry["batch_size"] for entry in launches] == want
    # every launch resumes from the port's last_model, on the device asked for
    assert all(entry["resume"] == str(tmp_path / "sup_test" / "last_model")
               for entry in launches)
    assert all(entry["device"] == "cpu" for entry in launches)


def test_supervisor_resumes_a_real_run_at_half_the_batch(tmp_path, monkeypatch):
    """A tiny ``crog_tpu_torch.train_ssg --device cpu`` (128^2, resnet_layers
    [1,1,1,1], the synthetic frames on the raw wire) through the supervisor,
    its child faulting with an out-of-memory error after epoch 1's
    last_model at batch 8: a second launch at 4 resumes from epoch 1 and
    finishes epoch 2 (chip_smoke.py phase 15c at full width)."""
    monkeypatch.chdir(ROOT)
    log = cs.supervised_run("cpu", str(tmp_path), SSG_TINY)
    assert log.count("OutOfMemoryError: CUDA out of memory") == 1
    payload = torch.load(tmp_path / "supervised" / "last_model", map_location="cpu",
                         weights_only=False)
    # 1 step at batch 8 (epoch 1), 2 at batch 4 (epoch 2)
    assert payload["meta"]["epoch"] == 2 and payload["step"] == 3


# ------------------------------------------------------------ drill
def test_drill_validate_layout_matches_jax_tool(tmp_path):
    from tools.realdata_drill import validate_layout as jax_validate
    from tools.torch_realdata_drill import validate_layout

    build_ocid_tree(str(tmp_path / "ocid"), num_scenes=2, version="multiple")
    for split in ("train", "val"):
        got = validate_layout(str(tmp_path / "ocid"), "multiple", split)
        assert got == jax_validate(str(tmp_path / "ocid"), "multiple", split)
    with pytest.raises(SystemExit):
        validate_layout(str(tmp_path / "ocid"), "single", "train")


def _drill(*args):
    return subprocess.run([sys.executable, "tools/torch_realdata_drill.py", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)


def test_drill_fixture_prints_the_metric_table():
    out = _drill("--fixture", "--device", "cpu", "--opts", "input_size", "128",
                 "batch_size_val", "4", "workers_val", "1")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "[drill] layout OK" in out.stdout
    assert "=> loaded checkpoint" in out.stdout
    table = out.stdout.split("DRILL RESULT")[1]
    for metric in ("IoU", "Pr@50", "Pr@60", "Pr@70", "Pr@80", "Pr@90", "J@1", "J@5"):
        assert f"  {metric} " in table


def test_drill_exits_nonzero_when_the_eval_fails(tmp_path):
    build_ocid_tree(str(tmp_path / "ocid"), num_scenes=2, version="multiple")
    bad = tmp_path / "broken.pth"
    bad.write_bytes(b"not a checkpoint")
    out = _drill("--data-dir", str(tmp_path / "ocid"), "--pth", str(bad), "--split",
                 "train", "--device", "cpu", "--opts", "input_size", "128",
                 "output_folder", str(tmp_path / "exp"))
    assert out.returncode != 0
    assert "[drill] eval failed" in out.stderr
    assert "DRILL RESULT" not in out.stdout


# ------------------------------------------------------------ shards
def test_shard_builder_writes_the_jax_tools_bytes(tmp_path):
    """data_process.py's layout (<split>.json, images, masks) into shards
    by both tools: the same files with the same bytes, read back by the
    port's RefCOCO reader."""
    from crog_tpu_torch.data.refcoco import RefCOCODataset
    from tools.folder2lmdb import folder2shard as jax_folder2shard
    from tools.torch_folder2lmdb import folder2shard

    rng = np.random.RandomState(3)
    (tmp_path / "anns").mkdir()
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    anns = []
    for i in range(3):
        Image.fromarray((rng.rand(40, 56, 3) * 255).astype(np.uint8)).save(
            tmp_path / "images" / f"COCO_{i}.jpg")
        Image.fromarray(((rng.rand(40, 56) > 0.6) * 255).astype(np.uint8)).save(
            tmp_path / "masks" / f"{100 + i}.png")
        anns.append({"img_name": f"COCO_{i}.jpg", "mask_name": f"{100 + i}.png",
                     "seg_id": 100 + i, "cat": i + 1,
                     "sents": [f"the object number {i}", "that thing"]})
    (tmp_path / "anns" / "val.json").write_text(json.dumps(anns))
    args = (str(tmp_path / "anns"), str(tmp_path / "images"), str(tmp_path / "masks"))
    jax_folder2shard(*args, str(tmp_path / "jax"), "val")
    folder2shard(*args, str(tmp_path / "port"), "val")
    names = sorted(os.listdir(tmp_path / "jax" / "val"))
    assert names == sorted(os.listdir(tmp_path / "port" / "val")) and len(names) == 4
    for name in names:
        assert ((tmp_path / "jax" / "val" / name).read_bytes()
                == (tmp_path / "port" / "val" / name).read_bytes()), name
    ds = RefCOCODataset(str(tmp_path / "port"), "val", input_size=64)
    assert len(ds) == 3
    rec = ds.reader[1]
    want = np.asarray(Image.open(tmp_path / "masks" / "101.png")) > 127
    assert np.array_equal(rec["mask"], want.astype(np.uint8))
    assert [str(s) for s in rec["sents"]] == anns[1]["sents"]
    assert ds[0]["img"].shape[:2] == (64, 64)


# ------------------------------------------------------------ regions
_RANGED = ("crog_tpu_torch.models.crog", "crog_tpu_torch.models.ssg",
           "crog_tpu_torch.models.ssg_loss", "crog_tpu_torch.engine.crog_engine",
           "crog_tpu_torch.engine.ssg_engine")


def _crog_step():
    model = CROG(**GEOMETRY, **TINY)
    random_init_(model, torch.Generator().manual_seed(0))
    batch = next(iter(DataLoader(SyntheticOCIDVLG(2, "train", 128, raw="lb"), 2,
                                 shuffle=True, drop_last=True)))

    def make():
        m = copy.deepcopy(model)
        opt, sched = make_optimizer(m, 1e-4, 0.1, [35], 0.1, 100, 0.0)
        step = make_train_step(m, opt, sched, True, 1.0, torch.Generator().manual_seed(1),
                               torch.device("cpu"))
        return m, lambda: step(batch)

    return make


def _ssg_step():
    cfg = merge_cfg_from_list(load_cfg_from_cfg_file("config/OCID-Grasp/ssg_r50.yaml"),
                              ["dataset", "synthetic", "synthetic_samples", "2", *SSG_TINY])
    ds = build_ssg_dataset(cfg, "train", random.Random(0))
    batch = ssg_collate(cfg)([ds[0], ds[1]])
    model = build_ssg(cfg, torch.float32)
    random_init_(model, torch.Generator().manual_seed(0))

    def make():
        m = copy.deepcopy(model)
        opt, sched = make_optimizer(m, cfg.base_lr, 1.0, cfg.milestones, cfg.lr_decay, 100,
                                    cfg.weight_decay)
        step = make_ssg_train_step(m, opt, sched, m.anchors(), loss_config(cfg),
                                   torch.Generator().manual_seed(1), cfg.max_norm,
                                   torch.device("cpu"), max_objs=cfg.max_objs)
        return m, lambda: step(batch)

    return make


@pytest.fixture(scope="module")
def traced():
    """Each tiny model's train step twice from the same state: with the
    profiler ranges replaced by no-ops, and with them under the profiler
    (the second run's Chrome trace kept)."""
    import importlib

    out = {}
    for name, builder in (("crog", _crog_step), ("ssg", _ssg_step)):
        make = builder()
        mods = [importlib.import_module(m) for m in _RANGED]
        saved = [m.record_function for m in mods]
        for m in mods:
            m.record_function = lambda _name: contextlib.nullcontext()
        try:
            plain_model, run = make()
            plain = run()
        finally:
            for m, rf in zip(mods, saved):
                m.record_function = rf
        ranged_model, run = make()
        ranged = {}
        trace, _ = ps.trace_steps(lambda: ranged.update(run()), 1, torch.device("cpu"),
                                  warmup=0)
        out[name] = (plain_model, plain, ranged_model, ranged, trace)
    return out


@pytest.mark.parametrize("model", ["crog", "ssg"])
def test_profiler_ranges_change_no_result(traced, model):
    """The same train step with no ranges and with the ranges under the
    profiler: bit-equal metrics, gradients and updated parameters."""
    plain_model, plain, ranged_model, ranged, trace = traced[model]
    assert plain.keys() == ranged.keys()
    for k in plain:
        assert torch.equal(plain[k], ranged[k]), k
    for (n, p), (_, q) in zip(plain_model.named_parameters(), ranged_model.named_parameters()):
        assert torch.equal(p, q), n
        if p.grad is not None or q.grad is not None:
            assert torch.equal(p.grad, q.grad), n
    for (n, b), (_, c) in zip(plain_model.named_buffers(), ranged_model.named_buffers()):
        assert torch.equal(b, c), n
    assert all(torch.isfinite(v).all() for v in plain.values())
    names = {e.get("name") for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    want = ({"backbone", "neck", "decoder", "proj", "opt_update", "unpack"} if model == "crog"
            else {"backbone", "fpn", "proto_net", "prediction_layers", "semantic_seg_conv",
                  "lmatch", "lcls", "lbox", "lins", "lsem", "lgrasp", "opt_update", "unpack"})
    assert want <= names


def test_rollup_of_a_cpu_trace_puts_backward_and_adam_in_their_regions(traced):
    """The tiny CROG step's trace: the decoder blocks' backward ops (their
    autograd Functions' backward) land in ``decoder`` through the fwdbwd
    flows, AdamW's update in ``opt_update``, and the regions add up."""
    r = ps.rollup(traced["crog"][-1])
    assert not r.device and r.links["flows"] > 0
    assert abs(sum(r.region_us().values()) - r.total) < 1e-6 * r.total
    home = {}
    for region, ops in r.regions.items():
        for name in ops:
            home.setdefault(name, set()).add(region)
    for op in ("_SelfBlockBackward", "_CrossBlockBackward", "_FusedFFNBackward"):
        assert home.get(op) == {"decoder"}, (op, home.get(op))
    for op in ("aten::addcmul_", "aten::addcdiv_"):  # AdamW's second moment, update
        assert home.get(op) == {"opt_update"}, (op, home.get(op))
    ssg = ps.rollup(traced["ssg"][-1])
    assert {"lmatch", "lcls", "lbox", "lins", "lsem", "lgrasp", "opt_update",
            "backbone", "fpn", "proto_net", "prediction_layers"} <= set(ssg.regions)
    backward = {n for n in ssg.regions["lins"] if "Backward" in n}
    assert backward, sorted(ssg.regions["lins"])


def _hand_built_trace(flows: bool):
    """A forward op in ``decoder`` on thread 1 whose backward (thread 2)
    launches a kernel, a launch outside every range, an AdamW launch in
    ``opt_update``, a kernel without its launch, and a copy."""
    x = lambda name, cat, tid, ts, dur, **args: {"ph": "X", "cat": cat, "name": name,
                                                 "pid": 1, "tid": tid, "ts": ts, "dur": dur,
                                                 "args": args}
    launch = lambda tid, ts, corr: x("cudaLaunchKernel", "cuda_runtime", tid, ts, 1,
                                     correlation=corr)
    kern = lambda name, corr, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name,
                                                  "pid": 0, "tid": 7, "ts": 1000 + corr,
                                                  "dur": dur, "args": {"correlation": corr}}
    seq = {"Sequence number": 5}
    events = [
        x("decoder", "user_annotation", 1, 0.0, 100.0),
        x("aten::mm", "cpu_op", 1, 10.0, 20.0, **seq),
        launch(1, 15.0, 1),
        x("autograd::engine::evaluate_function: MmBackward0", "cpu_op", 2, 200.0, 50.0,
          **seq),
        x("MmBackward0", "cpu_op", 2, 201.0, 40.0, **seq),
        launch(2, 210.0, 2),
        x("aten::add_", "cpu_op", 2, 243.0, 5.0),  # the engine's gradient buffer add
        launch(2, 244.0, 5),
        launch(1, 260.0, 3),
        x("opt_update", "user_annotation", 1, 300.0, 50.0),
        x("Optimizer.step#AdamW.step", "user_annotation", 1, 301.0, 40.0),
        launch(1, 310.0, 4),
        kern("k_fwd", 1, 5.0), kern("k_bwd", 2, 7.0), kern("k_add", 5, 2.0),
        kern("k_outside", 3, 11.0), kern("k_adam", 4, 13.0),
        kern("k_unlinked", 99, 17.0), kern("Memcpy HtoD", 3, 19.0, "gpu_memcpy"),
        kern("gpu annotation", 4, 50.0, "gpu_user_annotation"),
    ]
    if flows:
        events += [{"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 5, "pid": 1,
                    "tid": 1, "ts": 10.0},
                   {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 5, "pid": 1,
                    "tid": 2, "ts": 201.0, "bp": "e"}]
    return {"traceEvents": events}


@pytest.mark.parametrize("flows", [True, False], ids=["fwdbwd_flows", "no_flows"])
def test_rollup_of_a_hand_built_trace(flows):
    """With the flow, the backward kernel and the engine's gradient add go
    to the forward op's ``decoder``; without it, to ``<other>``.  The copy
    counts, the GPU-side annotation does not, and every kernel once."""
    r = ps.rollup(_hand_built_trace(flows))
    assert r.device and r.total == 74.0
    if flows:
        assert r.region_us() == {"decoder": 14.0, "<other>": 47.0, "opt_update": 13.0}
        assert r.regions["decoder"] == {"k_fwd": [5.0, 1], "k_bwd": [7.0, 1],
                                        "k_add": [2.0, 1]}
    else:
        assert r.region_us() == {"decoder": 5.0, "<other>": 56.0, "opt_update": 13.0}
    assert r.links == {"flows": int(flows), "unlinked": 1}


# ------------------------------------------------------------ roofline
def test_roofline_count_equals_the_plain_forward_with_kernel_work_from_shapes():
    """The tiny CROG's decoder runs K2, K3 and K4 (d_model 512): the
    roofline's count (aten ops with the twins hidden, plus the kernels'
    work from their shapes) equals FlopCounterMode over the plain forward,
    each kernel noted once with the work of its shapes (64 visual tokens,
    17 text tokens, d 512, FFN 512)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tools.torch_roofline import count

    model = CROG(**GEOMETRY, **TINY).eval()
    random_init_(model, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 128, 128, 3).astype(np.float32))
    word = torch.randint(1, 400, (1, 17), generator=torch.Generator().manual_seed(0))
    c = count(model, img, word)
    with torch.no_grad(), FlopCounterMode(display=False) as plain:
        model(img, word)
    assert c["flops"] == plain.get_total_flops()
    assert c["kernels"] == {
        "decoder_self_block": [1, work.self_block_flops(1, 64, 512)],
        "decoder_cross_block": [1, work.cross_block_flops(1, 64, 17, 512)],
        "ffn": [1, work.ffn_flops(64, 512, 512)]}
    assert c["aten_flops"] == c["flops"] - sum(f for _, f in c["kernels"].values())
    params = sum(p.numel() * 4 for p in model.parameters()) + sum(
        b.numel() * b.element_size() for b in model.buffers())
    assert c["least_bytes"] == params + img.numel() * 4 + word.numel() * 8 + 32 * 32 * 5 * 4
    assert c["op_bytes"] > c["least_bytes"]


# ------------------------------------------------------------ imports
def test_no_new_tool_imports_the_jax_package():
    code = textwrap.dedent("""
        import sys
        import chip_smoke
        import tools.torch_folder2lmdb, tools.torch_profile_step, tools.torch_realdata_drill
        import tools.torch_roofline, tools.torch_ssg_train_supervisor
        bad = sorted(m for m in sys.modules if m in ("crog_tpu", "jax")
                     or m.startswith(("crog_tpu.", "jax.")))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
