"""The port's data parallelism (crog_tpu_torch/parallel/dist.py) on two CPU
ranks over gloo, against the JAX package in one process at the global
batch: the mesh's semantics are "sharded equals unsharded"
(tests/test_data_parallel_consistency.py).

One two-rank group per module: ``ranks`` starts tests/torch_ddp_worker.py
in two processes (one thread each, a free port, a timeout each, so a hung
rank fails the module), which run every case on their rows of the
rank-major global batch and hand back numpy results; the JAX references
are computed here while they run.  Cases: train-mode BatchNorm and the s2d
stem's blocked_bn_relu with global statistics (output, running statistics,
dx and the ranks' summed dscale / dbias); one CROG train step of the tiny
model (2 ranks x 2 samples against ``make_train_step`` on 4, dropout 0),
without remat and with the RN50 bottlenecks checkpointed (``remat=True``:
the same reference, each running statistic updated once, the statistics'
all-reduces as many as without);
one SSG train step (2 x 2 against 4, the global batch's priorities);
``validate_with_grasp`` over a 9-sample val split whose shards both end in
a padded batch, against one process at the global batch and against
``summarize_eval``; SSG's ``validate`` on made-up detections, its hits
summed over the ranks; ``train_crog`` itself under the group (one log, one
``metrics.jsonl``, one ``last_model`` without ``module.`` prefixes that
the one-process ``test_crog`` loads); ``gather_metrics`` over unequal
lengths; and, in this process, the sampler's equal per-rank step counts
under ``drop_last``.

Tolerances are those of the one-process tests, each stated where it is
used: BatchNorm as tests/test_torch_train.py::test_train_batchnorm_matches_flax,
the CROG step as test_torch_train.py::test_train_step_matches_jax, the SSG
step as tests/test_torch_ssg.py::test_train_step_matches_jax, eval as
tests/test_torch_eval_cli.py; what the ranks hold after a step (parameters,
BatchNorm buffers) is equal bit for bit between them.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.data.ocid_grasp import collate_ssg as j_collate
from crog_tpu.data.synthetic_ssg import SyntheticOCIDGrasp as JData
from crog_tpu.engine import crog_engine as JE
from crog_tpu.engine import optim as JO
from crog_tpu.engine import ssg_engine as JSE
from crog_tpu.models import crog as JM
from crog_tpu.models.ssg import SSG as JSSG
from crog_tpu_torch import test_crog as port_test_crog
from crog_tpu_torch.data.loader import DataLoader
from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG
from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp
from crog_tpu_torch.models.clip import BatchNorm
from crog_tpu_torch.models.convert import (
    load_numpy_state_dict,
    ssg_state_dict_from_flax,
    state_dict_from_flax,
)
from crog_tpu_torch.models.crog import CROG
from tests.torch_port_helpers import GEOMETRY, RES, TINY, assert_close_scaled, inputs, randomize

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
RANK_TIMEOUT = 420  # seconds for a rank's whole run; about 60 at one thread
CFG = {**TINY, "dropout": 0.0}
LR, LR_MULTI = 1e-3, 0.1
SSG_GEOM = dict(img_size=128, resnet_layers=(1, 1, 1, 1), num_classes=8)
SSG_LR, SSG_WD, SSG_K = 3e-4, 5e-4, 8
VAL_SAMPLES, VAL_BATCH = 9, 6  # shards of 5 and 4 at 3 per rank: both padded


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The two worker processes and, once they end, their results."""

    def __init__(self, indir: Path):
        self.indir = indir
        port = _free_port()
        self.procs, self.logs = [], []
        for rank in range(WORLD):
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
            log = open(indir / f"rank{rank}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_ddp_worker.py"), str(indir)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        self._out = None

    def close(self):
        """Stop the ranks that still run; close their logs."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def results(self):
        if self._out is None:
            try:
                codes = [p.wait(timeout=RANK_TIMEOUT) for p in self.procs]
            finally:
                self.close()
            text = "\n".join((self.indir / f"rank{r}.log").read_text()[-3000:]
                             for r in range(WORLD))
            assert codes == [0] * WORLD, f"rank exit codes {codes}:\n{text}"
            self._out = [torch.load(self.indir / f"rank{r}.pt", weights_only=False)
                         for r in range(WORLD)]
        return self._out


def _bn_inputs(blocked: bool):
    """A global batch of 2 x 2 rows, NHWC (or blocked [..., 4c]), and the
    flax BatchNorm's parameters and statistics."""
    c = 5 if blocked else 6
    shape = (4, 3, 3, 4 * c) if blocked else (4, 5, 4, c)
    r = np.random.RandomState(3 if blocked else 0)
    return {"blocked": blocked,
            "x": (r.randn(*shape) * 2.0 + 0.5).astype(np.float32),
            "cot": r.randn(*shape).astype(np.float32),
            "scale": (1 + 0.1 * r.randn(c)).astype(np.float32),
            "bias": (0.1 * r.randn(c)).astype(np.float32),
            "mean0": (0.1 * r.randn(c)).astype(np.float32),
            "var0": (0.5 + r.rand(c)).astype(np.float32)}


@pytest.fixture(scope="module")
def crog_models():
    """(flax CROG with dropout 0, its randomized variables), fp32."""
    jm = JM.CROG(dtype=jnp.float32, **GEOMETRY, **CFG)
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3), jnp.float32),
        jnp.zeros((1, TINY["word_len"]), jnp.int32), train=False)
    return jm, randomize(_np(v))


@pytest.fixture(scope="module")
def crog_batch():
    """The global train batch of 4: synthetic targets, images and
    sentences from ``inputs`` (unlike sentences, see test_torch_train)."""
    batch = next(iter(DataLoader(SyntheticOCIDVLG(num_samples=4, split="train",
                                                  input_size=RES), 4)))
    batch["img"], batch["word"] = inputs(4)
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


@pytest.fixture(scope="module")
def ssg_models():
    """(flax SSG, its randomized variables, the global batch of 4, the
    positives' priorities the JAX step draws from its key)."""
    batch = j_collate([JData(num_samples=4, img_size=128, num_classes=8, seed=3)[i]
                       for i in range(4)], max_objs=8)
    jm = JSSG(dtype=jnp.float32, **SSG_GEOM)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(batch["img"]), train=True)
    prio = np.array(jax.random.uniform(jax.random.PRNGKey(1), (4, len(jm.anchors()))))
    return jm, randomize(_np(v)), batch, prio


def _detections(anchors, b: int = 4, seed: int = 4):
    """Made-up eval-mode SSG outputs for a batch of ``b`` at 128^2 whose
    class scores clear the keep threshold for a few anchors (seed 4 hits
    some ground-truth objects of the synthetic batch)."""
    n = len(anchors)
    r = np.random.RandomState(seed)
    logits = r.randn(b, n, 8).astype(np.float32)
    logits[:, r.choice(n, 30, replace=False), r.randint(1, 8)] += 4.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return {"protos": np.maximum(r.randn(b, 32, 32, 32), 0).astype(np.float32),
            "cls_pred": (e / e.sum(-1, keepdims=True)).astype(np.float32),
            "box_pred": (r.randn(b, n, 4) * 0.5).astype(np.float32),
            "ins_coef_pred": np.tanh(r.randn(b, n, 32)).astype(np.float32),
            "grasp_coef_pred": np.tanh(r.randn(b, n, 4, 32)).astype(np.float32)}


POST_KW = dict(ori_hw=(128, 128), max_detections=10, top_k=20)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, crog_models, crog_batch, ssg_models):
    """Writes the inputs and starts the two ranks; ``.results()`` waits."""
    _, v = crog_models
    sjm, sv, sbatch, prio = ssg_models
    crog_sd = state_dict_from_flax(v["params"], v["batch_stats"])
    geometry = {**GEOMETRY, "vision_layers": tuple(GEOMETRY["vision_layers"])}
    indir = tmp_path_factory.mktemp("ddp")
    out = indir / "cli"
    torch.save({
        "bn": _bn_inputs(False), "blocked": _bn_inputs(True),
        "crog": {"geometry": geometry, "cfg": CFG, "state_dict": crog_sd, "lr": LR,
                 "lr_multi": LR_MULTI, "batch": crog_batch},
        "ssg": {"geometry": SSG_GEOM, "anchors": sjm.anchors(), "priority": prio,
                "state_dict": ssg_state_dict_from_flax(sv["params"], sv["batch_stats"]),
                "lr": SSG_LR, "wd": SSG_WD, "loss_cfg": {"masks_to_train": SSG_K},
                "batch": {k: x for k, x in sbatch.items() if isinstance(x, np.ndarray)}},
        "val": {"geometry": geometry, "cfg": CFG, "state_dict": crog_sd,
                "samples": VAL_SAMPLES, "batch": VAL_BATCH},
        "ssg_val": {"anchors": sjm.anchors(), "outputs": _detections(sjm.anchors()),
                    "post_kw": POST_KW, "batch": sbatch},
        "cli": {"geometry": geometry, "cfg": CFG, "argv": [
            "--config", "config/OCID-VLG/crog_synthetic_r50.yaml", "--device", "cpu",
            "--opts", "wire_format", "legacy", "synthetic_samples", "4", "batch_size", "4",
            "batch_size_val", "2", "input_size", str(RES), "epochs", "1", "print_freq", "1",
            "workers", "1", "workers_val", "1", "output_folder", str(out),
            "exp_name", "ddp"]},
    }, indir / "inputs.pt")
    procs = Ranks(indir)
    yield procs
    procs.close()


@pytest.fixture(scope="module")
def crog_reference(crog_models, crog_batch):
    """The JAX step on the global batch of 4 in one process: (gradients,
    metrics, the state after the step)."""
    jm, v = crog_models
    dense = {k: jnp.asarray(crog_batch[k]) for k in JE._TRAIN_KEYS}
    targets = {k: dense[k] for k in ("mask", "qua", "sin", "cos", "wid")}

    def loss_fn(params):
        preds, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            dense["img"], dense["word"], train=True,
                            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JM.crog_losses(preds, targets)[0]

    jgrads = _np(jax.jit(jax.grad(loss_fn))(v["params"]))
    tx = JO.make_optimizer(v["params"], LR, LR_MULTI, [5], 0.1, 1)
    state = JE.TrainState.create(apply_fn=jm.apply, params=v["params"],
                                 batch_stats=v["batch_stats"], tx=tx)
    new_state, jmetrics = JE.make_train_step(jm, tx)(state, crog_batch, jax.random.PRNGKey(0))
    return jgrads, jmetrics, new_state


@pytest.mark.parametrize("case", ["crog", "crog_remat"])
def test_crog_train_step_on_two_ranks_matches_jax(ranks, crog_models, crog_reference, case):
    """2 ranks x 2 samples against the JAX step on the 4: the loss terms,
    iou / prec@50, every parameter's gradient after DDP's mean and the
    BatchNorm statistics; parameters and buffers equal across the ranks.
    ``crog_remat`` checkpoints the RN50 bottlenecks (``remat=True``), held
    against the same reference: its running statistics equal bit for bit
    those of the step without remat, every ``num_batches_tracked`` went up
    by 1, and its step issued as many all-reduces as the step without (one
    per train-mode BatchNorm forward and one per backward: the recompute
    replays the forward's sums)."""
    jm, v = crog_models
    jgrads, jmetrics, new_state = crog_reference
    results = ranks.results()
    r0, r1 = (r[case] for r in results)

    if case == "crog_remat":
        off = results[0]["crog"]
        for name, stat in r0["stats"].items():
            np.testing.assert_array_equal(stat, off["stats"][name], err_msg=name)
        assert set(r0["tracked"].values()) == {1}
        n_bn = sum(isinstance(m, BatchNorm) for m in CROG(**GEOMETRY, **CFG).modules())
        assert r0["all_reduces"] == off["all_reduces"] == 2 * n_bn
    assert r0["digest"] == r1["digest"]
    for name, stat in r0["stats"].items():
        np.testing.assert_array_equal(stat, r1["stats"][name], err_msg=name)
    got = r0["metrics"]
    # tolerances of test_train_step_matches_jax: loss terms 1e-4 relative,
    # IoU within 0.05 (a pixel on the threshold), Pr@50 equal
    for k in ("loss", "m_ins", "m_qua", "m_sin", "m_cos", "m_wid"):
        np.testing.assert_allclose(got[k], float(jmetrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["iou"], float(jmetrics["iou"]), atol=0.05)
    assert got["prec@50"] == float(jmetrics["prec@50"])
    gref = state_dict_from_flax(jgrads, jax.tree_util.tree_map(np.zeros_like,
                                                               v["batch_stats"]))
    gnorm = np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree_util.tree_leaves(jgrads)))
    for name, g in r0["grads"].items():
        err = np.linalg.norm(g - gref[name])
        assert err <= 2e-2 * np.linalg.norm(gref[name]) + 1e-6 * gnorm, f"grad {name}"
    assert set(r0["grads"]) == {n for n, p in CROG(**GEOMETRY, **CFG).named_parameters()
                                if p.requires_grad}
    new = state_dict_from_flax(_np(new_state.params), _np(new_state.batch_stats))
    for name, stat in r0["stats"].items():
        tol = 1e-3 if name.startswith("neck.norm_layer") else 1e-5
        assert_close_scaled(stat, new[name], tol, name)


def test_ssg_train_step_on_two_ranks_matches_jax(ranks, ssg_models):
    """2 ranks x 2 images against the JAX SSG step on the 4, the global
    batch's priorities drawn once: the 8 terms, every update and the
    BatchNorm statistics; parameters and buffers equal across the ranks."""
    jm, v, batch, prio = ssg_models
    tx = JO.make_optimizer(v["params"], SSG_LR, 1.0, [100], 0.95, 10, weight_decay=SSG_WD,
                           optimizer="adamw")
    state = JE.TrainState.create(apply_fn=jm.apply, params=v["params"],
                                 batch_stats=v["batch_stats"], tx=tx)
    new_state, jmetrics = JSE.make_ssg_train_step(jm, tx, jm.anchors(),
                                                  {"masks_to_train": SSG_K})(
        state, batch, jax.random.PRNGKey(1))
    r0, r1 = (r["ssg"] for r in ranks.results())

    assert r0["digest"] == r1["digest"]
    assert r0["drawn"] == r1["drawn"] == [(4, len(jm.anchors()))]
    for name, stat in r0["stats"].items():
        np.testing.assert_array_equal(stat, r1["stats"][name], err_msg=name)
    # tolerances of test_torch_ssg.py::test_train_step_matches_jax
    assert set(r0["metrics"]) == set(jmetrics)
    for k, ref in jmetrics.items():
        np.testing.assert_allclose(r0["metrics"][k], float(ref), rtol=1e-4, err_msg=k)
    before = ssg_state_dict_from_flax(v["params"], v["batch_stats"])
    new = ssg_state_dict_from_flax(_np(new_state.params), _np(new_state.batch_stats))
    for name, p in r0["params"].items():
        err = np.abs((p - before[name]) - (new[name] - before[name]))
        assert err.max() <= 2 * SSG_LR * (1 + 1e-3), name
        g = np.abs(r0["grads"][name])
        real = g > 0.1 * g.max()
        assert not real.any() or err[real].mean() <= 0.05 * SSG_LR, name
    for name, stat in r0["stats"].items():
        assert_close_scaled(stat, new[name], 1e-5, name)


@pytest.mark.parametrize("blocked", [False, True])
def test_batchnorm_statistics_are_global(ranks, blocked):
    """Each rank's rows through train-mode BatchNorm (or the s2d stem's
    blocked_bn_relu) against flax nn.BatchNorm over all 4 rows: output,
    dx, dscale and dbias summed over the ranks, and each rank's running
    statistics.  dx holds the other rank's terms through the statistics."""
    import flax.linen as nn

    inp = _bn_inputs(blocked)
    c = inp["scale"].shape[0]
    fb = nn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
    variables = {"params": {"scale": inp["scale"], "bias": inp["bias"]},
                 "batch_stats": {"mean": inp["mean0"], "var": inp["var0"]}}
    x = jnp.asarray(inp["x"])

    def f(x, params):
        xs = x.reshape(x.shape[:-1] + (4, c)) if blocked else x
        y, mut = fb.apply({**variables, "params": params}, xs, mutable=["batch_stats"])
        y = jax.nn.relu(y).reshape(x.shape) if blocked else y
        return jnp.vdot(y, inp["cot"]), (y, mut["batch_stats"])

    (_, (ref, stats)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        x, variables["params"])
    got = [r["blocked" if blocked else "bn"] for r in ranks.results()]
    # tolerances of test_train_batchnorm_matches_flax
    assert_close_scaled(np.concatenate([g["y"] for g in got]), np.asarray(ref), 1e-6)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]), np.asarray(gx),
                               rtol=0, atol=1e-5 * np.abs(inp["cot"]).max(), err_msg="dx")
    assert_close_scaled(got[0]["dscale"] + got[1]["dscale"], np.asarray(gp["scale"]), 1e-5)
    assert_close_scaled(got[0]["dbias"] + got[1]["dbias"], np.asarray(gp["bias"]), 1e-5)
    for g in got:
        assert_close_scaled(g["mean"], np.asarray(stats["mean"]), 1e-6)
        assert_close_scaled(g["var"], np.asarray(stats["var"]), 1e-6)


def test_validate_gathers_the_whole_split(ranks, crog_models):
    """validate_with_grasp on two ranks, each shard ending in a padded
    batch, against one process at the global batch and against the JAX
    package's summarize_eval of the gathered lists: each sample once."""
    _, v = crog_models
    net = CROG(**GEOMETRY, **CFG)
    load_numpy_state_dict(net, state_dict_from_flax(v["params"], v["batch_stats"]))
    loader = DataLoader(SyntheticOCIDVLG(num_samples=VAL_SAMPLES, split="val",
                                         input_size=RES), VAL_BATCH, pad_last_batch=True)
    ref = validate_with_grasp(loader, make_eval_step(net.eval(), input_size=RES,
                                                     device="cpu"))
    outs = [r["val"] for r in ranks.results()]
    assert [o["n_valid"] for o in outs] == [[3, 2], [3, 1]]
    got = outs[0]["result"]
    for key in ("iou_list", "j1_hits", "j5_hits", "iou", "prec", "j_index@1", "j_index@5"):
        assert outs[1]["result"][key] == got[key], key
    assert len(got["iou_list"]) == len(got["j1_hits"]) == VAL_SAMPLES
    # per-sample IoU within 1e-3 (fp32 sums in another order, thresholded),
    # J@1, J@5 and Pr@K equal, as tests/test_torch_eval_cli.py
    np.testing.assert_allclose(sorted(got["iou_list"]), sorted(ref["iou_list"]), rtol=0,
                               atol=1e-3)
    assert sorted(got["j1_hits"]) == sorted(ref["j1_hits"])
    assert sorted(got["j5_hits"]) == sorted(ref["j5_hits"])
    for key in ("prec", "j_index@1", "j_index@5"):
        assert got[key] == ref[key], key
    jres = JE.summarize_eval(got["iou_list"], got["j1_hits"], got["j5_hits"])
    for key in ("iou", "prec", "j_index@1", "j_index@5"):
        assert got[key] == jres[key], key


def test_ssg_validate_sums_hits_over_ranks(ranks, ssg_models):
    """SSG's per-object J@1 / J@5 on two ranks' halves of a batch and of
    made-up detections equal one process's over the whole and the JAX
    package's validate."""
    from crog_tpu.models.ssg_eval import make_ssg_post_processing as j_post
    from crog_tpu_torch.engine.ssg_engine import validate
    from crog_tpu_torch.models.ssg_eval import make_ssg_post_processing

    jm, _, batch, _ = ssg_models
    anchors = jm.anchors()
    out = _detections(anchors)
    args = type("Args", (), {"epochs": 1})()
    one = validate([batch], make_ssg_post_processing(anchors, batched=True, **POST_KW),
                   lambda _: ({k: torch.from_numpy(x) for k, x in out.items()}, None), 1, args)
    ref = JSE.validate([batch], j_post(anchors, batched=True, **POST_KW),
                       lambda v, b: ({k: jnp.asarray(x) for k, x in out.items()}, None),
                       None, 1, args)
    got = [r["ssg_val"] for r in ranks.results()]
    assert got[0] == got[1] == one == ref
    assert 0 < one[0] < one[1]


def test_drop_last_gives_every_rank_the_same_steps():
    """With drop_last, two ranks take equal step counts from disjoint
    indices of one shuffled order, also when the sample count is odd."""
    from crog_tpu_torch.data.loader import EpochSampler

    for n in (22, 23):
        samplers = [EpochSampler(n, shuffle=True, seed=5, drop_last=True, batch_size=3,
                                 num_hosts=WORLD, host_id=r) for r in range(WORLD)]
        got = [[i for b in s.batches() for i in b] for s in samplers]
        assert len(samplers[0]) == len(samplers[1]) == (n // WORLD) // 3
        assert len(got[0]) == len(got[1]) == len(samplers[0]) * 3
        assert not set(got[0]) & set(got[1])


@pytest.mark.parametrize("n", [7, 250])
def test_ssg_validation_reads_the_same_samples_at_any_world(n):
    """train_ssg's validation set is the one-process run's (the first 101
    batches of batch_size_val 2, as crog_tpu's train_ssg.py reads them)
    at 1 to 4 ranks: the ranks' shards cover it, each sample once."""
    from crog_tpu_torch.train_ssg import VAL_BATCHES, ssg_val_loader

    bval = 2
    one = list(range(min(n, VAL_BATCHES * bval)))
    for world in (1, 2, 3, 4):
        loaders = [ssg_val_loader(list(range(n)), bval, None, world, r) for r in range(world)]
        got = [loader.dataset.indices[i] for loader in loaders
               for b in loader.sampler.batches() for i in b]
        assert sorted(got) == one, world
        for loader in loaders:
            assert loader.batch_size == max(1, bval // world)
            assert len(loader) == len(list(loader.sampler.batches()))
    whole = ssg_val_loader(list(range(n)), bval, None)
    assert [b for b in whole.sampler.batches()] == [
        one[i:i + bval] for i in range(0, len(one), bval)]


def test_train_cli_on_two_ranks_writes_once(ranks, monkeypatch):
    """train_crog under the group: one train.log with rank 0's lines only,
    one metrics.jsonl with the JAX CLI's keys, one last_model in the
    reference key schema, which the one-process test_crog loads."""
    ranks.results()
    out = ranks.indir / "cli"
    assert sorted(p.name for p in out.iterdir()) == ["ddp"]
    exp = out / "ddp"
    log = (exp / "train.log").read_text()
    for line in ("Device: cpu; 2 rank(s)", "Epoch 1:", "Evaluation: Epoch=[1/1]",
                 "* Training finished *"):
        assert log.count(line) == 1, line
    records = [json.loads(s) for s in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in records] == ["init", "log", "log", "finish"]
    assert {"train/epoch_time_s", "train/samples_per_s"} <= set(records[1])
    assert {"val/iou", "val/j_index@1", "val/j_index@5", "val/Pr@50"} <= set(records[2])
    payload = torch.load(exp / "last_model", map_location="cpu", weights_only=False)
    assert payload["step"] == 1 and payload["meta"]["epoch"] == 1
    assert set(payload["state_dict"]) == set(CROG(**GEOMETRY, **CFG).state_dict())
    monkeypatch.setattr(port_test_crog, "build_crog", lambda *_, **__: CROG(**GEOMETRY, **CFG))
    result = port_test_crog.main([
        "--config", "config/OCID-VLG/crog_synthetic_r50.yaml", "--device", "cpu",
        "--opts", "wire_format", "legacy", "synthetic_samples", "4", "batch_size_val", "2",
        "input_size", str(RES), "workers_val", "1", "resume", str(exp / "last_model"),
        "output_folder", str(out), "exp_name", "ddp"])
    assert len(result["iou_list"]) == 4 and np.isfinite(result["iou"])
    assert "=> loaded checkpoint" in (exp / "test.log").read_text()


def test_gather_metrics_concatenates_unequal_lengths(ranks):
    """Rank 0's three values, then rank 1's one, on both ranks."""
    for r in ranks.results():
        assert r["world"] == WORLD
        np.testing.assert_array_equal(r["gather"], [0, 1, 2, 10])
