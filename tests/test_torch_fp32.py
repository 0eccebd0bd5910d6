"""compute_dtype float32 in the port, on the CPU: the configs' key read as
crog_tpu reads it, the tiny CROG built from an fp32 config against
crog_tpu's built from the same config (its eval forward, and one train
step of make_train_step against crog_tpu's), the routing of each kernel's
operands to its bf16 or fp32 build, the guard that refuses an fp32 train
step on the fused s2d stem on the card, the C signatures of every kernel
entry point, and phase 18's twin controls.

The fp32 kernels themselves run only on a card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 18); their plain
twins are the ones tests/test_torch_kernels.py and
tests/test_torch_kernels_bwd.py hold against crog_tpu's Pallas kernels.
Logits are held to 1e-5 of their largest magnitude: both models compute in
fp32 and differ only in the order of their sums.
"""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.engine.crog_engine import check_train_kernels
from crog_tpu_torch.ops import cuda_build, work
from tests.torch_port_helpers import GEOMETRY, RES, TINY, assert_close_scaled, inputs, randomize

ROOT = Path(__file__).resolve().parent.parent
CROG_CONFIG = ROOT / "config/OCID-VLG/crog_synthetic_r50.yaml"
SSG_CONFIG = ROOT / "config/OCID-Grasp/ssg_r50.yaml"
TORCH_DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _cfg(path, compute_dtype, opts=()):
    cfg = merge_cfg_from_list(load_cfg_from_cfg_file(str(path)), list(opts))
    if compute_dtype is None:
        del cfg["compute_dtype"]
    else:
        cfg["compute_dtype"] = compute_dtype
    return cfg


def _tiny(monkeypatch):
    """Both packages' CROG classes, as their build_crog calls them, at the
    tests' tiny geometry (1 bottleneck per stage, 2 text layers, 128^2)."""
    import crog_tpu.models.crog as jc

    import crog_tpu_torch.models.crog as tc

    monkeypatch.setattr(jc, "CROG", functools.partial(jc.CROG, **GEOMETRY))
    monkeypatch.setattr(tc, "CROG", functools.partial(tc.CROG, **GEOMETRY))
    return jc, tc


TINY_OPTS = ("input_size", str(RES), "num_layers", str(TINY["num_layers"]), "dim_ffn",
             str(TINY["dim_ffn"]))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32", None])
def test_build_crog_reads_compute_dtype_as_crog_tpu(monkeypatch, compute_dtype):
    jc, tc = _tiny(monkeypatch)
    cfg = _cfg(CROG_CONFIG, compute_dtype, TINY_OPTS)
    jm, _ = jc.build_crog(cfg)
    assert tc.build_crog(cfg).dtype == TORCH_DTYPE[jm.dtype]


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32", None])
def test_build_ssg_reads_compute_dtype_as_crog_tpu(compute_dtype):
    from crog_tpu.models.ssg import build_ssg as jax_build_ssg

    from crog_tpu_torch.models.ssg import build_ssg

    cfg = _cfg(SSG_CONFIG, compute_dtype, ("img_size", "128", "resnet_layers", "[1,1,1,1]"))
    jm, _ = jax_build_ssg(cfg)
    assert build_ssg(cfg).dtype == TORCH_DTYPE[jm.dtype]


@pytest.fixture(scope="module")
def fp32_tiny():
    """(config, crog_tpu's CROG from it, its randomized variables as numpy):
    crog_synthetic_r50.yaml with compute_dtype float32 and dropout 0 at the
    tests' tiny geometry, built by crog_tpu's build_crog."""
    with pytest.MonkeyPatch.context() as mp:
        jc, _ = _tiny(mp)
        cfg = _cfg(CROG_CONFIG, "float32", TINY_OPTS + ("dropout", "0.0"))
        jm, _ = jc.build_crog(cfg)
    img, word = inputs()
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(word), train=False)
    return cfg, jm, randomize(jax.tree_util.tree_map(np.asarray, v))


def _port_crog(monkeypatch, cfg, v):
    """The port's CROG built by its build_crog from ``cfg`` (tiny geometry),
    holding the weights ``v``."""
    from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax

    _, tc = _tiny(monkeypatch)
    tm = tc.build_crog(cfg)
    load_numpy_state_dict(tm, state_dict_from_flax(v["params"], v["batch_stats"]))
    return tm


def test_tiny_crog_from_fp32_config_matches_crog_tpu(monkeypatch, fp32_tiny):
    """The port's CROG and crog_tpu's, each built by its build_crog from
    crog_synthetic_r50.yaml with compute_dtype float32 (tiny geometry),
    crog_tpu's randomized weights carried into the port: the eval logits
    agree."""
    cfg, jm, v = fp32_tiny
    tm = _port_crog(monkeypatch, cfg, v).eval()
    assert jm.dtype == jnp.float32 and tm.dtype == torch.float32
    img, word = inputs()
    ref = np.asarray(jm.apply(v, jnp.asarray(img), jnp.asarray(word), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(word))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, RES // 4, RES // 4, 5)
    assert_close_scaled(got.numpy(), ref, 1e-5)


FORWARD = ("attention", "decoder_self_block", "decoder_cross_block", "ffn")


@pytest.mark.parametrize("kernel", FORWARD)
def test_forward_kernels_route_bf16_and_fp32_to_their_builds(kernel):
    bf16, f32, kid = cuda_build.KERNELS[kernel]
    assert cuda_build.library_for(kernel, torch.bfloat16) == bf16
    assert cuda_build.library_for(kernel, torch.float32) == f32 == bf16 + "_f32"
    assert f32 in cuda_build.SIGNATURES and bf16 in cuda_build.SIGNATURES
    with pytest.raises(ValueError, match=f"{kid} takes bf16 or fp32"):
        cuda_build.library_for(kernel, torch.float16)


@pytest.mark.parametrize("kernel", [k + "_bwd" for k in FORWARD])
def test_backward_kernels_route_bf16_and_fp32_to_their_builds(kernel):
    bf16, f32, kid = cuda_build.KERNELS[kernel]
    assert cuda_build.library_for(kernel, torch.bfloat16) == bf16
    assert cuda_build.library_for(kernel, torch.float32) == f32 == bf16 + "_f32"
    assert f32 in cuda_build.SIGNATURES and bf16 in cuda_build.SIGNATURES
    with pytest.raises(ValueError, match=f"{kid} takes bf16 or fp32"):
        cuda_build.library_for(kernel, torch.float16)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_stem", [True, False])
def test_fp32_train_step_guard(device, dtype, fused_stem):
    """Only the fused s2d stem at fp32 on the card is refused (K6-f32 and
    K6b-f32 are queued); K1-K4b have fp32 builds."""
    if device == "cuda" and dtype == torch.float32 and fused_stem:
        with pytest.raises(NotImplementedError, match="K6-f32 and K6b-f32"):
            check_train_kernels(device, dtype, fused_stem)
    else:
        check_train_kernels(device, dtype, fused_stem)


def test_make_eval_step_builds_for_an_fp32_model(monkeypatch):
    """The guard is the train step's alone: make_eval_step builds for an
    fp32 CROG and never asks it."""
    from crog_tpu_torch.engine import crog_engine
    from crog_tpu_torch.models.crog import CROG

    def refuse(*args):
        raise AssertionError("make_eval_step asked the train step's guard")

    monkeypatch.setattr(crog_engine, "check_train_kernels", refuse)
    model = CROG(**GEOMETRY, **TINY, dtype=torch.float32)
    assert model.dtype == torch.float32
    assert callable(crog_engine.make_eval_step(model, input_size=RES, device="cpu"))


def _launch_counts():
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF
    from crog_tpu_torch.ops import s2dconv as SC

    return [getattr(w, a) for w in (A.fused_attention, A.attention_bwd, DB.self_block_fwd,
                                     DB.self_block_bwd, DB.cross_block_fwd,
                                     DB.cross_block_bwd, FF.ffn_fwd, FF.ffn_bwd)
            for a in ("launches", "launches_f32")] + [SC.s2dconv_fwd.launches,
                                                      SC.s2dconv_wgrad.launches]


def test_make_train_step_refuses_an_fp32_model_on_the_card_before_any_launch():
    """An fp32 model whose s2d stem runs on K6/K6b (queued at fp32): the
    guard runs inside make_train_step, before the step exists (no card is
    needed: the device is only named)."""
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.models.crog import CROG

    model = CROG(**GEOMETRY, **TINY, fused_stem=True)
    before = _launch_counts()
    with pytest.raises(NotImplementedError, match="K6-f32"):
        make_train_step(model, None, None, device="cuda")
    assert _launch_counts() == before


def test_make_train_step_builds_an_fp32_plain_stem_step_for_the_card():
    """An fp32 model on the plain stem gets its train step with the card
    named: nothing is refused and nothing is launched until a batch comes."""
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.models.crog import CROG

    model = CROG(**GEOMETRY, **TINY, dtype=torch.float32)
    assert model.dtype == torch.float32 and not model.backbone.visual.fused_stem
    before = _launch_counts()
    assert callable(make_train_step(model, None, None, device="cuda"))
    assert _launch_counts() == before


def _entry_points(src: str):
    """{name: argument count} of every ``extern "C"`` function defined in a
    CUDA source."""
    out = {}
    for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(crog_\w+)\s*\(([^)]*)\)\s*\{', src):
        args = [a for a in m.group(2).split(",") if a.strip() and a.strip() != "void"]
        out[m.group(1)] = len(args)
    return out


def test_every_entry_point_has_a_signature_with_its_argument_count():
    """Each csrc/<lib>.cu's extern "C" functions, parsed from the source,
    are exactly SIGNATURES[<lib>], with as many ctypes argument types as
    the C function has arguments."""
    sources = {p.stem: p.read_text() for p in sorted((cuda_build.CSRC).glob("*.cu"))}
    assert set(sources) == set(cuda_build.SIGNATURES)
    for lib, src in sources.items():
        found = _entry_points(src)
        want = {fn: len(types) for fn, types in cuda_build.SIGNATURES[lib].items()}
        assert found == want, lib
    assert {"attention_f32", "decoder_blocks_f32", "ffn_f32"} <= set(sources)


@pytest.mark.parametrize("dtype,aten,kernels", [
    (torch.bfloat16, work.PEAK_BF16_FLOPS, work.PEAK_BF16_FLOPS),
    (torch.float32, work.PEAK_F32_FLOPS, work.PEAK_F32_TC_FLOPS),
])
def test_peaks_follow_the_compute_dtype(dtype, aten, kernels):
    """tools/torch_roofline.py's FLOP peaks: the library's ops and the
    kernels at the compute dtype's rate (fp32: FMA units with TF32 off, and
    the kernels' 3xTF32)."""
    assert work.peaks(dtype) == (aten, kernels)


def test_fp32_wrappers_run_their_twins_on_the_cpu():
    """On CPU tensors the wrappers are the plain twins, in fp32, and launch
    nothing."""
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import ffn as FF

    r = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(r.randn(2, 70, 128).astype(np.float32)) for _ in range(3))
    before = A.fused_attention.launches_f32, FF.ffn_fwd.launches_f32
    got = A.fused_attention(q, k, v, 2)
    assert got.dtype == torch.float32 and torch.equal(got, A.attention_plain(q, k, v, 2))
    args = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in
            ((5, 512), (2048, 512), (2048,), (2048,), (2048,), (512, 2048), (512,))]
    assert torch.equal(FF.ffn_fwd(*args, 3, 0.1), FF.ffn_plain(*args, 3, 0.1))
    assert (A.fused_attention.launches_f32, FF.ffn_fwd.launches_f32) == before


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_round_tf32_rounds_as_cvt_rna():
    """chip_smoke.round_tf32 keeps 10 explicit mantissa bits, rounds to
    nearest with ties away from zero, and leaves TF32 values as they are."""
    cs = _chip_smoke()
    ulp = 2.0**-10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 1 + ulp / 2 - 2.0**-20,
                      3 + 2 * ulp, 0.0, -0.0, 2.0**-100], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 3 + 2 * ulp, 0.0, -0.0,
                         2.0**-100], dtype=torch.float32)
    assert torch.equal(cs.round_tf32(x), want)
    r = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32))
    got = cs.round_tf32(r)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert ((got - r).abs() <= r.abs() * 2.0**-11).all()
    assert torch.equal(cs.round_tf32(got), got)


def _small_twins():
    """Each fp32 kernel's twin at a small shape on the CPU."""
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    r = np.random.RandomState(2)
    t = lambda *s, std=1.0: torch.from_numpy((r.randn(*s) * std).astype(np.float32))
    d = 128
    q, k, v = t(2, 70, d), t(2, 70, d), t(2, 70, d)
    x, txt, pos, tpos = t(2, 20, d), t(2, 5, d), t(20, d, std=0.5), t(5, d, std=0.5)
    pad = torch.tensor([[False] * 5, [False, False, True, True, True]])
    w = [t(3 * d, d, std=d**-0.5), t(3 * d, std=0.05), t(d, d, std=d**-0.5), t(d, std=0.05),
         1 + t(d, std=0.1), t(d, std=0.05), 1 + t(d, std=0.1), t(d, std=0.05)]
    f = (t(9, d), t(256, d, std=d**-0.5), t(256, std=0.05), 1 + t(256, std=0.1),
         t(256, std=0.05), t(d, 256, std=256**-0.5), t(d, std=0.05))
    return {"attention_f32": lambda: A.attention_plain(q, k, v, 2),
            "decoder_self_block_f32": lambda: DB.self_block_plain(x, pos, *w, 2),
            "decoder_cross_block_f32": lambda: DB.cross_block_plain(x, txt, pos, tpos, pad,
                                                                    *w, 2),
            "ffn_f32": lambda: FF.ffn_plain(*f)}


def test_fp32_twin_controls_read_above_the_limit():
    """Phase 18's control: each fp32 twin with any one product formed by one
    TF32 pass or from bf16-staged operands reads above F32_REL_L2 against
    the sound twin (fp32_twin_controls also checks that each twin makes as
    many torch.matmul calls as F32_PRODUCTS names); torch.matmul is itself
    again afterwards."""
    cs = _chip_smoke()
    matmul = torch.matmul
    twins = _small_twins()
    refs = {n: twin() for n, twin in twins.items()}
    controls = cs.fp32_twin_controls(twins, refs)
    assert torch.matmul is matmul
    assert {n: set(c) for n, c in controls.items()} == {
        n: set(p) for n, p in cs.F32_PRODUCTS.items()}
    for name, by_product in controls.items():
        for product, by_fault in by_product.items():
            assert set(by_fault) == {"1xTF32", "bf16-staged"}
            for fault, rel in by_fault.items():
                assert rel > cs.F32_REL_L2, (name, product, fault)
    with cs.lossy_products() as sound:
        again = twins["decoder_self_block_f32"]()
    assert sound.count == 6 and torch.equal(again, refs["decoder_self_block_f32"])


def _small_bwd_twins():
    """Each fp32 backward kernel's twin at a small shape on the CPU, with
    dropout in the blocks and the FFN."""
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    r = np.random.RandomState(3)
    t = lambda *s, std=1.0: torch.from_numpy((r.randn(*s) * std).astype(np.float32))
    d = 128
    q, k, v, do = t(2, 70, d), t(2, 70, d), t(2, 70, d), t(2, 70, d)
    o = A.attention_plain(q, k, v, 2)
    x, txt, pos, tpos = t(2, 20, d), t(2, 5, d), t(20, d, std=0.5), t(5, d, std=0.5)
    dy = t(2, 20, d)
    pad = torch.tensor([[False] * 5, [False, False, True, True, True]])
    w = [t(3 * d, d, std=d**-0.5), t(3 * d, std=0.05), t(d, d, std=d**-0.5), t(d, std=0.05),
         1 + t(d, std=0.1), t(d, std=0.05), 1 + t(d, std=0.1), t(d, std=0.05)]
    f = (t(9, d), t(256, d, std=d**-0.5), t(256, std=0.05), 1 + t(256, std=0.1),
         t(256, std=0.05), t(d, 256, std=256**-0.5), t(9, d))
    return {"attention_bwd_f32": lambda: A.attention_bwd_plain(q, k, v, o, do, 2),
            "decoder_self_block_bwd_f32": lambda: DB.self_block_bwd_plain(
                x, pos, *w, dy, 2, 5, 0.1),
            "decoder_cross_block_bwd_f32": lambda: DB.cross_block_bwd_plain(
                x, txt, pos, tpos, pad, *w, dy, 2, 6, 0.1),
            "ffn_bwd_f32": lambda: FF.ffn_bwd_plain(*f, 7, 0.1)}


@pytest.mark.parametrize("name", ["attention_bwd_f32", "decoder_self_block_bwd_f32",
                                  "decoder_cross_block_bwd_f32", "ffn_bwd_f32"])
def test_fp32_backward_twin_controls_read_above_the_limit(name):
    """Phase 18's control for a backward kernel: its fp32 twin with any one
    of the kernel's products (F32_BWD_PRODUCTS) formed by one TF32 pass or
    from bf16-staged operands reads above F32_BWD_REL_L2 on its worst
    gradient output against the sound twin."""
    cs = _chip_smoke()
    twin = _small_bwd_twins()[name]
    ref = twin()
    controls = cs.fp32_twin_controls({name: twin}, {name: ref},
                                     {name: cs.F32_BWD_PRODUCTS[name]})
    assert set(controls[name]) == set(cs.F32_BWD_PRODUCTS[name])
    for product, by_fault in controls[name].items():
        assert set(by_fault) == {"1xTF32", "bf16-staged"}
        for fault, rel in by_fault.items():
            assert rel > cs.F32_BWD_REL_L2, (product, fault, rel)
    assert cs.worst_rel_l2(twin(), ref) == 0.0


def test_tiny_fp32_train_step_matches_crog_tpu(monkeypatch, fp32_tiny):
    """The slice on the CPU: the tiny CROG built by each package's
    build_crog from crog_synthetic_r50.yaml with compute_dtype float32 and
    dropout 0, crog_tpu's randomized weights in both; one step of the
    port's make_train_step against crog_tpu's loss and gradients on the same
    batch and its optimizer's update of them: the loss to 1e-4 relative,
    every gradient and BatchNorm statistic as tests/test_torch_train.py
    holds them (assert_step_matches_jax), and each parameter's Adam update
    to within twice the step's learning rate everywhere and to 5% of it on
    average where the gradient is not zero up to rounding."""
    import optax

    from crog_tpu.engine import crog_engine as JE
    from crog_tpu.engine import optim as JO
    from crog_tpu.models import crog as JM

    from crog_tpu_torch.engine import optim as TO
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.models.convert import state_dict_from_flax
    from tests.torch_port_helpers import assert_step_matches_jax, train_batch

    cfg, jm, v = fp32_tiny
    tm = _port_crog(monkeypatch, cfg, v)
    assert jm.dtype == jnp.float32 and tm.dtype == torch.float32
    batch = train_batch()
    dense = {k: jnp.asarray(batch[k]) for k in JE._TRAIN_KEYS}
    targets = {k: dense[k] for k in ("mask", "qua", "sin", "cos", "wid")}

    def loss_fn(params):
        preds, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                              dense["img"], dense["word"], train=True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JM.crog_losses(preds, targets, jm.use_grasp_masks)[0], mut["batch_stats"]

    (loss, stats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    lr, lr_multi = 1e-3, 0.1
    tx = JO.make_optimizer(v["params"], lr, lr_multi, [5], 0.1, 1)
    stepped = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    zeros = jax.tree_util.tree_map(np.zeros_like, v["batch_stats"])
    gref = state_dict_from_flax(as_np(jgrads), zeros)
    new = state_dict_from_flax(as_np(stepped(jgrads, v["params"])), as_np(stats))

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, sched = TO.make_optimizer(tm, lr, lr_multi, [5], 0.1, 1)
    metrics = make_train_step(tm, opt, sched, device="cpu")(batch)
    grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.requires_grad}
    assert_step_matches_jax((metrics["loss"].item(), grads,
                             {n: b.clone() for n, b in tm.named_buffers()}),
                            (float(loss), gref, new))
    gnorm = np.sqrt(sum(float(np.sum(np.square(gref[n]))) for n in grads))
    for name in grads:
        step_lr = lr * (lr_multi if TO.param_group_label(name) == "backbone" else 1.0)
        moved = (dict(tm.named_parameters())[name].detach() - before[name]).numpy()
        upd_err = np.abs(moved - (new[name] - before[name].numpy()))
        assert upd_err.max() <= 2 * step_lr * (1 + 1e-3), f"update {name}"
        real = np.abs(gref[name]) > 1e-6 * gnorm
        if real.any():
            assert upd_err[real].mean() <= 0.05 * step_lr, f"update {name}"
