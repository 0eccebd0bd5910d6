"""compute_dtype float32 in the port, on the CPU: the configs' key read as
crog_tpu reads it, the tiny CROG built from an fp32 config against
crog_tpu's built from the same config (its eval forward, and one train
step of make_train_step against crog_tpu's), on the plain and on the fused
s2d stem, the routing of each kernel's operands to its bf16 or fp32 build,
the train step built for the card at every dtype and stem, the C
signatures of every kernel entry point, and phase 18's twin controls.

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


def _port_crog(monkeypatch, cfg, v, fused_stem: bool = False):
    """The port's CROG built by its build_crog from ``cfg`` (tiny geometry),
    holding the weights ``v``; ``fused_stem`` runs its s2d stem's conv2 and
    conv3 through ``blocked_conv3x3_s1`` (K6/K6b, their twins on the CPU)."""
    from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax

    _, tc = _tiny(monkeypatch)
    tm = tc.build_crog(cfg, fused_stem=fused_stem)
    visual = tm.backbone.visual
    assert visual.stem_s2d and visual.fused_stem == fused_stem
    load_numpy_state_dict(tm, state_dict_from_flax(v["params"], v["batch_stats"]))
    return tm


@pytest.fixture(scope="module")
def fp32_eval_ref(fp32_tiny):
    """crog_tpu's eval logits of ``fp32_tiny`` on the tests' inputs.  The
    JAX model takes XLA's conv in its stem off a TPU, so one reference
    serves the port's plain and fused stems."""
    _, jm, v = fp32_tiny
    img, word = inputs()
    return np.asarray(jm.apply(v, jnp.asarray(img), jnp.asarray(word), train=False))


def _check_eval(monkeypatch, fp32_tiny, ref, fused_stem: bool):
    from crog_tpu_torch.ops import s2dconv as SC

    cfg, jm, v = fp32_tiny
    tm = _port_crog(monkeypatch, cfg, v, fused_stem).eval()
    assert jm.dtype == jnp.float32 and tm.dtype == torch.float32
    calls = []
    twin = SC.conv_padded_plain
    monkeypatch.setattr(SC, "conv_padded_plain", lambda *a: calls.append(a[0].dtype) or twin(*a))
    img, word = inputs()
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(word))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, RES // 4, RES // 4, 5)
    assert_close_scaled(got.numpy(), ref, 1e-5)
    # the fused stem's conv2 and conv3 went through K6's wrapper, in fp32
    assert calls == ([torch.float32] * 2 if fused_stem else [])


def test_tiny_crog_from_fp32_config_matches_crog_tpu(monkeypatch, fp32_tiny, fp32_eval_ref):
    """The port's CROG and crog_tpu's, each built by its build_crog from
    crog_synthetic_r50.yaml with compute_dtype float32 (tiny geometry),
    crog_tpu's randomized weights carried into the port: the eval logits
    agree."""
    _check_eval(monkeypatch, fp32_tiny, fp32_eval_ref, False)


def test_tiny_crog_from_fp32_config_on_the_fused_stem_matches_crog_tpu(monkeypatch, fp32_tiny,
                                                                       fp32_eval_ref):
    """As above with the port's s2d stem fused (``--fused-stem``): conv2 and
    conv3 in fp32 through K6's wrapper (its twin on the CPU) against the
    function crog_tpu computes there."""
    _check_eval(monkeypatch, fp32_tiny, fp32_eval_ref, True)


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


@pytest.mark.parametrize("kernel", ["s2dconv", "s2dconv_wgrad"])
def test_s2d_kernels_route_bf16_and_fp32_to_their_builds(kernel):
    """K6 and K6b: bf16 operands to csrc/s2dconv.cu, fp32 to
    csrc/s2dconv_f32.cu, any other dtype refused."""
    bf16, f32, kid = cuda_build.KERNELS[kernel]
    assert cuda_build.library_for(kernel, torch.bfloat16) == bf16 == "s2dconv"
    assert cuda_build.library_for(kernel, torch.float32) == f32 == "s2dconv_f32"
    assert f32 in cuda_build.SIGNATURES and bf16 in cuda_build.SIGNATURES
    assert kid == ("K6b" if kernel == "s2dconv_wgrad" else "K6")
    with pytest.raises(ValueError, match=f"{kid} takes bf16 or fp32"):
        cuda_build.library_for(kernel, torch.float16)


def test_make_eval_step_builds_for_an_fp32_model():
    """make_eval_step builds for an fp32 CROG on the fused s2d stem."""
    from crog_tpu_torch.engine import crog_engine
    from crog_tpu_torch.models.crog import CROG

    model = CROG(**GEOMETRY, **TINY, dtype=torch.float32, fused_stem=True)
    assert model.dtype == torch.float32 and model.backbone.visual.fused_stem
    assert callable(crog_engine.make_eval_step(model, input_size=RES, device="cpu"))


def _launch_counts():
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF
    from crog_tpu_torch.ops import s2dconv as SC

    return [getattr(w, a) for w in (A.fused_attention, A.attention_bwd, DB.self_block_fwd,
                                     DB.self_block_bwd, DB.cross_block_fwd,
                                     DB.cross_block_bwd, FF.ffn_fwd, FF.ffn_bwd)
            for a in ("launches", "launches_f32")] + [
        getattr(w, a) for w in (SC.s2dconv_fwd, SC.s2dconv_wgrad)
        for a in ("launches", "launches_f32")]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_stem", [True, False])
def test_make_train_step_builds_for_every_device_dtype_and_stem(device, dtype, fused_stem):
    """Every kernel of the train step has a build at both dtypes (K6-f32 and
    K6b-f32 for the fused s2d stem at fp32), so make_train_step builds for
    each (device, dtype, stem), with the card only named, and launches
    nothing until a batch comes."""
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.models.crog import CROG

    model = CROG(**GEOMETRY, **TINY, dtype=dtype, fused_stem=fused_stem)
    assert model.dtype == dtype and model.backbone.visual.fused_stem == fused_stem
    before = _launch_counts()
    assert callable(make_train_step(model, None, None, device=device))
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


@pytest.mark.parametrize("d", [256, 512, 768, 1024])
@pytest.mark.parametrize("kid", ["K2-f32", "K3-f32"])
def test_f32_block_products_fill_the_planes_workspace(kid, d):
    """K2-f32's and K3-f32's products as chip_smoke splits them, in launch
    order: their weights' rows are in_w's 3D and out_w's D, whose TF32 hi
    and lo planes (2 N D floats a product) fill the planes workspace the
    wrapper allocates, ops/decoder_blocks.py:f32_planes = 8 D^2 floats;
    the out-projection comes last, and only K3-f32's k and v run over the
    B*T text rows; at each width D the kernels take."""
    from crog_tpu_torch.ops import decoder_blocks as DB

    assert d in DB.KERNEL_D
    prods = _chip_smoke().F32_BLOCK_PRODUCTS[kid]
    assert sum(2 * cols * d * d for *_, cols in prods) == DB.f32_planes(d) == 8 * d * d
    assert prods[-1] == ("out-projection", "m", 1)
    text = ("k", "v") if kid == "K3-f32" else ()
    assert [rows for _, rows, _ in prods] == ["mt" if p[0] in text else "m" for p in prods]


def test_f32_parts_split_each_launch_sequence_by_name():
    """chip_smoke.F32_PARTS: the n-th GEMM launch of an fp32 kernel is its
    n-th product, the attention kernel its attention step, whatever tree
    launched them (gemm_wgmma_f32.cuh and the wgmma attention, or the
    mma.sync kernels before them), and nothing is lost."""
    cs = _chip_smoke()
    new = [("ln_pos_f32_kernel<true>", 1.0), ("gw_split_b_kernel<0, false>", 0.5),
           ("gemm_wgmma_f32_kernel<0, false, 1>", 4.0), ("gw_split_b_kernel<0, false>", 0.5),
           ("gemm_wgmma_f32_kernel<0, false, 1>", 2.0), ("attn_fwd_f32_kernel<0, 0>", 8.0),
           ("gw_split_b_kernel<0, false>", 0.5), ("gemm_wgmma_f32_kernel<0, false, 1>", 2.0),
           ("ln_residual_f32_kernel", 1.0)]
    old = [("ln_pos_f32_kernel<true>", 1.0), ("gemm_f32_kernel<0>", 5.0),
           ("gemm_f32_kernel<0>", 3.0), ("attn_f32_kernel<0, 0>", 9.0),
           ("gemm_f32_kernel<0>", 3.0), ("ln_residual_f32_kernel", 1.0)]
    for seq, planes in ((new, 1.5), (old, None)):
        parts = dict(cs.F32_PARTS["K2-f32"](seq))
        want = {"ln_pos": 1.0, "q | k": seq[2 if planes else 1][1], "v": 2.0 if planes else 3.0,
                "attention step": 8.0 if planes else 9.0, "out-projection": 2.0 if planes else 3.0,
                "ln_residual": 1.0}
        if planes:
            want["B's TF32 planes"] = planes
        assert parts == want
        assert sum(parts.values()) == sum(t for _, t in seq)
    assert dict(cs.F32_PARTS["K1-f32"]([("attn_fwd_f32_kernel<0, 0>", 0.2)])) == {
        "attention step": 0.2}


@pytest.mark.parametrize("kid", ["K2b-f32", "K3b-f32"])
def test_f32_block_bwd_parts_split_both_trees_by_product(kid):
    """chip_smoke.F32_PARTS of K2b-f32 and K3b-f32: the n-th GEMM launch is
    the n-th product (dO, dX, then K3b-f32's d(txt), then the dW), whether
    gemm_wgmma_f32.cuh's kernel after B's TF32 planes or an older tree's
    grad_f32.cuh gemm_kn; the attention kernels are the attention step, the
    LayerNorm backward rows (ln_post_bwd is not the forward's ln_pos) and
    the fixed-order sums their parts; nothing is lost."""
    cs = _chip_smoke()
    names = [p[0] for p in cs.f32_block_bwd_shapes(16224, 408)[kid]]
    assert names[:2] == ["dO", "dX"] and names[-1] == "dW out"
    dws = len(names) - (3 if kid == "K3b-f32" else 2)

    def seq(new):
        gemm = ("crog::gemm_wgmma_f32_kernel<0, crog::GwAMatrix<{}>, 0>" if new
                else "crog::gemm_kn_f32_kernel<0, {}>")
        split = [("crog::gw_split_b_kernel<0, true>", 0.5)] if new else []
        attn = [("crog::attn_bwd_f32_stats_kernel<1>", 3.0), ("crog::attn_bwd_f32_main_kernel", 5.0),
                ("crog::attn_bwd_f32_dq_sum_kernel", 1.0)]
        out = [("crog::ln_post_bwd_f32_kernel", 0.25), ("crog::reduce_parts_kernel", 0.125),
               ("crog::reduce_parts_kernel", 0.125), *split, (gemm.format("false"), 2.0), *attn]
        for _ in names[1:len(names) - dws]:
            out += [*split, (gemm.format("false"), 2.0)]
        out += [("crog::ln_pre_bwd_f32_kernel", 0.25), ("crog::reduce_parts_kernel", 0.125)]
        for _ in range(dws):
            out += [*split, (gemm.format("true"), 4.0), ("crog::reduce_parts_kernel", 0.125)]
        return out + [("crog::colsum_part_kernel", 0.125), ("crog::reduce_parts_kernel", 0.125)]

    for new in (True, False):
        launches = seq(new)
        parts = dict(cs.F32_PARTS[kid](launches))
        want = {"LayerNorm": 0.5, "fixed-order sums": 0.125 * (dws + 5), "attention step": 9.0,
                **{n: 2.0 for n in names[:len(names) - dws]}, **{n: 4.0 for n in names[-dws:]}}
        if new:
            want["B's TF32 planes"] = 0.5 * len(names)
        assert parts == want
        assert sum(parts.values()) == sum(t for _, t in launches)


@pytest.mark.parametrize("b,l,t", [(24, 676, 17), (9, 301, 23), (10, 50, 17), (3, 301, 17),
                                   (1, 5, 9), (1, 1, 1)])
def test_f32_bwd_chunk_plan_covers_every_row_and_fills_the_card(b, l, t):
    """ops/decoder_blocks.py f32_bwd_products / f32_bwd_chunks, the mirror
    of csrc/decoder_blocks_bwd_f32.cu's bwd_chunk: every product's depth is
    covered once, in order, by chunks of a multiple of 32 (the last one
    shorter); its output tiles times its chunks stay within one wave of 132
    CTAs where it is split; at the main path (B 24) each dW over the B*L
    rows runs 128 CTAs ([512, 512] in 8 chunks, [1024, 512] in 4), and
    d(txt), dWk and dWv over the 408 text rows at least 64; the products
    are chip_smoke's (``f32_block_bwd_shapes``); and the workspaces the
    wrapper allocates (``f32_bwd_work``) hold every partial and every B's
    planes the C side indexes."""
    from crog_tpu_torch.ops import decoder_blocks as DB

    cs = _chip_smoke()
    m, mt, d = b * l, b * t, 512
    shapes = cs.f32_block_bwd_shapes(m, mt, d)
    for kid, text in (("K2b-f32", None), ("K3b-f32", mt)):
        prods = DB.f32_bwd_products(m, text, d)
        assert [(n, (r, c), k) for n, (r, c), k, _ in prods] == [
            (n, (r, c), k) for n, (r, k, c), _ in shapes[kid]]
        need_part = need_planes = 0
        for name, (rows, cols), k, chunks in prods:
            assert chunks[0][0] == 0 and chunks[-1][1] == k
            assert all(a1 == b0 for (_, a1), (b0, _) in zip(chunks, chunks[1:]))
            assert all((k1 - k0) % 32 == 0 for k0, k1 in chunks[:-1])
            assert all(0 < k1 - k0 <= chunks[0][1] for k0, k1 in chunks)
            ctas = -(-rows // 128) * (cols // 128) * len(chunks)
            if len(chunks) > 1:
                assert ctas <= DB.F32_BWD_WAVE, (name, ctas)
                need_part = max(need_part, len(chunks) * rows * cols)
            need_planes = max(need_planes, 2 * cols * (-(-k // 4) * 4))
            if b == 24:
                want = {"dW q|k": 4, "dW v": 8, "dW out": 8, "dWq": 8}.get(name)
                if want is not None:
                    assert (len(chunks), ctas) == (want, 128), name
                if name in ("d(txt)", "dWk", "dWv"):
                    assert (rows if name == "d(txt)" else k) == 408 and ctas >= 64, name
        assert DB.f32_bwd_work(m, text, d) == (max(need_part, 1), need_planes)


def test_f32_bwd_chunk_plan_mirrors_the_c_side():
    """The Python mirror's tile, slice and wave are the C side's (kGwM,
    kGwN, kGwK in csrc/gemm_wgmma_f32.cuh; kBwdWave in
    csrc/decoder_blocks_bwd_f32.cu)."""
    from crog_tpu_torch.ops import decoder_blocks as DB

    gw = (cuda_build.CSRC / "gemm_wgmma_f32.cuh").read_text()
    src = (cuda_build.CSRC / "decoder_blocks_bwd_f32.cu").read_text()
    const = lambda text, n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))  # noqa: E731
    assert const(gw, "kGwM") == const(gw, "kGwN") == DB.F32_TILE
    assert const(gw, "kGwK") == DB.F32_SLICE
    assert const(src, "kBwdWave") == DB.F32_BWD_WAVE


def test_pool_qk_grads_f64_matches_autograd():
    """chip_smoke.pool_qk_grads_f64 (the attention pool's dWq and dWk with
    the backward written out) against float64 autograd through the same
    forward (q, k, v projections, per-head softmax attention) at a tiny
    size, to 1e-12 of the gradients' magnitude."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    b, n, c, heads = 2, 7, 16, 4
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape))  # noqa: E731
    tokens, da = f(b, n, c), f(b, n, c)
    w = [f(c, c) * c**-0.5 if i % 2 == 0 else f(c) * 0.1 for i in range(6)]
    leaves = [t.clone().requires_grad_() for t in w]
    split = lambda z: z.reshape(b, n, heads, c // heads).transpose(1, 2)  # noqa: E731
    q, k, v = (split(tokens @ leaves[2 * i].t() + leaves[2 * i + 1]) for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) * (c // heads) ** -0.5, -1)
    a = (p @ v).transpose(1, 2).reshape(b, n, c)
    dwq, dwk = torch.autograd.grad((a * da).sum(), [leaves[0], leaves[2]])
    got = cs.pool_qk_grads_f64(tokens.float(), da.float(), *w, heads)
    ref = cs.pool_qk_grads_f64(tokens, da, *w, heads)
    for g, r in zip(ref, (dwq, dwk)):
        assert g.dtype == torch.float64
        assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())
    assert all(float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
               for g, r in zip(got, (dwq, dwk)))


def test_s2d_f32_parts_and_executed_flops():
    """chip_smoke's split of a K6-f32 / K6b-f32 launch (``s2d_f32_parts``):
    the product (gemm_wgmma_f32.cuh's kernel, or an older tree's
    s2dconv_f32 kernel), the TF32 planes and the fixed-order sums, nothing
    lost; the FLOPs each executes (``s2d_f32_executed``): the whole packed
    weight, less the quarter of the slot-rows K6-f32 skips where a tile's
    output columns are all of one dy' (conv3's forward, co 64), 16/9 of the
    real taps elsewhere; and each launch's widths (a dgrad swaps them)."""
    from crog_tpu_torch.ops import work

    cs = _chip_smoke()
    new = [("crog::gw_split_b_kernel<0, true>", 0.3),
           ("crog::gemm_wgmma_f32_kernel<0, crog::S2dPatchT<32>, 0>", 0.6),
           ("crog::reduce_parts_kernel", 0.01)]
    old = [("crog::s2dconv_f32_wgrad_kernel<0, 32>", 1.3), ("crog::reduce_parts_kernel", 0.01)]
    assert dict(cs.s2d_f32_parts(new)) == {"planes": 0.3, "product": 0.6, "sums": 0.01}
    assert dict(cs.s2d_f32_parts(old)) == {"product": 1.3, "sums": 0.01}
    assert [cs.s2d_launch_widths(f"conv3 {k}") for k in ("forward", "dgrad", "wgrad")] == [
        (32, 64), (64, 32), (32, 64)]
    for label in ("conv2 forward", "conv2 dgrad", "conv3 dgrad", "conv2 wgrad", "conv3 wgrad",
                  "conv3 forward"):
        real = work.s2dconv_flops(cs.BATCH, 104, 104, *cs.s2d_launch_widths(label))
        share = 0.75 if label == "conv3 forward" else 1.0
        assert cs.s2d_f32_executed(label) == pytest.approx(real * 16 / 9 * share)


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


LR, LR_MULTI = 1e-3, 0.1


@pytest.fixture(scope="module")
def fp32_step_ref(fp32_tiny):
    """(batch, loss, gradients, parameters and BatchNorm statistics after
    the Adam step) of one crog_tpu train step of ``fp32_tiny`` on the tests'
    train batch, as the port's state_dict names them.  The JAX model takes
    XLA's conv in its stem off a TPU, so one reference serves the port's
    plain and fused stems."""
    import optax

    from crog_tpu.engine import crog_engine as JE
    from crog_tpu.engine import optim as JO
    from crog_tpu.models import crog as JM

    from crog_tpu_torch.models.convert import state_dict_from_flax
    from tests.torch_port_helpers import train_batch

    _, jm, v = fp32_tiny
    batch = train_batch()
    dense = {k: jnp.asarray(batch[k]) for k in JE._TRAIN_KEYS}
    targets = {k: dense[k] for k in ("mask", "qua", "sin", "cos", "wid")}

    def loss_fn(params):
        preds, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                              dense["img"], dense["word"], train=True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JM.crog_losses(preds, targets, jm.use_grasp_masks)[0], mut["batch_stats"]

    (loss, stats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    tx = JO.make_optimizer(v["params"], LR, LR_MULTI, [5], 0.1, 1)
    stepped = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    zeros = jax.tree_util.tree_map(np.zeros_like, v["batch_stats"])
    gref = state_dict_from_flax(as_np(jgrads), zeros)
    new = state_dict_from_flax(as_np(stepped(jgrads, v["params"])), as_np(stats))
    return batch, float(loss), gref, new


def _check_train_step(monkeypatch, fp32_tiny, ref, fused_stem: bool):
    from crog_tpu_torch.engine import optim as TO
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.ops import s2dconv as SC
    from tests.torch_port_helpers import assert_step_matches_jax

    cfg, jm, v = fp32_tiny
    batch, loss, gref, new = ref
    tm = _port_crog(monkeypatch, cfg, v, fused_stem)
    assert jm.dtype == jnp.float32 and tm.dtype == torch.float32
    calls = []
    for name in ("conv_padded_plain", "wgrad_plain"):
        twin = getattr(SC, name)
        monkeypatch.setattr(SC, name, lambda *a, name=name, twin=twin: calls.append(
            (name, a[0].dtype)) or twin(*a))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, sched = TO.make_optimizer(tm, LR, LR_MULTI, [5], 0.1, 1)
    metrics = make_train_step(tm, opt, sched, device="cpu")(batch)
    grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.requires_grad}
    assert_step_matches_jax((metrics["loss"].item(), grads,
                             {n: b.clone() for n, b in tm.named_buffers()}),
                            (loss, gref, new))
    gnorm = np.sqrt(sum(float(np.sum(np.square(gref[n]))) for n in grads))
    for name in grads:
        step_lr = LR * (LR_MULTI if TO.param_group_label(name) == "backbone" else 1.0)
        moved = (dict(tm.named_parameters())[name].detach() - before[name]).numpy()
        upd_err = np.abs(moved - (new[name] - before[name].numpy()))
        assert upd_err.max() <= 2 * step_lr * (1 + 1e-3), f"update {name}"
        real = np.abs(gref[name]) > 1e-6 * gnorm
        if real.any():
            assert upd_err[real].mean() <= 0.05 * step_lr, f"update {name}"
    # the fused stem: conv2 and conv3 forward, their dgrads (K6) and their
    # weight gradients (K6b), all in fp32; the plain stem: none
    want = ([("conv_padded_plain", torch.float32)] * 4 + [("wgrad_plain", torch.float32)] * 2
            if fused_stem else [])
    assert sorted(calls) == want


def test_tiny_fp32_train_step_matches_crog_tpu(monkeypatch, fp32_tiny, fp32_step_ref):
    """The slice on the CPU: the tiny CROG built by each package's
    build_crog from crog_synthetic_r50.yaml with compute_dtype float32 and
    dropout 0, crog_tpu's randomized weights in both; one step of the
    port's make_train_step against crog_tpu's loss and gradients on the same
    batch and its optimizer's update of them: the loss to 1e-4 relative,
    every gradient and BatchNorm statistic as tests/test_torch_train.py
    holds them (assert_step_matches_jax), and each parameter's Adam update
    to within twice the step's learning rate everywhere and to 5% of it on
    average where the gradient is not zero up to rounding."""
    _check_train_step(monkeypatch, fp32_tiny, fp32_step_ref, False)


def test_tiny_fp32_train_step_on_the_fused_stem_matches_crog_tpu(monkeypatch, fp32_tiny,
                                                                  fp32_step_ref):
    """As above with the port's s2d stem fused (``--fused-stem``): the stem's
    conv2 and conv3, their dgrads and weight gradients in fp32 through K6's
    and K6b's wrappers (their twins on the CPU)."""
    _check_train_step(monkeypatch, fp32_tiny, fp32_step_ref, True)


def _small_s2d_twins():
    """K6-f32's and K6b-f32's twins at a small ragged shape on the CPU
    (conv3's widths, ci 32 and co 64), on ReLU'd activations as the stem
    hands them over."""
    from crog_tpu_torch.ops import s2dconv as SC

    r = np.random.RandomState(4)
    t = lambda *s, std=1.0: torch.from_numpy((r.randn(*s) * std).astype(np.float32))
    x, dy = torch.relu(t(2, 5, 7, 128)), t(2, 5, 7, 256)
    wp = SC.pack_s1(t(3, 3, 32, 64, std=(2.0 / 288) ** 0.5))
    return {"s2dconv_f32": lambda: SC.conv_padded_plain(x, wp, 32, 64),
            "s2dconv_wgrad_f32": lambda: SC.wgrad_plain(x, dy, 32, 64)}


@pytest.mark.parametrize("name", ["s2dconv_f32", "s2dconv_wgrad_f32"])
def test_s2d_fp32_twin_controls_read_above_the_limit(name):
    """Phase 18's control for K6-f32 and K6b-f32: the twin with its one
    product (F32_S2D_PRODUCTS) formed by one TF32 pass or from bf16-staged
    operands reads above the kernel's limit (F32_REL_L2 forward,
    F32_BWD_REL_L2 wgrad) against the sound twin."""
    cs = _chip_smoke()
    twin = _small_s2d_twins()[name]
    ref = twin()
    products = {name: cs.F32_S2D_PRODUCTS[name]}
    controls = cs.fp32_twin_controls({name: twin}, {name: ref}, products)
    limit = cs.F32_BWD_REL_L2 if name == "s2dconv_wgrad_f32" else cs.F32_REL_L2
    assert set(controls[name]) == set(products[name])
    for product, by_fault in controls[name].items():
        assert set(by_fault) == {"1xTF32", "bf16-staged"}
        for fault, rel in by_fault.items():
            assert rel > limit, (product, fault, rel)
    assert cs.worst_rel_l2(twin(), ref) == 0.0
