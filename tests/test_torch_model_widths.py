"""Decoder widths other than the configs' d_model 512, on the CPU: the
port's block and FFN twins at D 256, 768 and 1024 against the JAX
package's Pallas kernels in interpret mode (``fused_self_block`` /
``fused_cross_block`` through ``decoder_self_block`` /
``decoder_cross_block``, and ``fused_ffn``), forward and VJP with dropout
off; CROG's decoder stack at D 1024 against crog_tpu's; the whole CROG at
CLIP RN50x64's widths against crog_tpu's CROG in eval; and the wrappers'
width checks.

CLIP RN50x64 (OpenAI CLIP, ``clip.available_models()``; the geometry
``clip/model.py:build_model`` infers from its checkpoint): vision layers (3,
15, 36, 10), vision width 128, embed dim 1024, a text tower 1024 wide with
16 heads over 12 layers, resolution 448.  CROG's cross block takes the text
tower's tokens as keys and values unprojected, so its decoder is 1024 wide
(``vis_dim`` 1024) with the configs' 8 heads (head dim 128) and dim_ffn
2048; the FPN reads (1024, 2048, 1024) channels and writes (512, 1024,
2048).  Here its depth is cut to vision layers (1, 1, 1, 1), one text layer
and one decoder layer, at 128^2; the widths are RN50x64's.

Inputs: B 1 or 2, 40 tokens (80 rows of the FFN), 17 text tokens of which
9 are real, made from numpy seeds; the weights of the blocks and the FFN
from numpy seeds, scaled with 1 / sqrt(D) so that every width sees the
magnitudes of the D 512 tests; the whole CROG's from ``random_init_``
(a seeded torch generator) carried into crog_tpu by
``crog_tpu/models/convert.py:convert_crog_state_dict``.  Tolerances as in
the D 512 files they extend: the blocks' and the FFN's O(5) outputs to
2e-5 absolute (tests/test_torch_kernels.py), every gradient to 1e-4 of its
largest magnitude (tests/test_torch_kernels_bwd.py), the decoder stack and
CROG's logits to 2e-5 of their largest magnitude (tests/test_torch_modules.py,
tests/test_torch_crog.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_model_widths.py
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.ops.pallas_decoder import decoder_cross_block as jax_cross
from crog_tpu.ops.pallas_decoder import decoder_self_block as jax_self
from crog_tpu.ops.pallas_ffn import fused_ffn as jax_ffn
from crog_tpu_torch.ops import cuda_build
from crog_tpu_torch.ops import decoder_blocks as DB
from crog_tpu_torch.ops import ffn as FF
from tests.torch_port_helpers import assert_close_scaled

T = torch.from_numpy
SEED0 = jnp.zeros((), jnp.int32)
# (D, heads): 256 over 4 heads of 64, RN50x16's 768 over 12 of 64,
# RN50x64's 1024 over the configs' 8 (head dim 128)
WIDTHS = ((256, 4), (768, 12), (1024, 8))
L, TXT, F = 40, 17, 2048
BLOCK_ATOL, GRAD_TOL, REL = 2e-5, 1e-4, 2e-5
NAMES = ("in_w", "in_b", "out_w", "out_b", "g_pre", "b_pre", "g_post", "b_post")


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ----------------------------------------------------- K2, K3, K2b, K3b
def _block_weights(seed, d):
    """flax layout (wq, bq, wk, bk, wv, bv, wo, bo, LN affines); the
    projections' scale 0.06 at D 512, times sqrt(512 / D)."""
    r = np.random.RandomState(seed)
    s = 0.06 * (512 / d) ** 0.5
    ws = []
    for _ in range(4):
        ws += [r.randn(d, d).astype(np.float32) * s, r.randn(d).astype(np.float32) * 0.06]
    aff = [1 + 0.1 * r.randn(d), 0.1 * r.randn(d), 1 + 0.1 * r.randn(d), 0.1 * r.randn(d)]
    return ws + [a.astype(np.float32) for a in aff]


def _torch_block_args(w, grad=False):
    """flax layout -> the port's torch layout (in_w [3D, D], in_b, out_w,
    out_b, affines)."""
    wq, bq, wk, bk, wv, bv, wo, bo, g1, be1, g2, be2 = w
    in_w = np.concatenate([wq.T, wk.T, wv.T], 0)
    in_b = np.concatenate([bq, bk, bv])
    return [T(np.ascontiguousarray(a)).requires_grad_(grad)
            for a in (in_w, in_b, wo.T, bo, g1, be1, g2, be2)]


def _flax_block_grads(g):
    g = [np.asarray(t) for t in g]
    wq, bq, wk, bk, wv, bv, wo, bo, *aff = g
    return [np.concatenate([wq.T, wk.T, wv.T], 0), np.concatenate([bq, bk, bv]),
            wo.T, bo, *aff]


@functools.lru_cache(maxsize=None)
def _pallas_block(kind, d, heads):
    """The inputs (x, txt, pos, tpos, pad, weights, cotangent) and the
    Pallas block's output and VJP (dx, [dtxt,] weight grads) at width d, in
    eval (``kind`` "self" or "cross"; 2 samples of L queries, 17 text keys
    of which 9 and 17 are real), jitted once and shared by the tests."""
    seed = (1 if kind == "self" else 5) + d
    x = _rand(seed, 2, L, d, scale=0.5)
    kv = _rand(seed + 1, 2, TXT, d, scale=0.5)
    pos = _rand(seed + 2, L, d, scale=0.3)
    kpos = _rand(seed + 3, TXT, d, scale=0.3)
    pad = np.arange(TXT)[None] >= np.array([[9], [TXT]])
    w = _block_weights(seed + 4, d)
    cot = _rand(seed + 5, *x.shape)
    if kind == "self":
        f = lambda x, *w: jax_self(x, jnp.asarray(pos), *w, SEED0, heads, 0.1, False, True)
        args = (x, *w)
    else:
        f = lambda x, kv, *w: jax_cross(x, kv, jnp.asarray(pos), jnp.asarray(kpos),
                                        jnp.asarray(pad), *w, SEED0, heads, 0.1, False, True)
        args = (x, kv, *w)

    @jax.jit
    def run(args, cot):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(cot)

    y, grads = run(tuple(map(jnp.asarray, args)), jnp.asarray(cot))
    return (x, kv, pos, kpos, pad, w, cot), np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("d,heads", WIDTHS)
def test_self_block_matches_pallas_kernel_at_width(d, heads):
    (x, _, pos, _, _, w, _), ref, _ = _pallas_block("self", d, heads)
    got = DB.decoder_self_block(T(x), T(pos), *_torch_block_args(w), heads)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("d,heads", WIDTHS)
def test_cross_block_matches_pallas_kernel_at_width(d, heads):
    """L queries over 17 text keys, 8 of sample 0's padded."""
    (x, kv, pos, kpos, pad, w, _), ref, _ = _pallas_block("cross", d, heads)
    got = DB.decoder_cross_block(T(x), T(kv), T(pos), T(kpos), T(pad),
                                 *_torch_block_args(w), heads)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("d,heads", WIDTHS)
def test_self_block_grads_match_pallas_vjp_at_width(d, heads):
    (x, _, pos, _, _, w, cot), _, ref = _pallas_block("self", d, heads)
    xt, leaves = T(x).requires_grad_(), _torch_block_args(w, grad=True)
    y = DB.decoder_self_block(xt, T(pos), *leaves, heads)
    got = torch.autograd.grad(y, [xt] + leaves, T(cot))
    assert_close_scaled(got[0].numpy(), ref[0], GRAD_TOL, "dx")
    for name, g, r in zip(NAMES, got[1:], _flax_block_grads(ref[1:])):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, name)


@pytest.mark.parametrize("d,heads", WIDTHS)
def test_cross_block_grads_match_pallas_vjp_at_width(d, heads):
    (x, kv, pos, kpos, pad, w, cot), _, ref = _pallas_block("cross", d, heads)
    xt, kvt = T(x).requires_grad_(), T(kv).requires_grad_()
    leaves = _torch_block_args(w, grad=True)
    y = DB.decoder_cross_block(xt, kvt, T(pos), T(kpos), T(pad), *leaves, heads)
    got = torch.autograd.grad(y, [xt, kvt] + leaves, T(cot))
    assert_close_scaled(got[0].numpy(), ref[0], GRAD_TOL, "dx")
    assert_close_scaled(got[1].numpy(), ref[1], GRAD_TOL, "dtxt")
    for name, g, r in zip(NAMES, got[2:], _flax_block_grads(ref[2:])):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, name)


# ------------------------------------------------------------ K4, K4b
@functools.lru_cache(maxsize=None)
def _pallas_ffn(d):
    """The inputs (x, w1, b1, gamma, beta, w2, b2, cotangent; flax layout)
    and ``fused_ffn``'s output and VJP at width d over 2 x L rows, F 2048,
    dropout off, jitted once."""
    m = 2 * L
    x = _rand(d, m, d)
    w1, b1 = _rand(d + 1, d, F, scale=0.08 * (128 / d) ** 0.5), _rand(d + 2, F, scale=0.1)
    g, be = 1 + _rand(d + 3, F, scale=0.1), _rand(d + 4, F, scale=0.1)
    w2, b2 = _rand(d + 5, F, d, scale=0.06 * (256 / F) ** 0.5), _rand(d + 6, d, scale=0.1)
    cot = _rand(d + 9, m, d)
    args = (x, w1, b1, g, be, w2, b2)

    @jax.jit
    def run(args, cot):
        y, vjp = jax.vjp(lambda *a: jax_ffn(*a, SEED0, 0.1, False, 1e-5, True), *args)
        return y, vjp(cot)

    y, grads = run(tuple(map(jnp.asarray, args)), jnp.asarray(cot))
    return args + (cot,), np.asarray(y), [np.asarray(t) for t in grads]


def _torch_ffn_args(args, grad=False):
    x, w1, b1, g, be, w2, b2 = args
    return [T(np.ascontiguousarray(a)).requires_grad_(grad)
            for a in (x, w1.T, b1, g, be, w2.T, b2)]


@pytest.mark.parametrize("d", [d for d, _ in WIDTHS])
def test_ffn_matches_pallas_kernel_at_width(d):
    (*args, _), ref, _ = _pallas_ffn(d)
    got = FF.fused_ffn(*_torch_ffn_args(args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("d", [d for d, _ in WIDTHS])
def test_ffn_grads_match_pallas_vjp_at_width(d):
    (*args, cot), _, ref = _pallas_ffn(d)
    leaves = _torch_ffn_args(args, grad=True)
    got = torch.autograd.grad(FF.fused_ffn(*leaves), leaves, T(cot))
    names = ("x", "w1", "b1", "gamma", "beta", "w2", "b2")
    for i, (name, gt, r) in enumerate(zip(names, got, ref)):
        assert_close_scaled(gt.numpy(), r.T if i in (1, 5) else r, GRAD_TOL, name)


# ------------------------------------------------------ decoder stack
def test_decoder_stack_matches_flax_at_1024():
    """CROG's decoder at RN50x64's width (1024, 8 heads of 128, dim_ffn
    2048, one layer) over 6 x 6 = 36 tokens, 9 of 17 text tokens real: the
    port's TransformerDecoder against crog_tpu's with the same randomized
    weights, as tests/test_torch_long_lengths.py holds it at 512."""
    from crog_tpu.models.layers import TransformerDecoder as JaxDecoder
    from crog_tpu_torch.models import convert
    from crog_tpu_torch.models.layers import TransformerDecoder
    from tests.torch_port_helpers import randomize

    width, heads, ffn, side = 1024, 8, F, 6
    fq = _rand(11, 1, side, side, width, scale=0.5)
    word = _rand(12, 1, TXT, width, scale=0.5)
    pad = np.arange(TXT)[None] >= 9
    jd = JaxDecoder(1, width, heads, ffn, 0.1)
    v = jax.jit(jd.init, static_argnums=4)(jax.random.PRNGKey(0), jnp.asarray(fq),
                                           jnp.asarray(word), jnp.asarray(pad), False)
    params = randomize(jax.tree_util.tree_map(np.asarray, v))["params"]
    ref = np.asarray(jax.jit(jd.apply, static_argnums=4)(
        {"params": params}, jnp.asarray(fq), jnp.asarray(word), jnp.asarray(pad), False))
    td = TransformerDecoder(1, width, heads, ffn, 0.1).eval()
    assert td.layers[0].fuse and DB.kernel_supported(width, heads)
    carry = convert._Builder(params, {})  # the decoder's part of state_dict_from_flax
    convert._decoder(carry, "")
    convert.load_numpy_state_dict(td, carry.sd)
    with torch.no_grad():
        got = td(T(fq), T(word), T(pad)).numpy()
    assert got.shape == ref.shape == (1, side, side, width)
    assert_close_scaled(got, ref, 2e-5)


# ------------------------------------------------- CROG at RN50x64's widths
RES = 128
RN50X64 = dict(  # CLIP RN50x64's widths under CROG, depth cut (module docstring)
    word_len=TXT, word_dim=1024, vis_dim=1024, fpn_in=(1024, 2048, 1024),
    fpn_out=(512, 1024, 2048), num_layers=1, num_head=8, dim_ffn=F, dropout=0.1,
    input_resolution=RES, clip_resolution=RES, vision_layers=(1, 1, 1, 1),
    vision_width=128, transformer_width=1024, transformer_layers=1,
)


def test_crog_at_rn50x64_widths_matches_crog_tpu():
    """The port's CROG at RN50x64's widths (seeded ``random_init_``)
    against crog_tpu's CROG holding the same weights, carried by
    ``convert_crog_state_dict``, on two samples in eval: the five logit
    maps to 2e-5 of their largest magnitude.  Its decoder runs the block and
    FFN wrappers (``fuse``) at D 1024 over 8 heads of 128."""
    from crog_tpu.models.convert import convert_crog_state_dict
    from crog_tpu.models.crog import CROG as JaxCROG
    from crog_tpu_torch.models.crog import CROG, random_init_
    from tests.torch_port_helpers import SOT, EOT

    tm = CROG(**RN50X64).eval()
    random_init_(tm, torch.Generator().manual_seed(64))
    assert all(layer.fuse for layer in tm.decoder.layers)
    assert DB.kernel_supported(1024, 8) and tm.decoder.layers[0].nhead == 8
    rng = np.random.RandomState(42)
    img = (rng.randn(2, RES, RES, 3) * 0.4).astype(np.float32)
    word = np.zeros((2, TXT), np.int32)
    for i, n in enumerate((4, 11)):
        word[i, 0], word[i, 1:n + 1], word[i, n + 1] = SOT, rng.randint(1, 1000, n), EOT
    with torch.no_grad():
        got = tm(T(img), T(word)).numpy()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, stats = convert_crog_state_dict(sd)
    del tm, sd
    jm = JaxCROG(dtype=jnp.float32, **RN50X64)
    ref = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(img), jnp.asarray(word)))
    assert got.shape == ref.shape == (2, RES // 4, RES // 4, 5)
    assert np.isfinite(got).all()
    assert_close_scaled(got, ref, 2e-5)


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("d", DB.KERNEL_D)
def test_wrappers_take_each_width_at_each_head_count_to_the_device_check(d):
    """D 256, 512, 768 and 1024 over every head count whose head dim a
    kernel build takes (8 to 512): the block and FFN checks stop only at
    the device (a CPU tensor reaches the CUDA-tensor check, which the
    wrappers never reach on the CPU, where the twins run); the decoder
    layer routes each width to the wrappers."""
    from crog_tpu_torch.models.layers import TransformerDecoderLayer

    counts = DB.head_counts(d)
    assert counts and all(d // h in DB.HEAD_DIMS for h in counts)
    for heads in counts:
        assert DB.kernel_supported(d, heads)
        with pytest.raises(ValueError, match="CUDA tensor"):
            DB._check_block_input(torch.zeros(1, 20, d, dtype=torch.bfloat16), heads)
    with pytest.raises(ValueError, match="CUDA tensor"):
        FF._check(torch.zeros(4, d, dtype=torch.bfloat16), torch.zeros(F, d))
    assert TransformerDecoderLayer(d, counts[-1], F, 0.1).fuse


@pytest.mark.parametrize("d,heads", [(640, 8), (384, 8), (640, 10), (128, 2), (1280, 8),
                                     (2048, 8)])
def test_widths_not_taken_raise_naming_the_widths(d, heads):
    """RN50x4's 640, and 384, 128, 1280 and 2048, are no width the kernels
    take: the block check refuses them before any launch, naming D 256,
    512, 768 or 1024; the FFN check alike.  No counter moves."""
    counters = [DB.self_block_fwd, DB.cross_block_fwd, DB.self_block_bwd, DB.cross_block_bwd,
                FF.ffn_fwd, FF.ffn_bwd]
    before = [(f.launches, f.launches_f32) for f in counters]
    assert not DB.kernel_supported(d, heads)
    with pytest.raises(ValueError, match=r"D 256, 512, 768 or 1024 \(a multiple of 256 up "
                                         r"to 1024\), got \(1, 20, " + str(d)):
        DB._check_block_input(torch.zeros(1, 20, d, dtype=torch.bfloat16), heads)
    with pytest.raises(ValueError, match=f"FFN kernels take D 256, 512, 768 or 1024 .* and "
                                         f"F=2048, got D={d}, F=2048"):
        FF._check(torch.zeros(4, d, dtype=torch.bfloat16), torch.zeros(F, d))
    assert [(f.launches, f.launches_f32) for f in counters] == before


@pytest.mark.parametrize("d,heads,counts", [
    (768, 8, "3, 6, 12, 24, 48 or 96 heads"), (1024, 3, "2, 4, 8, 16, 32, 64 or 128 heads"),
    (256, 64, "1, 2, 4, 8, 16 or 32 heads")])
def test_head_counts_not_taken_at_a_width_name_those_taken(d, heads, counts):
    """RN50x16's 768 over the configs' 8 heads (head dim 96) is refused
    naming the head counts that width takes; so are 3 heads at 1024 and 64
    (head dim 4) at 256."""
    with pytest.raises(ValueError, match=f"x \\[B, L, {d}\\] with {counts}"):
        DB._check_block_input(torch.zeros(1, 20, d, dtype=torch.bfloat16), heads)


@pytest.mark.parametrize("f", [1024, 512, 4096])
def test_ffn_hidden_widths_not_taken_raise(f):
    with pytest.raises(ValueError, match=f"and F=2048, got D=1024, F={f}"):
        FF._check(torch.zeros(4, 1024, dtype=torch.bfloat16), torch.zeros(f, 1024))


def test_widths_mirror_the_kernel_source():
    """ops/decoder_blocks.py's KERNEL_D is csrc/common.cuh's
    decoder_width_ok (whole 256-column tiles up to kDecoderDMax), and the
    out-projection's cluster and the GEMMs' column tiles are 256 wide."""
    src = (cuda_build.CSRC / "common.cuh").read_text()
    dmax = int(re.search(r"kDecoderDMax = (\d+);", src).group(1))
    assert "d >= 256 && d <= kDecoderDMax && d % 256 == 0" in src
    assert DB.KERNEL_D == tuple(range(256, dmax + 1, 256)) == (256, 512, 768, 1024)
    assert DB.PROJ_COLS == FF.OUT_COLS == 256
    assert [DB.out_cluster(d) for d in DB.KERNEL_D] == [1, 2, 3, 4]
    assert "crog_decoder_fwd_attrs" in cuda_build.SIGNATURES["decoder_blocks"]


@pytest.mark.parametrize("d", DB.KERNEL_D)
def test_ffn_db2_columns_cover_the_row_once(d):
    """K4b's db2 partials: CTA k of every cluster adds dy's columns
    [k D / 8, (k + 1) D / 8), whole 32-column chunks of its ring, and the
    eight together cover the D columns once."""
    cols = FF.bwd_db2_cols(d)
    assert len(cols) == FF.BWD_CLUSTER
    assert [c for c0, c1 in cols for c in range(c0, c1)] == list(range(d))
    assert all((c1 - c0) % 32 == 0 and c0 % 32 == 0 for c0, c1 in cols)


@pytest.mark.parametrize("d", DB.KERNEL_D)
@pytest.mark.parametrize("m,mt", [(16224, 408), (903, 51), (1, 1)])
def test_f32_block_workspaces_hold_every_product_at_width(d, m, mt):
    """K2b-f32's and K3b-f32's products at width d: every output is [rows,
    D] over its depth, the chunks cover the depth once, and the two
    workspaces (``f32_bwd_work``) hold the largest split product's partials
    and the largest B's planes; K2-f32's planes are 8 D^2 floats."""
    assert DB.f32_planes(d) == 8 * d * d
    for text in (None, mt):
        prods = DB.f32_bwd_products(m, text, d)
        part, planes = DB.f32_bwd_work(m, text, d)
        for _, (rows, cols), k, chunks in prods:
            assert cols == d
            assert [r for k0, k1 in chunks for r in range(k0, k1)] == list(range(k))
            if len(chunks) > 1:
                assert part >= len(chunks) * rows * cols
            assert planes >= 2 * d * k


@pytest.mark.parametrize("layers,scale", [((1, 1, 1, 1), 0.25), ((3, 4, 6, 3), 0.25),
                                          ((3, 4, 23, 3), 0.25 * (16 / 33) ** 0.5),
                                          ((3, 15, 36, 10), 0.125)])
def test_random_init_keeps_the_residual_stream_bounded_at_any_depth(layers, scale):
    """``random_init_`` scales the bottlenecks' last BN scales by a quarter
    up to RN50's 16 bottlenecks and by a quarter of sqrt(16 / blocks)
    beyond (an eighth at RN50x64's 64), every other draw as before: the
    same seed gives the same conv weights at any depth, and RN50's and the
    tiny towers' scales are unchanged."""
    from crog_tpu_torch.models.clip import ModifiedResNet
    from crog_tpu_torch.models.crog import bottleneck_scale, random_init_

    def seeded(layers):  # named as in CROG: backbone.visual.layer1.0.bn3.weight ...
        tower = ModifiedResNet(layers, output_dim=32, heads=2, input_resolution=64, width=8)
        random_init_(torch.nn.ModuleDict({"visual": tower}), torch.Generator().manual_seed(0))
        return tower

    tower, flat = seeded(layers), seeded((1, 1, 1, 1))
    assert bottleneck_scale(sum(layers)) == pytest.approx(scale, rel=1e-12)
    bn3 = torch.cat([p.detach() for n, p in tower.named_parameters()
                     if n.endswith(".bn3.weight") and n.startswith("layer")])
    assert len(bn3) == 4 * 8 * sum(n * 2**i for i, n in enumerate(layers))
    assert float(bn3.mean()) == pytest.approx(scale, rel=0.05)
    assert torch.equal(tower.conv1.weight, flat.conv1.weight)
    assert torch.equal(tower.layer1[0].conv1.weight, flat.layer1[0].conv1.weight)
