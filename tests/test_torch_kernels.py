"""The port's K1-K4 (crog_tpu_torch.ops) against the JAX package's Pallas
kernels run in interpret mode, on the CPU, in fp32.

On a CPU tensor each wrapper runs its plain PyTorch twin, so these tests pin
the twin's arithmetic to the Pallas kernel's; tests/test_torch_cuda_kernels.py
holds the CUDA kernels against the same twins on a card.

Tolerances (fp32): both sides compute the same sums in a different order,
so they agree to a few float32 ulps of the largest value involved; 1e-5
absolute on O(1) outputs, 2e-5 on the blocks' O(5) outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crog_tpu.ops.attention import attention_core as jax_attention_core
from crog_tpu.ops.pallas_attention import fused_self_attention
from crog_tpu.ops.pallas_decoder import decoder_cross_block as jax_cross
from crog_tpu.ops.pallas_decoder import decoder_self_block as jax_self
from crog_tpu.ops.pallas_ffn import fused_ffn as jax_ffn
from crog_tpu_torch.ops import attention as A
from crog_tpu_torch.ops import decoder_blocks as DB
from crog_tpu_torch.ops import ffn as FF

T = torch.from_numpy
SEED0 = jnp.zeros((), jnp.int32)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("l", [16, 169, 833])  # 833: past the old 768-key cap
def test_attention_matches_pallas_kernel(l):
    bh, dh = 6, 64
    q, k, v = (_rand(s, bh, l, dh) for s in (1, 2, 3))
    ref = fused_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               dh**-0.5, True)
    got = A.fused_attention(T(q), T(k), T(v), num_heads=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("l", [16, 169])
def test_attention_core_matches_jax(l):
    """Multi-head layout [B, L, H*dh]; L=169 routes to the fused path."""
    b, heads, d = 2, 4, 128
    q, k, v = (_rand(s, b, l, d) for s in (4, 5, 6))
    ref = jax_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    got = A.attention_core(T(q), T(k), T(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("lk,path", [
    (1, "one_pass"), (17, "one_pass"), (64, "one_pass"), (169, "one_pass"), (192, "one_pass"),
    (193, "two_pass"), (676, "two_pass"), (768, "two_pass"), (769, "two_pass"),
    (1600, "two_pass")])
def test_attention_fwd_path_switches_at_the_one_pass_limit(lk, path):
    """The attention forward keeps a head's scores in registers in one pass
    up to ONE_PASS_MAX_KEYS keys (K1's 169, K3's 17); longer heads (K2's
    676, 1600 at 640^2) take the two-pass kernel, at any length: no cap
    below what crog_tpu's kernels take remains."""
    assert A.ONE_PASS_MAX_KEYS == 192 and not hasattr(A, "MAX_KEYS")
    assert A.fwd_path(lk) == path


@pytest.mark.parametrize("lk", [0, -1])
def test_attention_fwd_path_rejects_what_no_kernel_takes(lk):
    with pytest.raises(ValueError, match="at least 1 key"):
        A.fwd_path(lk)


def test_attention_core_masks_match_jax():
    """The text tower's causal mask and a key padding mask (plain path)."""
    b, l, heads, d = 2, 17, 8, 64
    q, k, v = (_rand(s, b, l, d) for s in (7, 8, 9))
    causal = np.triu(np.full((l, l), -np.inf, np.float32), 1)
    pad = np.zeros((b, l), bool)
    pad[0, 9:] = pad[1, 14:] = True
    ref = jax_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                             attn_mask=jnp.asarray(causal),
                             key_padding_mask=jnp.asarray(pad))
    got = A.attention_core(T(q), T(k), T(v), heads, attn_mask=T(causal),
                           key_padding_mask=T(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# -------------------------------------------------------------- K2, K3
D, NH = 128, 4


def _block_weights(seed):
    r = np.random.RandomState(seed)
    ws = []
    for _ in range(4):
        ws += [r.randn(D, D).astype(np.float32) * 0.06, r.randn(D).astype(np.float32) * 0.06]
    aff = [1 + 0.1 * r.randn(D), 0.1 * r.randn(D), 1 + 0.1 * r.randn(D), 0.1 * r.randn(D)]
    return ws + [a.astype(np.float32) for a in aff]


def _torch_block_args(w):
    """flax-layout (wq, bq, wk, bk, wv, bv, wo, bo, affines) -> the port's
    torch layout (in_w [3D, D], in_b, out_w, out_b, affines)."""
    wq, bq, wk, bk, wv, bv, wo, bo, g1, be1, g2, be2 = w
    in_w = np.concatenate([wq.T, wk.T, wv.T], 0)
    in_b = np.concatenate([bq, bk, bv])
    return [T(np.ascontiguousarray(a)) for a in (in_w, in_b, wo.T, bo, g1, be1, g2, be2)]


def _acts(l, t=17, seed=1):
    x = _rand(seed, 2, l, D, scale=0.5)
    kv = _rand(seed + 1, 2, t, D, scale=0.5)
    pos = _rand(seed + 2, l, D, scale=0.3)
    kpos = _rand(seed + 3, t, D, scale=0.3)
    pad = np.random.RandomState(seed + 4).rand(2, t) > 0.7
    return x, kv, pos, kpos, pad


@pytest.mark.parametrize("l", [20, 32])
def test_self_block_matches_pallas_kernel(l):
    x, _, pos, _, _ = _acts(l)
    w = _block_weights(0)
    ref = jax_self(jnp.asarray(x), jnp.asarray(pos), *map(jnp.asarray, w),
                   SEED0, NH, 0.1, False, True)
    got = DB.decoder_self_block(T(x), T(pos), *_torch_block_args(w), NH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mask", [False, True])
def test_cross_block_matches_pallas_kernel(mask):
    x, kv, pos, kpos, pad = _acts(20)
    w = _block_weights(2)
    ref = jax_cross(jnp.asarray(x), jnp.asarray(kv), jnp.asarray(pos),
                    jnp.asarray(kpos), jnp.asarray(pad) if mask else None,
                    *map(jnp.asarray, w), SEED0, NH, 0.1, False, True)
    got = DB.decoder_cross_block(T(x), T(kv), T(pos), T(kpos),
                                 T(pad) if mask else None,
                                 *_torch_block_args(w), NH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("m", [256, 300])
def test_ffn_matches_pallas_kernel(m):
    """M=300 leaves a padded tail in the Pallas kernel's 256-row tiles."""
    d, f = 128, 256
    x = _rand(0, m, d)
    w1, b1 = _rand(1, d, f, scale=0.08), _rand(2, f, scale=0.1)
    g, be = 1 + _rand(3, f, scale=0.1), _rand(4, f, scale=0.1)
    w2, b2 = _rand(5, f, d, scale=0.06), _rand(6, d, scale=0.1)
    ref = jax_ffn(*map(jnp.asarray, (x, w1, b1, g, be, w2, b2)), SEED0,
                  0.1, False, 1e-5, True)
    got = FF.fused_ffn(T(x), T(np.ascontiguousarray(w1.T)), T(b1), T(g), T(be),
                       T(np.ascontiguousarray(w2.T)), T(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("d", DB.KERNEL_D)
@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000, 16224])
def test_ffn_fwd_schedule_covers_every_row_once(m, d):
    """K4's cluster tiles cover rows 0..m-1 once, in order, BWD_ROWS at a
    time, as K4b's do (K4b recomputes the same hidden); its CTAs' column
    slices cover the hidden once; its y GEMM's column tiles cover the D
    output columns once, at each width the kernels take; and the split
    depends on m and D alone."""
    tiles, slices, out_cols = FF.fwd_schedule(m, d)
    assert (tiles, slices) == FF.bwd_schedule(m)
    assert len(tiles) == -(-m // FF.BWD_ROWS)
    assert [r for r0, r1 in tiles for r in range(r0, r1)] == list(range(m))
    assert all(0 < r1 - r0 <= FF.BWD_ROWS for r0, r1 in tiles)
    assert len(slices) == FF.BWD_CLUSTER
    assert [c for c0, c1 in slices for c in range(c0, c1)] == list(range(FF.KERNEL_F))
    assert [c for c0, c1 in out_cols for c in range(c0, c1)] == list(range(d))
    assert all(c1 - c0 == FF.OUT_COLS for c0, c1 in out_cols)
    assert FF.fwd_schedule(m, d) == (tiles, slices, out_cols)


@pytest.mark.parametrize("d", DB.KERNEL_D)
@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 128, 129, 1000, 16224])
def test_f32_gemm_schedule_covers_every_output_once(m, d):
    """K4-f32's and K4b-f32's wgmma GEMM: each product's output tiles cover
    its output once, row tiles outer and column tiles inner, F32_TILE
    square but the last rows; the hidden and its recompute share one
    schedule; dW1's and dW2's row chunks cover rows 0..m-1 once, in order,
    each a multiple of F32_SLICE rows but the last and at most
    F32_CHUNK_ROWS; and all of it depends on m and D alone, at each width
    D the kernels take."""
    sched = FF.f32_schedule(m, d)
    assert list(sched) == ["hidden", "y", "recompute", "dhn", "dx", "dw1", "dw2"]
    f = FF.KERNEL_F
    assert sched["hidden"] == sched["recompute"]
    for name, ((rows, cols), tiles, chunks) in sched.items():
        count = np.zeros((rows, cols), np.uint8)
        for (r0, r1), (c0, c1) in tiles:
            assert 0 < r1 - r0 <= FF.F32_TILE and c1 - c0 == FF.F32_TILE, name
            count[r0:r1, c0:c1] += 1
        assert (count == 1).all(), name
        assert tiles == sorted(tiles), name
        k = {"hidden": d, "recompute": d, "dhn": d, "y": f, "dx": f}.get(name, m)
        assert [r for r0, r1 in chunks for r in range(r0, r1)] == list(range(k)), name
    assert sched["dw1"][0] == sched["dw2"][0] == (f, d)  # dW2 formed as its transpose
    chunks = FF.f32_dw_chunks(m)
    assert sched["dw1"][2] == sched["dw2"][2] == chunks
    assert len(chunks) == -(-m // FF.F32_CHUNK_ROWS)
    assert all((r1 - r0) % FF.F32_SLICE == 0 for r0, r1 in chunks[:-1])
    assert all(0 < r1 - r0 <= FF.F32_CHUNK_ROWS for r0, r1 in chunks)
    assert FF.f32_schedule(m, d) == sched
    part, planes = FF.f32_bwd_work(m, d)
    assert part >= len(chunks) * f * d and planes >= max(6 * f * d, 2 * d * m)


def _covered_once(plan, segments):
    """Each product's [m, n] covered by its tiles exactly once."""
    for s, (m, w0, n) in enumerate(segments):
        count = np.zeros((m, n), np.uint8)
        for _, (r0, r1), (c0, c1) in (t for t in plan if t[0] == s):
            assert 0 < r1 - r0 <= DB.PROJ_ROWS and c1 - c0 == DB.PROJ_COLS
            count[r0:r1, c0 - w0:c1 - w0] += 1
        assert (count == 1).all(), s


@pytest.mark.parametrize("d", DB.KERNEL_D)
@pytest.mark.parametrize("m,mt", [(1, 1), (127, 9), (128, 17), (129, 51), (903, 51),
                                  (16224, 408)])
def test_proj_plan_covers_every_row_and_column_once(m, mt, d):
    """K2's and K3's projection launch (one CTA per plan entry, walked in
    the plan's order by csrc/decoder_blocks.cu): every row and column of
    each product is covered once; K2's column tiles below 2D read qin and
    write the packed qk, the rest read xl and write v; K3's q runs over the
    M image rows, its k and v over the MT text rows; the products' columns
    are in_w's 3D rows, each once; the order is product by product, row
    tiles outer; at each width D the kernels take."""
    for segments in (DB.self_proj_segments(m, d), DB.cross_proj_segments(m, mt, d)):
        plan = DB.proj_plan(segments)
        _covered_once(plan, segments)
        cols = sorted(c for _, w0, n in segments for c in range(w0, w0 + n))
        assert cols == list(range(3 * d))
        assert [t[0] for t in plan] == sorted(t[0] for t in plan)
        assert len(plan) == sum(-(-sm // DB.PROJ_ROWS) * (n // DB.PROJ_COLS)
                                for sm, _, n in segments)
    self_plan = DB.proj_plan(DB.self_proj_segments(m, d))
    assert all((s == 0) == (c0 < 2 * d) for s, _, (c0, _c1) in self_plan)
    assert [sm for sm, _, _ in DB.cross_proj_segments(m, mt, d)] == [m, mt, mt]


@pytest.mark.parametrize("d", DB.KERNEL_D)
@pytest.mark.parametrize("m", [1, 127, 128, 129, 903, 16224])
def test_out_schedule_covers_every_row_once_with_whole_rows(m, d):
    """The out-projection's cluster tiles cover rows 0..m-1 once, in order,
    PROJ_ROWS at a time, and the D / 256 CTAs of a cluster (2 at the
    configs' D 512, 1 to 4 at the widths the kernels take) cover the D
    columns once between them, so each row's LayerNorm statistics stay
    inside one cluster."""
    tiles, slices = DB.out_schedule(m, d)
    assert [r for r0, r1 in tiles for r in range(r0, r1)] == list(range(m))
    assert all(0 < r1 - r0 <= DB.PROJ_ROWS for r0, r1 in tiles)
    assert len(slices) == DB.out_cluster(d) == d // 256
    assert DB.out_cluster(512) == 2
    assert [c for c0, c1 in slices for c in range(c0, c1)] == list(range(d))


def test_wrappers_reject_what_the_kernels_do_not_take():
    """CUDA-side argument checks run before any launch."""
    x = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        A._check_rows(x, "q")


# -------------------------------------------------------------- resize
@pytest.mark.parametrize("fn,args", [
    ("resize_bicubic", ((13, 11), False)),   # the attention pool's pos-embed
    ("resize_bicubic", ((104, 96), True)),   # the eval upsample
    ("resize_nearest", ((20, 12),)),
    ("upsample2x_bilinear", ()),
])
def test_resize_matches_jax(fn, args):
    """The interpolation matrices and their application, NHWC, fp32."""
    import crog_tpu.ops.resize as jr
    import crog_tpu_torch.ops.resize as tr

    x = _rand(11, 2, 7, 6, 3)
    ref = getattr(jr, fn)(jnp.asarray(x), *args)
    got = getattr(tr, fn)(T(x), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
