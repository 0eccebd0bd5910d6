"""The backward halves of the port's K1-K4 (K1b-K4b) against ``jax.grad``
through the JAX package's Pallas custom VJPs in interpret mode, on the CPU,
in fp32 with dropout off; and the counter-based dropout mask the port's
kernels and twins share.

On a CPU tensor each autograd function runs its plain PyTorch twin in both
directions, so these tests pin the twins' arithmetic to the Pallas kernels';
tests/test_torch_cuda_kernels.py holds the CUDA kernels against the same
twins on a card.

Tolerances (fp32): both sides compute the same sums in another order;
gradients agree to 1e-4 of the largest magnitude of each gradient (a few
float32 ulps accumulated over sums of up to a few hundred products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.ops.pallas_attention import fused_self_attention
from crog_tpu.ops.pallas_decoder import decoder_cross_block as jax_cross
from crog_tpu.ops.pallas_decoder import decoder_self_block as jax_self
from crog_tpu.ops.pallas_ffn import fused_ffn as jax_ffn
from crog_tpu_torch.ops import attention as A
from crog_tpu_torch.ops import decoder_blocks as DB
from crog_tpu_torch.ops import dropout as DR
from crog_tpu_torch.ops import ffn as FF
from tests.torch_port_helpers import assert_close_scaled

SEED0 = jnp.zeros((), jnp.int32)
TOL = 1e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def _torch_grads(out, cot, leaves):
    return torch.autograd.grad(out, leaves, torch.from_numpy(cot))


# ------------------------------------------------------------------ K1b
@pytest.mark.parametrize("l", [64, 169, 833])  # 833: past the old 768-key cap
def test_attention_grads_match_pallas_vjp(l):
    bh, dh = 6, 64
    q, k, v = (_rand(s, bh, l, dh) for s in (1, 2, 3))
    cot = _rand(4, bh, l, dh)
    f = lambda q, k, v: jnp.vdot(fused_self_attention(q, k, v, dh**-0.5, True), cot)
    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_leaf(t) for t in (q, k, v)]
    got = _torch_grads(A.FusedAttention.apply(*leaves, 1), cot, leaves)
    for name, g, r in zip("qkv", got, ref):
        assert_close_scaled(g.numpy(), np.asarray(r), TOL, f"d{name}")


# -------------------------------------------------------------- K2b, K3b
D, NH = 128, 4


def _block_weights(seed):
    r = np.random.RandomState(seed)
    ws = []
    for _ in range(4):
        ws += [r.randn(D, D).astype(np.float32) * 0.06, r.randn(D).astype(np.float32) * 0.06]
    aff = [1 + 0.1 * r.randn(D), 0.1 * r.randn(D), 1 + 0.1 * r.randn(D), 0.1 * r.randn(D)]
    return ws + [a.astype(np.float32) for a in aff]


def _torch_block_leaves(w):
    """flax-layout (wq, bq, wk, bk, wv, bv, wo, bo, affines) -> the port's
    torch-layout leaves (in_w [3D, D], in_b, out_w, out_b, affines)."""
    wq, bq, wk, bk, wv, bv, wo, bo, g1, be1, g2, be2 = w
    in_w = np.concatenate([wq.T, wk.T, wv.T], 0)
    in_b = np.concatenate([bq, bk, bv])
    return [_leaf(a) for a in (in_w, in_b, wo.T, bo, g1, be1, g2, be2)]


def _flax_block_grads(g):
    """jax grads of (wq, bq, ..., affines) -> the port's layout."""
    g = [np.asarray(t) for t in g]
    wq, bq, wk, bk, wv, bv, wo, bo, *aff = g
    return [np.concatenate([wq.T, wk.T, wv.T], 0), np.concatenate([bq, bk, bv]),
            wo.T, bo, *aff]


NAMES = ("in_w", "in_b", "out_w", "out_b", "g_pre", "b_pre", "g_post", "b_post")


def _acts(l, t=17, seed=1):
    x = _rand(seed, 2, l, D, scale=0.5)
    kv = _rand(seed + 1, 2, t, D, scale=0.5)
    pos = _rand(seed + 2, l, D, scale=0.3)
    kpos = _rand(seed + 3, t, D, scale=0.3)
    pad = np.random.RandomState(seed + 4).rand(2, t) > 0.7
    return x, kv, pos, kpos, pad


def test_self_block_grads_match_pallas_vjp():
    """L=20 leaves a padded tail in the Pallas kernel's 16-row padding."""
    x, _, pos, _, _ = _acts(20)
    w = _block_weights(0)
    cot = _rand(7, *x.shape)
    f = lambda x, *w: jnp.vdot(jax_self(x, jnp.asarray(pos), *w, SEED0, NH, 0.1, False,
                                        True), cot)
    ref = jax.grad(f, argnums=tuple(range(13)))(jnp.asarray(x), *map(jnp.asarray, w))
    xt, leaves = _leaf(x), _torch_block_leaves(w)
    y = DB.decoder_self_block(xt, torch.from_numpy(pos), *leaves, NH)
    got = _torch_grads(y, cot, [xt] + leaves)
    assert_close_scaled(got[0].numpy(), np.asarray(ref[0]), TOL, "dx")
    for name, g, r in zip(NAMES, got[1:], _flax_block_grads(ref[1:])):
        assert_close_scaled(g.numpy(), r, TOL, name)


@pytest.mark.parametrize("mask", [False, True])
def test_cross_block_grads_match_pallas_vjp(mask):
    x, kv, pos, kpos, pad = _acts(20)
    w = _block_weights(2)
    cot = _rand(8, *x.shape)
    pm = jnp.asarray(pad) if mask else None
    f = lambda x, kv, *w: jnp.vdot(jax_cross(x, kv, jnp.asarray(pos), jnp.asarray(kpos),
                                             pm, *w, SEED0, NH, 0.1, False, True), cot)
    ref = jax.grad(f, argnums=tuple(range(14)))(jnp.asarray(x), jnp.asarray(kv),
                                               *map(jnp.asarray, w))
    xt, kvt, leaves = _leaf(x), _leaf(kv), _torch_block_leaves(w)
    y = DB.decoder_cross_block(xt, kvt, torch.from_numpy(pos), torch.from_numpy(kpos),
                               torch.from_numpy(pad) if mask else None, *leaves, NH)
    got = _torch_grads(y, cot, [xt, kvt] + leaves)
    assert_close_scaled(got[0].numpy(), np.asarray(ref[0]), TOL, "dx")
    assert_close_scaled(got[1].numpy(), np.asarray(ref[1]), TOL, "dtxt")
    for name, g, r in zip(NAMES, got[2:], _flax_block_grads(ref[2:])):
        assert_close_scaled(g.numpy(), r, TOL, name)


# ------------------------------------------------------------------ K4b
def test_ffn_grads_match_pallas_vjp():
    """M=300 is not a multiple of the Pallas kernel's 256-row tiles (nor of
    the CUDA kernel's 32)."""
    m, d, f = 300, 128, 256
    x = _rand(0, m, d)
    w1, b1 = _rand(1, d, f, scale=0.08), _rand(2, f, scale=0.1)
    g, be = 1 + _rand(3, f, scale=0.1), _rand(4, f, scale=0.1)
    w2, b2 = _rand(5, f, d, scale=0.06), _rand(6, d, scale=0.1)
    cot = _rand(9, m, d)
    fj = lambda *a: jnp.vdot(jax_ffn(*a, SEED0, 0.1, False, 1e-5, True), cot)
    ref = jax.grad(fj, argnums=tuple(range(7)))(*map(jnp.asarray, (x, w1, b1, g, be, w2, b2)))
    leaves = [_leaf(t) for t in (x, w1.T, b1, g, be, w2.T, b2)]
    got = _torch_grads(FF.fused_ffn(*leaves), cot, leaves)
    names = ("x", "w1", "b1", "gamma", "beta", "w2", "b2")
    for i, (name, gt, r) in enumerate(zip(names, got, ref)):
        r = np.asarray(r)
        assert_close_scaled(gt.numpy(), r.T if i in (1, 5) else r, TOL, name)


@pytest.mark.parametrize("bf16_casts", [False, True])
def test_attention_bwd_on_cpu_is_its_twin(bf16_casts):
    """On a CPU tensor K1b's wrapper runs K1b's twin, or with ``bf16_casts``
    the decoder blocks' twin; the two differ in bf16."""
    q, k, v, do = (torch.from_numpy(_rand(s, 2, 64, 128)).bfloat16() for s in range(4))
    o = A.attention_plain(q, k, v, 2)
    got = A.attention_bwd(q, k, v, o, do, 2, bf16_casts=bf16_casts)
    k1b = A.attention_bwd_plain(q, k, v, o, do, 2)
    dec = A.mha_bwd_plain(q, k, v, do, 2)
    want, other = (dec, k1b) if bf16_casts else (k1b, dec)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not all(torch.equal(g, w) for g, w in zip(got, other))


@pytest.mark.parametrize("lq,lk,mask", [(40, 17, "ragged"), (33, 70, None), (20, 9, "all")])
def test_attention_bwd_with_a_key_mask_matches_pallas_decoder(lq, lk, mask):
    """The wrapper of the two-kernel path with the decoder blocks' cast
    points, a key mask and Lk != Lq (K3b's attention step) runs on a CPU
    tensor the twin that the card tests hold the kernels to; in fp32 it
    matches the Pallas decoder's ``_mha_bwd`` sample by sample, also where
    every key of a sample is masked."""
    from crog_tpu.ops.pallas_decoder import _mha_bwd

    q, do = _rand(1, 2, lq, 128), _rand(4, 2, lq, 128)
    k, v = _rand(2, 2, lk, 128), _rand(3, 2, lk, 128)
    keep = np.ones((2, lk), bool)
    if mask == "ragged":
        keep[0, lk // 3:] = False
    elif mask == "all":
        keep[1] = False
    madd = np.where(keep, 0.0, A.NEG).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    got = A.attention_bwd(t(q), t(k), t(v), t(q), t(do), 2, bf16_casts=True,
                          mask_add=t(madd) if mask else None)
    for b in range(2):
        ref = _mha_bwd(*(jnp.asarray(a[b]) for a in (q, k, v, do)), 2,
                       jnp.asarray(madd[b][None] if mask else np.zeros((1, lk), np.float32)))
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert_close_scaled(g[b].numpy(), np.asarray(r), TOL, f"{name}[{b}]")


@pytest.mark.parametrize("l,bf16_casts,path", [
    (1, False, "head"), (169, False, "head"), (256, False, "head"), (257, False, "rows_cols"),
    (300, False, "rows_cols"), (768, False, "rows_cols"), (169, True, "rows_cols"),
    (1600, False, "rows_cols")])
def test_attention_bwd_path_switches_at_the_head_limit(l, bf16_casts, path):
    """K1b's one-CTA-per-head kernel takes heads up to HEAD_MAX_LEN tokens;
    longer heads, and the decoder blocks' cast points, take the two-kernel
    path."""
    assert A.HEAD_MAX_LEN == 256
    assert A.bwd_path(l, bf16_casts) == path


@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000, 16224])
def test_ffn_bwd_schedule_covers_every_row_once(m):
    """K4b's cluster tiles cover rows 0..m-1 once, in order, BWD_ROWS at a
    time; its CTAs' column slices cover the hidden once; and the split
    depends on m alone."""
    tiles, slices = FF.bwd_schedule(m)
    assert len(tiles) == -(-m // FF.BWD_ROWS)
    rows = [r for r0, r1 in tiles for r in range(r0, r1)]
    assert rows == list(range(m))
    assert all(0 < r1 - r0 <= FF.BWD_ROWS for r0, r1 in tiles)
    assert len(slices) == FF.BWD_CLUSTER
    assert [c for c0, c1 in slices for c in range(c0, c1)] == list(range(FF.KERNEL_F))
    assert FF.bwd_schedule(m) == (tiles, slices)


# --------------------------------------------------------------- dropout
def test_dropout_mask_is_deterministic_and_keyed():
    a = DR.dropout_keep(123, 0.1, 64, 512)
    assert torch.equal(a, DR.dropout_keep(123, 0.1, 64, 512))
    assert not torch.equal(a, DR.dropout_keep(124, 0.1, 64, 512))
    # the mask of an element depends on its global (row, column) only: a
    # smaller draw is the corner of a larger one
    assert torch.equal(a, DR.dropout_keep(123, 0.1, 96, 1024)[:64, :512])
    assert DR.dropout_keep(5, 0.0, 3, 4).all()


def test_dropout_keep_rate():
    """Over 2^20 draws the keep share is 0.9 within 5 binomial standard
    deviations (5 * sqrt(0.9 * 0.1 / 2^20) = 1.5e-3)."""
    keep = DR.dropout_keep(7, 0.1, 1024, 1024)
    share = keep.float().mean().item()
    assert abs(share - 0.9) <= 5 * (0.09 / 2**20) ** 0.5, share


def test_dropout_bits_match_a_reference_hash():
    """The int64 twin against the 32-bit mixer written with numpy uint32
    wrap-around arithmetic, the arithmetic of the CUDA kernels."""
    def mix(x):
        x = np.uint32(x)
        with np.errstate(over="ignore"):
            x = ((x >> np.uint32(16)) ^ x) * np.uint32(0x45D9F3B)
            x = ((x >> np.uint32(16)) ^ x) * np.uint32(0x45D9F3B)
        return (x >> np.uint32(16)) ^ x

    rows, cols, seed = 5, 7, 2**31 - 5
    r = np.arange(rows, dtype=np.uint32)[:, None] + np.uint32(16000)
    c = np.arange(cols, dtype=np.uint32)[None, :]
    want = mix(mix(mix(np.uint32(seed)) ^ r) ^ c)
    got = DR.dropout_bits(seed, 16000 + rows, cols)[16000:].numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _block_setup(seed=3):
    x, kv, pos, kpos, pad = _acts(20, seed=seed)
    return (_leaf(x), _leaf(kv), torch.from_numpy(pos), torch.from_numpy(kpos),
            torch.from_numpy(pad), _torch_block_leaves(_block_weights(seed)))


@pytest.mark.parametrize("block", ["self", "cross", "ffn"])
def test_backward_twins_regenerate_the_forward_mask(block):
    """With dropout on, each explicit backward twin regenerates the mask
    from the seed; its gradients equal autograd through the plain forward,
    which kept the forward's own mask.  The forward drops about 10% of the
    elements it should."""
    seed, rate = 99, 0.1
    x, kv, pos, kpos, pad, w = _block_setup()
    cot = torch.from_numpy(_rand(11, *x.shape))
    if block == "self":
        leaves = [x] + w
        fwd = lambda: DB.self_block_plain(x, pos, *w, NH, seed, rate)
        ours = lambda: DB.decoder_self_block(x, pos, *w, NH, seed, rate)
    elif block == "cross":
        leaves = [x, kv] + w
        fwd = lambda: DB.cross_block_plain(x, kv, pos, kpos, pad, *w, NH, seed, rate)
        ours = lambda: DB.decoder_cross_block(x, kv, pos, kpos, pad, *w, NH, seed, rate)
    else:
        xf = x.reshape(-1, D)
        w1, b1 = _leaf(_rand(1, 256, D, scale=0.08)), _leaf(_rand(2, 256, scale=0.1))
        g, be = _leaf(1 + _rand(3, 256, scale=0.1)), _leaf(_rand(4, 256, scale=0.1))
        w2, b2 = _leaf(_rand(5, D, 256, scale=0.06)), _leaf(_rand(6, D, scale=0.1))
        leaves = [x, w1, b1, g, be, w2, b2]
        cot = cot.reshape(-1, D)
        fwd = lambda: FF.ffn_plain(xf, w1, b1, g, be, w2, b2, seed, rate)
        ours = lambda: FF.fused_ffn(xf, w1, b1, g, be, w2, b2, seed, rate)
    y_plain = fwd()
    ref = torch.autograd.grad(y_plain, leaves, cot)
    y = ours()
    got = torch.autograd.grad(y, leaves, cot)
    torch.testing.assert_close(y, y_plain, rtol=0, atol=0)
    for i, (g_, r_) in enumerate(zip(got, ref)):
        assert_close_scaled(g_.numpy(), r_.numpy(), TOL, f"leaf {i}")
    if block != "ffn":
        dropped = (y == x).float().mean().item()  # residual only where dropped
        assert 0.05 < dropped < 0.15, dropped


def test_unsupported_widths_raise_before_any_launch():
    """The CUDA paths check widths first: D=640 (CLIP RN50x4's) is not a
    kernel shape, and the message names the widths taken; D=256 over 4
    heads of 64 is one since the kernels take D 256-1024, and stops only at
    the device check."""
    with pytest.raises(ValueError, match="D 256, 512, 768 or 1024"):
        DB._check_block_input(torch.zeros(2, 8, 640, dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DB._check_block_input(torch.zeros(2, 8, 256, dtype=torch.bfloat16), 4)
    with pytest.raises(ValueError, match="at least 1 token"):
        DB._check_block_input(torch.zeros(1, 0, 512, dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match="CUDA tensor"):  # 800 tokens: past the length check
        DB._check_block_input(torch.zeros(1, 800, 512, dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match="D 256, 512, 768 or 1024 .* and F=2048, got D=256, "
                                         "F=1024"):
        FF._check(torch.zeros(4, 256, dtype=torch.bfloat16), torch.zeros(1024, 256))
    with pytest.raises(ValueError, match="head dims 8, 16, 32, 64, 128, 256 or 512"):
        A._check_bwd_width(torch.zeros(2, 16, 96), 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DB._check_block_input(torch.zeros(2, 8, 512, dtype=torch.bfloat16), 8)
