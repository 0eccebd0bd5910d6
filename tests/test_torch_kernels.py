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
@pytest.mark.parametrize("l", [16, 169])
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
