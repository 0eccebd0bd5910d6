"""Attention and the decoder blocks past 768 tokens, on the CPU: the port's
block twins against the JAX package's Pallas kernels in interpret mode
(which pad any length; K1's and K1b's 833-token cases are inputs of
tests/test_torch_kernels.py and tests/test_torch_kernels_bwd.py), the
fp32 backward's decomposition with its grouped dQ partials, the wrappers' length checks, and CROG's decoder stack over the
784 tokens of a 448^2 input against crog_tpu's.

CROG at ``input_size`` 640 attends over (640 / 16)^2 = 1600 decoder tokens;
833 = 13 * 64 + 1 leaves a ragged last key tile of one key and takes two
64-key blocks per dQ partial in the fp32 backward (13 blocks, 7 partials).

Tolerances as in the files they extend: 2e-5 absolute on the blocks' O(5)
outputs (tests/test_torch_kernels.py); gradients to 1e-4 of each one's largest magnitude
(tests/test_torch_kernels_bwd.py); the fp32 decomposition to a relative L2
error of 1e-5 (tests/test_torch_attention_f32.py); the decoder stack to
2e-5 of its largest output magnitude (tests/test_torch_modules.py).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.ops.pallas_attention import _fused_fwd, fused_self_attention
from crog_tpu.ops.pallas_decoder import _mha_bwd
from crog_tpu.ops.pallas_decoder import decoder_cross_block as jax_cross
from crog_tpu.ops.pallas_decoder import decoder_self_block as jax_self
from crog_tpu_torch.ops import attention as A
from crog_tpu_torch.ops import cuda_build
from crog_tpu_torch.ops import decoder_blocks as DB
from tests.torch_port_helpers import assert_close_scaled

T = torch.from_numpy
SEED0 = jnp.zeros((), jnp.int32)
HEADS, DH = 2, 64
D = HEADS * DH
LONG = 833
BLOCK_ATOL, GRAD_TOL, REL_L2 = 2e-5, 1e-4, 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _heads(x):
    """[B, L, H*64] -> the Pallas kernels' [B*H, L, 64]"""
    b, l, _ = x.shape
    return jnp.asarray(x.reshape(b, l, HEADS, DH).transpose(0, 2, 1, 3).reshape(b * HEADS, l, DH))


def _merge(x, b=1):
    """[B*H, L, 64] -> [B, L, H*64]"""
    x = np.asarray(x)
    return x.reshape(b, HEADS, x.shape[1], DH).transpose(0, 2, 1, 3).reshape(b, x.shape[1], -1)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ------------------------------------------------------------ K1, K1b
def test_fp32_backward_decomposition_matches_pallas_vjp_past_768():
    """K1b-f32's twin on the forward's logsumexp and the kernels'
    decomposition (13 key blocks in 7 dQ partials of two blocks, the last
    of one) against ``fused_self_attention``'s VJP."""
    q, k, v, do = (_rand(20 + s, 1, LONG, D) for s in range(4))
    assert A.f32_dq_parts(LONG) == (2, 7)
    _, vjp = jax.vjp(lambda *a: fused_self_attention(*a, DH**-0.5, True),
                     _heads(q), _heads(k), _heads(v))
    want = [_merge(g) for g in vjp(_heads(do))]
    _, res = _fused_fwd(_heads(q), _heads(k), _heads(v), DH**-0.5, True)
    o, lse = A.attention_plain(T(q), T(k), T(v), HEADS, with_lse=True)
    ref_lse = np.asarray(res[4])[:, :LONG, 0].reshape(1, HEADS, LONG)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=1e-6 * np.abs(ref_lse).max())
    twin = A.attention_bwd_plain(T(q), T(k), T(v), o, T(do), HEADS, lse)
    split = A.attention_bwd_f32_plain(T(q), T(k), T(v), T(do), HEADS, o=o, lse=lse)
    for name, g, s, w in zip(("dq", "dk", "dv"), twin, split, want):
        assert _rel_l2(g.numpy(), w) <= REL_L2, (name, "twin")
        assert _rel_l2(s.numpy(), w) <= REL_L2, (name, "decomposition")


@pytest.mark.parametrize("lq,lk", [(LONG, LONG), (40, 1600)])
def test_fp32_blocks_decomposition_matches_mha_bwd_past_768(lq, lk):
    """The blocks' decomposition (pre-pass statistics) with grouped dQ
    partials gives ``_mha_bwd`` at fp32, with a key mask that keeps a third
    of sample 0's keys: 833 keys (7 partials), and 1600 keys (25 blocks in
    9 partials of three, the 640^2 decoder's split) over 40 queries."""
    q, do = _rand(1, 2, lq, D), _rand(4, 2, lq, D)
    k, v = _rand(2, 2, lk, D), _rand(3, 2, lk, D)
    keep = np.ones((2, lk), bool)
    keep[0, lk // 3:] = False
    madd = np.where(keep, 0.0, A.NEG).astype(np.float32)
    split = A.attention_bwd_f32_plain(T(q), T(k), T(v), T(do), HEADS, T(madd))
    for b in range(2):
        want = _mha_bwd(*(jnp.asarray(a[b]) for a in (q, k, v, do)), HEADS,
                        jnp.asarray(madd[b][None]))
        for name, s, w in zip(("dq", "dk", "dv"), split, want):
            assert _rel_l2(s[b].numpy(), w) <= REL_L2, (name, b)


@pytest.mark.parametrize("lk,split", [
    (1, (1, 1)), (64, (1, 1)), (169, (1, 3)), (676, (1, 11)), (704, (1, 11)),
    (705, (2, 6)), (785, (2, 7)), (900, (2, 8)), (1000, (2, 8)), (1600, (3, 9)),
    (100_000, (143, 11))])
def test_fp32_dq_partials_stay_at_most_eleven(lk, split):
    """The fp32 backward's dQ workspace: one partial per 64-key block up to
    11 blocks (unchanged below 705 keys), then groups of consecutive blocks,
    so that its bytes grow linearly in Lq whatever Lk; every block belongs
    to exactly one group."""
    group, parts = A.f32_dq_parts(lk)
    assert (group, parts) == split
    blocks = -(-lk // 64)
    assert parts <= A.F32_MAX_DQ_PARTS and (parts - 1) * group < blocks <= parts * group


def test_fp32_dq_partials_mirror_the_kernel_source():
    """ops/attention.py's split is csrc/attention_bwd_f32.cuh's: the same
    cap and block size, and the C entry point that reports it is bound."""
    src = (cuda_build.CSRC / "attention_bwd_f32.cuh").read_text()
    assert int(re.search(r"kAbF32MaxParts = (\d+);", src).group(1)) == A.F32_MAX_DQ_PARTS
    assert int(re.search(r"kAbF32Keys = (\d+);", src).group(1)) == A.F32_KEY_BLOCK
    assert "crog_attention_f32_dq_parts" in cuda_build.SIGNATURES["attention_bwd_f32"]


# ----------------------------------------------------- K2, K3, K2b, K3b
def _block_weights(seed):
    r = np.random.RandomState(seed)
    ws = []
    for _ in range(4):
        ws += [r.randn(D, D).astype(np.float32) * 0.06, r.randn(D).astype(np.float32) * 0.06]
    aff = [1 + 0.1 * r.randn(D), 0.1 * r.randn(D), 1 + 0.1 * r.randn(D), 0.1 * r.randn(D)]
    return ws + [a.astype(np.float32) for a in aff]


def _torch_block_args(w, grad=False):
    """flax-layout (wq, bq, wk, bk, wv, bv, wo, bo, affines) -> the port's
    torch layout (in_w [3D, D], in_b, out_w, out_b, affines)."""
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


NAMES = ("in_w", "in_b", "out_w", "out_b", "g_pre", "b_pre", "g_post", "b_post")


def _acts(l=LONG, t=17, seed=1):
    x = _rand(seed, 1, l, D, scale=0.5)
    kv = _rand(seed + 1, 1, t, D, scale=0.5)
    pos = _rand(seed + 2, l, D, scale=0.3)
    kpos = _rand(seed + 3, t, D, scale=0.3)
    pad = np.arange(t)[None] >= 9  # 9 of the 17 text tokens are real
    return x, kv, pos, kpos, pad


def test_self_block_matches_pallas_kernel_past_768():
    x, _, pos, _, _ = _acts()
    w = _block_weights(0)
    ref = jax_self(jnp.asarray(x), jnp.asarray(pos), *map(jnp.asarray, w),
                   SEED0, HEADS, 0.1, False, True)
    got = DB.decoder_self_block(T(x), T(pos), *_torch_block_args(w), HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=BLOCK_ATOL)


def test_cross_block_matches_pallas_kernel_past_768():
    """1600 queries' worth of the cross block's shape at 833: 833 queries
    over 17 text keys, 8 of them padded."""
    x, kv, pos, kpos, pad = _acts()
    w = _block_weights(2)
    ref = jax_cross(jnp.asarray(x), jnp.asarray(kv), jnp.asarray(pos), jnp.asarray(kpos),
                    jnp.asarray(pad), *map(jnp.asarray, w), SEED0, HEADS, 0.1, False, True)
    got = DB.decoder_cross_block(T(x), T(kv), T(pos), T(kpos), T(pad),
                                 *_torch_block_args(w), HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=BLOCK_ATOL)


def test_self_block_grads_match_pallas_vjp_past_768():
    x, _, pos, _, _ = _acts(seed=3)
    w = _block_weights(4)
    cot = _rand(7, *x.shape)
    f = lambda x, *w: jnp.vdot(jax_self(x, jnp.asarray(pos), *w, SEED0, HEADS, 0.1, False,
                                        True), cot)
    ref = jax.grad(f, argnums=tuple(range(13)))(jnp.asarray(x), *map(jnp.asarray, w))
    xt, leaves = T(x).requires_grad_(), _torch_block_args(w, grad=True)
    y = DB.decoder_self_block(xt, T(pos), *leaves, HEADS)
    got = torch.autograd.grad(y, [xt] + leaves, T(cot))
    assert_close_scaled(got[0].numpy(), np.asarray(ref[0]), GRAD_TOL, "dx")
    for name, g, r in zip(NAMES, got[1:], _flax_block_grads(ref[1:])):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, name)


def test_cross_block_grads_match_pallas_vjp_past_768():
    x, kv, pos, kpos, pad = _acts(seed=5)
    w = _block_weights(6)
    cot = _rand(8, *x.shape)
    f = lambda x, kv, *w: jnp.vdot(jax_cross(x, kv, jnp.asarray(pos), jnp.asarray(kpos),
                                             jnp.asarray(pad), *w, SEED0, HEADS, 0.1,
                                             False, True), cot)
    ref = jax.grad(f, argnums=tuple(range(14)))(jnp.asarray(x), jnp.asarray(kv),
                                               *map(jnp.asarray, w))
    xt, kvt = T(x).requires_grad_(), T(kv).requires_grad_()
    leaves = _torch_block_args(w, grad=True)
    y = DB.decoder_cross_block(xt, kvt, T(pos), T(kpos), T(pad), *leaves, HEADS)
    got = torch.autograd.grad(y, [xt, kvt] + leaves, T(cot))
    assert_close_scaled(got[0].numpy(), np.asarray(ref[0]), GRAD_TOL, "dx")
    assert_close_scaled(got[1].numpy(), np.asarray(ref[1]), GRAD_TOL, "dtxt")
    for name, g, r in zip(NAMES, got[2:], _flax_block_grads(ref[2:])):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, name)


@pytest.mark.parametrize("l", [769, 1600])
def test_block_wrappers_take_long_inputs_to_the_device_check(l):
    """Past the old 768-token cap the blocks' CUDA checks stop only at the
    device: a CPU tensor of 769 or 1600 tokens reaches the CUDA-tensor
    check (which the wrappers never reach on the CPU, where the twins
    run), and no token count but 0 is refused."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        DB._check_block_input(torch.zeros(1, l, 512, dtype=torch.bfloat16), 8)
    A._check_bwd_width(torch.zeros(1, l, 512), 8)
    assert A.fwd_path(l) == "two_pass" and A.bwd_path(l) == "rows_cols"


# ------------------------------------------------------ decoder stack
LONG_RES = 448  # CROG's input_size: (448 / 16)^2 = 784 decoder tokens


def test_decoder_stack_matches_flax_at_448():
    """CROG's decoder at the TINY widths of the model tests (512 wide, 8
    heads of 64, dim_ffn 512, one layer) over the 28 x 28 = 784 tokens a
    448^2 input gives it, 9 of 17 text tokens real: the port's
    TransformerDecoder against crog_tpu's with the same randomized weights
    (the whole tiny CROG at 448^2 takes ~40 s of JAX on the CPU; its other
    modules do not read the token count)."""
    from crog_tpu.models.layers import TransformerDecoder as JaxDecoder
    from crog_tpu_torch.models import convert
    from crog_tpu_torch.models.layers import TransformerDecoder
    from tests.torch_port_helpers import TINY, randomize

    width, heads, ffn = TINY["vis_dim"], TINY["num_head"], TINY["dim_ffn"]
    side = LONG_RES // 16
    fq = _rand(11, 1, side, side, width, scale=0.5)
    word = _rand(12, 1, TINY["word_len"], width, scale=0.5)
    pad = np.arange(TINY["word_len"])[None] >= 9
    jd = JaxDecoder(TINY["num_layers"], width, heads, ffn, TINY["dropout"])
    v = jd.init(jax.random.PRNGKey(0), jnp.asarray(fq), jnp.asarray(word), jnp.asarray(pad),
                False)
    params = randomize(jax.tree_util.tree_map(np.asarray, v))["params"]
    ref = np.asarray(jd.apply({"params": params}, jnp.asarray(fq), jnp.asarray(word),
                              jnp.asarray(pad), False))
    td = TransformerDecoder(TINY["num_layers"], width, heads, ffn, TINY["dropout"]).eval()
    carry = convert._Builder(params, {})  # the decoder's part of state_dict_from_flax
    convert._decoder(carry, "")
    convert.load_numpy_state_dict(td, carry.sd)
    with torch.no_grad():
        got = td(T(fq), T(word), T(pad)).numpy()
    assert got.shape == ref.shape == (1, side, side, width)
    assert_close_scaled(got, ref, 2e-5)
