"""Head dims other than 64 on the CPU: the decoder at d_model 512 with
``num_head`` 64, 32, 16, 4, 2 or 1 (head dims 8, 16, 32, 128, 256 and
512; the configs' 8 heads give 64).  The port's twins against the JAX
package's Pallas kernels in interpret mode (K1 and its VJP, the self and
cross blocks and their VJPs), the fp32 backward's decomposition against
``_mha_bwd`` and the Pallas VJP, CROG's decoder stack at ``num_head`` 16,
4, 2 and 1 against crog_tpu's with weights carried through the
conversion, and the wrappers' routing: which head dims the kernels take
(``head_tile``, ``head_dim``, ``kernel_supported``), which kernel a head
goes to (``fwd_path``, ``bwd_path``), and that a head dim no kernel takes
(128 heads of 4) is refused before any launch.

Inputs: B 1, at most 96 tokens, D 512, made from numpy seeds.  Tolerances
as in the files they extend: K1's output to 1e-5 absolute
(tests/test_torch_kernels.py), the blocks' O(5) outputs to 2e-5 absolute,
every gradient to 1e-4 of its largest magnitude
(tests/test_torch_kernels_bwd.py), the fp32 decomposition to a relative L2
error of 1e-5 (tests/test_torch_attention_f32.py), the decoder stack to
2e-5 of its largest output magnitude (tests/test_torch_modules.py).
"""

import functools

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
from crog_tpu_torch.ops import decoder_blocks as DB
from tests.torch_port_helpers import assert_close_scaled

T = torch.from_numpy
SEED0 = jnp.zeros((), jnp.int32)
D = 512
DIMS = (8, 16, 32, 128, 256, 512)  # head dims; 512 // dh heads
L, TXT = 80, 17  # tokens (80: a ragged 64-key tile), text tokens
ATOL, BLOCK_ATOL, GRAD_TOL, REL_L2 = 1e-5, 2e-5, 1e-4, 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _heads(x, dh):
    """[B, L, H*dh] -> the Pallas kernels' [B*H, L, dh]"""
    b, l, d = x.shape
    h = d // dh
    return jnp.asarray(x.reshape(b, l, h, dh).transpose(0, 2, 1, 3).reshape(b * h, l, dh))


def _merge(x, dh, b=1):
    """[B*H, L, dh] -> [B, L, H*dh]"""
    x = np.asarray(x)
    h = x.shape[0] // b
    return x.reshape(b, h, x.shape[1], dh).transpose(0, 2, 1, 3).reshape(b, x.shape[1], h * dh)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ------------------------------------------------------------ K1, K1b
# Each JAX reference is jitted once per head dim and shared by the tests
# that read it (interpret mode unrolls the kernels' per-head loops: at 64
# heads eager dispatch costs several times the compile)
@functools.lru_cache(maxsize=None)
def _pallas_attention(dh):
    """(o, dq, dk, dv, lse) of ``fused_self_attention`` over D / dh heads
    on seeded [1, L, D] inputs, in the port's [B, L, H*dh] layout."""
    q, k, v, cot = (_rand(10 + s, 1, L, D) for s in range(4))

    @jax.jit
    def run(q, k, v, cot):
        o, vjp = jax.vjp(lambda *a: fused_self_attention(*a, dh**-0.5, True), q, k, v)
        _, res = _fused_fwd(q, k, v, dh**-0.5, True)
        return (o, *vjp(cot), res[4])

    out = run(*(_heads(x, dh) for x in (q, k, v, cot)))
    lse = np.asarray(out[4])[:, :L, 0].reshape(1, D // dh, L)
    return (q, k, v, cot), [_merge(t, dh) for t in out[:4]] + [lse]


@pytest.mark.parametrize("dh", DIMS)
def test_attention_matches_pallas_kernel_at_head_dim(dh):
    """K1's twin over D / dh heads against ``fused_self_attention``."""
    (q, k, v, _), ref = _pallas_attention(dh)
    got = A.fused_attention(T(q), T(k), T(v), D // dh)
    np.testing.assert_allclose(got.numpy(), ref[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("dh", DIMS)
def test_attention_grads_match_pallas_vjp_at_head_dim(dh):
    """K1b's twin (through ``FusedAttention``) against the Pallas VJP."""
    (q, k, v, cot), ref = _pallas_attention(dh)
    leaves = [T(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(A.FusedAttention.apply(*leaves, D // dh), leaves, T(cot))
    for name, g, r in zip("qkv", got, ref[1:4]):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("dh", DIMS)
def test_fp32_backward_decomposition_matches_pallas_at_head_dim(dh):
    """The fp32 backward's decomposition, K1b-f32's way (the forward's
    logsumexp) against the Pallas VJP, and the blocks' way (pre-pass
    statistics, a key mask keeping a third of the keys) against
    ``_mha_bwd``, over 80 queries and 80 keys (two 64-key blocks)."""
    (q, k, v, do), ref = _pallas_attention(dh)
    heads = D // dh
    o, lse = A.attention_plain(T(q), T(k), T(v), heads, with_lse=True)
    np.testing.assert_allclose(lse.numpy(), ref[4], rtol=0, atol=1e-6 * np.abs(ref[4]).max())
    split = A.attention_bwd_f32_plain(T(q), T(k), T(v), T(do), heads, o=o, lse=lse)
    for name, s, w in zip(("dq", "dk", "dv"), split, ref[1:4]):
        assert _rel_l2(s.numpy(), w) <= REL_L2, (name, "k1b")
    madd = np.where(np.arange(L) < L // 3, 0.0, A.NEG).astype(np.float32)[None]
    split = A.attention_bwd_f32_plain(T(q), T(k), T(v), T(do), heads, T(madd))
    want = jax.jit(_mha_bwd, static_argnums=4)(*(jnp.asarray(a[0]) for a in (q, k, v, do)),
                                               heads, jnp.asarray(madd))
    for name, s, w in zip(("dq", "dk", "dv"), split, want):
        assert _rel_l2(s[0].numpy(), w) <= REL_L2, (name, "blocks")


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
    torch layout (in_w [3D, D], in_b, out_w, out_b, affines); head h of
    either is columns [h dh, (h + 1) dh) of the projections."""
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


@functools.lru_cache(maxsize=None)
def _pallas_block(kind, dh):
    """The inputs (x, txt, pos, tpos, pad, weights, cotangent) and the
    Pallas block's output and VJP (dx, [dtxt,] weight grads) at D / dh
    heads, in eval (``kind`` "self" or "cross"; 80 queries, 17 text keys
    of which 9 are real)."""
    seed = 1 if kind == "self" else 5
    x = _rand(seed, 1, L, D, scale=0.5)
    kv = _rand(seed + 1, 1, TXT, D, scale=0.5)
    pos = _rand(seed + 2, L, D, scale=0.3)
    kpos = _rand(seed + 3, TXT, D, scale=0.3)
    pad = np.arange(TXT)[None] >= 9
    w = _block_weights(seed + 4)
    cot = _rand(seed + 5, *x.shape)
    heads = D // dh
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


@pytest.mark.parametrize("dh", DIMS)
def test_self_block_matches_pallas_kernel_at_head_dim(dh):
    (x, _, pos, _, _, w, _), ref, _ = _pallas_block("self", dh)
    got = DB.decoder_self_block(T(x), T(pos), *_torch_block_args(w), D // dh)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("dh", DIMS)
def test_cross_block_matches_pallas_kernel_at_head_dim(dh):
    """80 queries over 17 text keys, 8 of them padded."""
    (x, kv, pos, kpos, pad, w, _), ref, _ = _pallas_block("cross", dh)
    got = DB.decoder_cross_block(T(x), T(kv), T(pos), T(kpos), T(pad),
                                 *_torch_block_args(w), D // dh)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("dh", DIMS)
def test_self_block_grads_match_pallas_vjp_at_head_dim(dh):
    (x, _, pos, _, _, w, cot), _, ref = _pallas_block("self", dh)
    xt, leaves = T(x).requires_grad_(), _torch_block_args(w, grad=True)
    y = DB.decoder_self_block(xt, T(pos), *leaves, D // dh)
    got = torch.autograd.grad(y, [xt] + leaves, T(cot))
    assert_close_scaled(got[0].numpy(), ref[0], GRAD_TOL, "dx")
    for name, g, r in zip(NAMES, got[1:], _flax_block_grads(ref[1:])):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, name)


@pytest.mark.parametrize("dh", DIMS)
def test_cross_block_grads_match_pallas_vjp_at_head_dim(dh):
    (x, kv, pos, kpos, pad, w, cot), _, ref = _pallas_block("cross", dh)
    xt, kvt = T(x).requires_grad_(), T(kv).requires_grad_()
    leaves = _torch_block_args(w, grad=True)
    y = DB.decoder_cross_block(xt, kvt, T(pos), T(kpos), T(pad), *leaves, D // dh)
    got = torch.autograd.grad(y, [xt, kvt] + leaves, T(cot))
    assert_close_scaled(got[0].numpy(), ref[0], GRAD_TOL, "dx")
    assert_close_scaled(got[1].numpy(), ref[1], GRAD_TOL, "dtxt")
    for name, g, r in zip(NAMES, got[2:], _flax_block_grads(ref[2:])):
        assert_close_scaled(g.numpy(), r, GRAD_TOL, name)


# ------------------------------------------------------ decoder stack
@pytest.mark.parametrize("num_head", [16, 4, 2, 1])
def test_decoder_stack_matches_flax_at_num_head(num_head):
    """CROG's decoder at the TINY widths of the model tests (512 wide,
    dim_ffn 512, one layer) with ``num_head`` 16 (head dim 32), 4 (128), 2
    (256) or 1 (512),
    over 9 x 9 = 81 tokens, 9 of 17 text tokens real: the port's
    TransformerDecoder against crog_tpu's with the same randomized weights,
    carried through the conversion (the in-projection's shapes do not
    depend on the head count; head h is columns [h dh, (h + 1) dh) in
    both)."""
    from crog_tpu.models.layers import TransformerDecoder as JaxDecoder
    from crog_tpu_torch.models import convert
    from crog_tpu_torch.models.layers import TransformerDecoder
    from tests.torch_port_helpers import TINY, randomize

    width, ffn, side = TINY["vis_dim"], TINY["dim_ffn"], 9
    fq = _rand(11, 1, side, side, width, scale=0.5)
    word = _rand(12, 1, TINY["word_len"], width, scale=0.5)
    pad = np.arange(TINY["word_len"])[None] >= 9
    jd = JaxDecoder(TINY["num_layers"], width, num_head, ffn, TINY["dropout"])
    v = jax.jit(jd.init, static_argnums=4)(jax.random.PRNGKey(0), jnp.asarray(fq),
                                           jnp.asarray(word), jnp.asarray(pad), False)
    params = randomize(jax.tree_util.tree_map(np.asarray, v))["params"]
    ref = np.asarray(jax.jit(jd.apply, static_argnums=4)(
        {"params": params}, jnp.asarray(fq), jnp.asarray(word), jnp.asarray(pad), False))
    td = TransformerDecoder(TINY["num_layers"], width, num_head, ffn, TINY["dropout"]).eval()
    assert td.layers[0].fuse and DB.kernel_supported(width, num_head)
    carry = convert._Builder(params, {})  # the decoder's part of state_dict_from_flax
    convert._decoder(carry, "")
    convert.load_numpy_state_dict(td, carry.sd)
    with torch.no_grad():
        got = td(T(fq), T(word), T(pad)).numpy()
    assert got.shape == ref.shape == (1, side, side, width)
    assert_close_scaled(got, ref, 2e-5)


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("dh,tile", [(8, 32), (16, 32), (32, 32), (64, 64), (128, 128),
                                     (256, 256), (512, 512), (4, 0), (24, 0), (96, 0)])
def test_head_tile_and_the_block_kernels_widths(dh, tile):
    """The kernel build a head dim runs in (dh 8 and 16 in the 32-wide
    build, their columns past dh zero-filled), and the block kernels' widths:
    D 512 over 512 / dh heads where a build takes dh."""
    assert A.head_tile(dh) == tile
    heads = D // dh
    assert A.head_dim(D, heads) == (dh if tile else 0)
    assert DB.kernel_supported(D, heads) == bool(tile)
    assert (dh in A.HEAD_DIMS) == bool(tile)


@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("l", [1, 17, 169, 256, 257, 1600])
def test_bwd_path_at_each_head_dim_and_length(dh, l):
    """K1b's one-CTA-per-head kernel takes heads of at most 256 tokens of
    head dim 64 (csrc/attention_bwd.cu crog_attention_bwd_head_takes); any
    other head dim goes to the rows / cols kernels at every length, and the
    blocks' cast points always do.  The forward holds a head's scores in
    registers up to 192 keys below head dim 256; the wide builds run two
    passes at every length."""
    head = dh == A.HEAD_KERNEL_DIM and l <= A.HEAD_MAX_LEN
    assert A.bwd_path(l, dh=dh) == ("head" if head else "rows_cols")
    assert A.bwd_path(l, True, dh) == "rows_cols"
    one = l <= A.ONE_PASS_MAX_KEYS and dh < A.WIDE_MIN_DIM
    assert A.fwd_path(l, dh) == ("one_pass" if one else "two_pass")


@pytest.mark.parametrize("heads", [64, 32, 16, 4, 2, 1])
def test_block_wrappers_take_every_head_count_to_the_device_check(heads):
    """Over 64, 32, 16, 4, 2 and 1 heads the blocks' CUDA checks stop only at the
    device: a CPU tensor reaches the CUDA-tensor check (which the wrappers
    never reach on the CPU, where the twins run), and the attention
    backward's width check passes."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        DB._check_block_input(torch.zeros(1, L, D, dtype=torch.bfloat16), heads)
    assert A._check_bwd_width(torch.zeros(1, L, D), heads) == D // heads


def test_two_heads_of_256_raise_before_any_launch():
    """The refusal that 2 heads of 256 met before the wide builds, now at a
    head count that no kernel build takes: 128 heads of 4 (a 4-column head
    breaks the 16-byte row loads every kernel makes) are refused by the
    block and attention wrappers' width checks, which come before the
    device check and before any launch: no counter moves.  2 heads of 256
    pass those checks (test_block_wrappers_take_every_head_count_to_the_
    device_check)."""
    counters = [DB.self_block_fwd, DB.cross_block_fwd, DB.self_block_bwd, DB.cross_block_bwd,
                A.fused_attention, A.attention_bwd]
    before = [(f.launches, f.launches_f32) for f in counters]
    x = torch.zeros(1, L, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1, 2, 4, 8, 16, 32 or 64 heads"):
        DB._check_block_input(x, 128)
    with pytest.raises(ValueError, match="head dims 8, 16, 32, 64, 128, 256 or 512"):
        A._check_bwd_width(x, 128)
    assert not DB.kernel_supported(D, 128) and A.head_dim(D, 128) == 0
    assert DB.kernel_supported(D, 2) and A.head_dim(D, 2) == 256
    assert [(f.launches, f.launches_f32) for f in counters] == before
