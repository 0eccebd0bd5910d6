"""The fp32 attention backward's arithmetic on the CPU: K1-f32's twin
logsumexp against the Pallas forward's saved ``lse``; K1b-f32's twin
(``attention_bwd_plain`` on that logsumexp) and the kernels' decomposition
(``attention_bwd_f32_plain``: the forward's statistics or a pre-pass over
64-key tiles with online rescaling, 64-key blocks over 32-query tiles, dQ
partials added in key-block order) against ``fused_self_attention``'s VJP
in interpret mode, and the blocks' decomposition against
``pallas_decoder._mha_bwd`` with a key mask and Lk != Lq.

All fp32: both sides compute the same sums in another order (the
decomposition also rescales its running sums), so each gradient is held
to a relative L2 error of 1e-5, chip_smoke.F32_BWD_REL_L2, and the
logsumexp to 1e-6 of its magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.ops.pallas_attention import _fused_fwd, fused_self_attention
from crog_tpu.ops.pallas_decoder import _mha_bwd
from crog_tpu_torch.ops import attention as A

REL_L2 = 1e-5
LSE_REL = 1e-6
HEADS = 2


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel_l2(got, ref, floor=1e-30):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), floor))


def _heads(x):
    """[B, L, H*64] -> the Pallas kernels' [B*H, L, 64]"""
    b, l, _ = x.shape
    return jnp.asarray(x.reshape(b, l, HEADS, 64).transpose(0, 2, 1, 3).reshape(b * HEADS, l, 64))


def _merge(x, b):
    """[B*H, L, 64] -> [B, L, H*64]"""
    x = np.asarray(x)
    return x.reshape(b, HEADS, x.shape[1], 64).transpose(0, 2, 1, 3).reshape(b, x.shape[1], -1)


def _self_inputs(l, b=1):
    return tuple(_rand(10 * l + i, b, l, HEADS * 64) for i in range(4))  # q, k, v, do


@pytest.mark.parametrize("l", [1, 17, 63, 64, 65, 169])
def test_k1b_f32_twins_match_the_pallas_vjp(l):
    """K1-f32's twin logsumexp is ``_fused_fwd``'s lse; K1b-f32's twin on
    it, and the kernels' decomposition, give ``fused_self_attention``'s
    VJP (``_bwd_kernel``, interpret mode)."""
    q, k, v, do = _self_inputs(l)
    scale = 64**-0.5
    _, res = _fused_fwd(_heads(q), _heads(k), _heads(v), scale, True)
    out, vjp = jax.vjp(lambda *a: fused_self_attention(*a, scale, True),
                       _heads(q), _heads(k), _heads(v))
    want = [_merge(g, 1) for g in vjp(_heads(do))]
    t = torch.from_numpy
    o, lse = A.attention_plain(t(q), t(k), t(v), HEADS, with_lse=True)
    assert lse.shape == (1, HEADS, l)
    ref_lse = np.asarray(res[4])[:, :l, 0].reshape(1, HEADS, l)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=LSE_REL * np.abs(ref_lse).max())
    assert _rel_l2(o.numpy(), _merge(out, 1)) <= REL_L2
    twin = A.attention_bwd_plain(t(q), t(k), t(v), o, t(do), HEADS, lse)
    split = A.attention_bwd_f32_plain(t(q), t(k), t(v), t(do), HEADS, o=o, lse=lse)
    # over a single key p = 1 and dS = p (dP - delta) is 0 up to rounding:
    # dq and dk are held against dv's norm where theirs is smaller
    floor = np.linalg.norm(want[2])
    for name, g, s, w in zip(("dq", "dk", "dv"), twin, split, want):
        for label, x in (("twin", g), ("decomposition", s)):
            rel = _rel_l2(x.numpy(), w, floor)
            assert rel <= REL_L2, (name, label, rel)


@pytest.mark.parametrize("lq,lk,masked", [(17, 17, False), (65, 169, True), (169, 63, True),
                                          (63, 64, False), (64, 1, False)])
def test_blocks_decomposition_matches_mha_bwd(lq, lk, masked):
    """The blocks' decomposition (pre-pass statistics, delta = sum(p dp))
    gives ``_mha_bwd`` at fp32 (where its casts do nothing) sample by
    sample, with a key mask (sample 0 keeps a third of its keys, sample 1
    none: its rows average over every key) and Lk != Lq either way; so
    does its twin ``mha_bwd_plain``."""
    q, do = _rand(1, 2, lq, HEADS * 64), _rand(4, 2, lq, HEADS * 64)
    k, v = _rand(2, 2, lk, HEADS * 64), _rand(3, 2, lk, HEADS * 64)
    keep = np.ones((2, lk), bool)
    if masked:
        keep[0, max(1, lk // 3):] = False
        keep[1] = False
    madd = np.where(keep, 0.0, A.NEG).astype(np.float32)
    t = torch.from_numpy
    split = A.attention_bwd_f32_plain(t(q), t(k), t(v), t(do), HEADS, t(madd))
    twin = A.mha_bwd_plain(t(q), t(k), t(v), t(do), HEADS, t(madd))
    for b in range(2):
        want = _mha_bwd(*(jnp.asarray(a[b]) for a in (q, k, v, do)), HEADS,
                        jnp.asarray(madd[b][None]))
        for name, s, g, w in zip(("dq", "dk", "dv"), split, twin, want):
            assert _rel_l2(s[b].numpy(), w) <= REL_L2, (name, b, _rel_l2(s[b].numpy(), w))
            assert _rel_l2(g[b].numpy(), w) <= REL_L2, (name, b, "twin")


def test_fused_attention_saves_the_logsumexp_at_fp32_on_the_cpu():
    """FusedAttention at fp32 on CPU tensors: the forward is the twin with
    its logsumexp, the backward K1b-f32's twin on it (attention_bwd with
    ``lse``); at bf16 the backward recomputes the statistics (no lse)."""
    q, k, v, do = (torch.from_numpy(a) for a in _self_inputs(70, b=2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    A.FusedAttention.apply(*leaves, HEADS).backward(do)
    o, lse = A.attention_plain(q, k, v, HEADS, with_lse=True)
    want = A.attention_bwd(q, k, v, o, do, HEADS, lse=lse)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))
    assert all(torch.equal(g, w) for g, w in
               zip(A.attention_bwd_plain(q, k, v, o, do, HEADS, lse), want))
    bf = [x.bfloat16().requires_grad_() for x in (q, k, v)]
    A.FusedAttention.apply(*bf, HEADS).backward(do.bfloat16())
    ob = A.attention_plain(*(x.detach() for x in bf), HEADS)
    want_bf = A.attention_bwd_plain(*(x.detach() for x in bf), ob, do.bfloat16(), HEADS)
    assert all(torch.equal(x.grad, w) for x, w in zip(bf, want_bf))


def test_k1b_f32_twin_with_lse_is_the_softmax_twin_up_to_rounding():
    """exp(s - lse) is softmax(s): K1b-f32's twin on the forward's
    logsumexp and the recomputing twin agree to rounding, with a key mask
    and Lk != Lq too."""
    q, do = (torch.from_numpy(_rand(s, 2, 40, 128)) for s in (1, 4))
    k, v = (torch.from_numpy(_rand(s, 2, 90, 128)) for s in (2, 3))
    mask = torch.where(torch.arange(90)[None] >= torch.tensor([[30], [90]]), A.NEG, 0.0)
    o, lse = A.attention_plain(q, k, v, HEADS, mask, with_lse=True)
    with_lse = A.attention_bwd_plain(q, k, v, o, do, HEADS, lse, mask)
    recomputed = A.attention_bwd_plain(q, k, v, o, do, HEADS, None, mask)
    for g, w in zip(with_lse, recomputed):
        assert _rel_l2(g.numpy(), w.numpy()) <= REL_L2
