"""The port's CUDA kernels K1-K4, K1b-K4b, SSG's K5/K5b and the s2d stem's
K6/K6b against their plain PyTorch twins, on a card; and SSG's raw wire
unpack on the card against the CPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (the
kernels have no CPU mode).  This file imports neither jax nor crog_tpu, so
it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerances: kernel and twin are both bf16 with the same cast points, so
they differ only where a reordered f32 sum flips one bf16 rounding of an
intermediate: 3e-2 on attention outputs of magnitude ~1.5, 0.125 (four bf16
steps at magnitude 4-8) on the blocks' and FFN's outputs of magnitude ~6.
The forwards with dropout draw the same counter-based mask in kernel and
twin and are held alike.  The attention forward is held on both of its
paths (one pass up to 192 keys, two beyond), with q and k packed as the self
block passes them; the attention kernels and the blocks, bf16 and fp32, also
at head dims 8, 16, 32, 128, 256 and 512 (D 512 over 64, 32, 16, 4, 2 and 1
heads); K2-K4b and their fp32 builds also at D 256, 768 and 1024; K4's,
K4b's, K2b's and K3b's outputs, and K2's and K3's
in train mode with every saved intermediate, must also repeat with equal
bits.  The intermediates K2 and K3 save for their backward are held, like
backward outputs, to 2^-6 of each one's largest magnitude.  Backward
outputs are held to 2^-6 of each
gradient's largest magnitude (four bf16 steps: a flipped rounding of an
intermediate such as P, dS or dh feeds many outputs).  K1b rounds only its
outputs, as its twin does, so it is held to one bf16 step (2^-8 of the
largest magnitude) with at most 1% of the elements differing at all, as in
chip_smoke.py.  K5/K5b and their twins are f32 (K5/K5b's products are
3xTF32, f32-exact), so each output is held to 1e-4 of its largest
magnitude.  K6 and its twin take
the same bf16 operands and sum in f32 in another order, so a bf16 output
differs by at most one bf16 step where a sum lands on a rounding boundary:
2^-7 of the largest magnitude.  K6b's f32 gradient is held to 1e-4 of its
largest magnitude, as K5/K5b.  The fp32 kernels K1-f32..K4-f32 and their
twins are f32 throughout (3xTF32 products in the kernels, TF32 off in the
twins), so each output is held to a relative L2 error of 1e-5; a twin
with one single-pass-TF32 or bf16-staged product must read above it.  The
fp32 backward kernels K1b-f32..K4b-f32 are held alike, every gradient
output to F32_BWD_REL (chip_smoke.F32_BWD_REL_L2), and repeat with equal
bits.  K6-f32 and K6b-f32 (the s2d stem's gathered conv on fp32 operands)
are held to F32_REL and F32_BWD_REL, repeat with equal bits, and operands
of mixed dtypes raise.
"""

import sys
from pathlib import Path

import pytest
import torch

from crog_tpu_torch.ops import attention as A
from crog_tpu_torch.ops import decoder_blocks as DB
from crog_tpu_torch.ops import ffn as FF
from crog_tpu_torch.ops import lincomb as LC
from crog_tpu_torch.ops import s2dconv as SC

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(seed, *shape, std=1.0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * std).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("l,lk,masked,packed,heads", [
    (169, 169, False, False, 8), (676, 17, True, False, 8), (70, 300, True, False, 8),
    (676, 676, False, False, 8), (676, 676, False, True, 8),  # K2's shape; q, k packed as K2 passes them
    (100, 768, False, False, 8), (100, 768, True, False, 8),  # the key limit
    (130, 192, True, False, 8), (130, 193, True, False, 8),  # either side of the path switch
    (64, 1, False, False, 8), (65, 17, "all", False, 8), (65, 300, "all", True, 8),
    # past the old 768-key cap: ViT-B/16 at 448^2, a ragged tile, 640^2's
    # decoder (self, and its cross step over 17 padded keys)
    (785, 785, False, True, 8), (900, 900, False, False, 8), (1000, 1000, True, False, 8),
    (1600, 1600, False, True, 8), (1600, 17, True, False, 8)] + [
    # head dims 8, 16, 32, 128, 256 and 512 (64, 32, 16, 4, 2 and 1 heads of D
    # 512): one pass (two at dh 256 and 512), two passes with q and k packed,
    # K3's masked 17 keys, all keys masked
    (l, lk, masked, packed, heads) for heads in (64, 32, 16, 4, 2, 1)
    for l, lk, masked, packed in ((169, 169, False, False), (676, 676, False, True),
                                  (676, 17, True, False), (65, 300, "all", True))] + [
    # the wide builds off their tiles: one query over one key, a ragged 1000
    (1, 1, False, False, 1), (1000, 1000, True, True, 2), (130, 193, True, False, 1)])
def test_cuda_attention_kernel_matches_twin(card, l, lk, masked, packed, heads):
    """The attention forward on both of its paths (``fwd_path``) against its
    twin, at D 512 over ``heads`` heads (head dims 8 to 512).  ``masked``:
    sample 0 keeps its first lk // 2 keys, sample 1 all; "all": every key of
    sample 0 is masked, so its rows average over the lk keys.  ``packed``: q
    and k are the column halves of one [B, L, 2D] projection (row stride
    2D), as the self block passes them."""
    if packed:
        qk = _bf16(1, 2, max(l, lk), 1024)
        q, k = qk[:, :l, :512], qk[:, :lk, 512:]
    else:
        q, k = _bf16(1, 2, l, 512), _bf16(2, 2, lk, 512)
    v = _bf16(3, 2, lk, 512)
    mask = None
    if masked:
        keep = torch.tensor([[0 if masked == "all" else lk // 2], [lk]])
        mask = torch.where(torch.arange(lk)[None] >= keep, -1e30, 0.0).to(card)
    got = A.fused_attention(q, k, v, heads, mask)
    ref = A.attention_plain(q, k, v, heads, mask)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 3e-2  # bf16 steps
    if masked == "all":  # exactly the mean of v over the keys, up to bf16 steps
        mean = v[0].float().mean(0)
        assert (got[0].float() - mean).abs().max().item() <= 3e-2


def _block_args(seed, d=512, device="cuda"):
    f32 = lambda s, *shape, std: (torch.randn(*shape, generator=torch.Generator()
                                              .manual_seed(s)) * std).to(device)
    return [_bf16(seed, 3 * d, d, std=d**-0.5), f32(seed + 1, 3 * d, std=0.05),
            _bf16(seed + 2, d, d, std=d**-0.5), f32(seed + 3, d, std=0.05),
            1 + f32(seed + 4, d, std=0.1), f32(seed + 5, d, std=0.05),
            1 + f32(seed + 6, d, std=0.1), f32(seed + 7, d, std=0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 64, 32, 16, 4, 2, 1])
def test_cuda_block_kernels_match_twins(card, heads):
    """K2 and K3 in eval at D 512 over 8 heads (the configs') and over 64,
    32, 16 and 4 (head dims 8 to 128)."""
    x, txt = _bf16(1, 2, 676, 512), _bf16(2, 2, 17, 512)
    pos, tpos = _bf16(3, 676, 512, std=0.5), _bf16(4, 17, 512, std=0.5)
    pad = torch.arange(17, device=card)[None].expand(2, 17) >= torch.tensor(
        [[9], [17]], device=card)
    w = _block_args(10)
    got = DB.decoder_self_block(x, pos, *w, heads)
    ref = DB.self_block_plain(x, pos, *w, heads)
    assert (got.float() - ref.float()).abs().max().item() <= 0.125
    got = DB.decoder_cross_block(x, txt, pos, tpos, pad, *w, heads)
    ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, heads)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 0.125


@pytest.mark.cuda
def test_cuda_ffn_kernel_matches_twin(card):
    x = _bf16(1, 1000, 512)  # not a multiple of the 32-row tile
    f32 = lambda s, n, std: (torch.randn(n, generator=torch.Generator()
                                         .manual_seed(s)) * std).to(card)
    args = (x, _bf16(2, 2048, 512, std=512**-0.5), f32(3, 2048, 0.05),
            1 + f32(4, 2048, 0.1), f32(5, 2048, 0.05),
            _bf16(6, 512, 2048, std=2048**-0.5), f32(7, 512, 0.05))
    got = FF.fused_ffn(*args)
    ref = FF.ffn_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 0.125


BWD_REL = 2**-6
K1B_REL, K1B_SHARE = 2**-8, 0.01


def _close_all(got, ref, rel=BWD_REL, share=1.0):
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = rel * r.float().abs().max().item()
        err = (g.float() - r.float()).abs()
        assert torch.isfinite(g.float()).all(), i
        assert err.max().item() <= tol, i
        assert (err > 0).float().mean().item() <= share, i


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,heads,path,dh", [
    (2, 169, 8, "head", 64), (3, 169, 5, "head", 64), (1, 7, 3, "head", 64),
    (2, 256, 4, "head", 64), (2, 300, 8, "rows_cols", 64), (1, 257, 4, "rows_cols", 64),
    (1, 768, 2, "rows_cols", 64), (2, 785, 8, "rows_cols", 64), (1, 900, 4, "rows_cols", 64),
    (1, 1000, 4, "rows_cols", 64), (2, 1600, 8, "rows_cols", 64),
    # head dims 8-128: the two-kernel path at any length (the head kernel
    # takes dh 64 only)
    (2, 169, 64, "rows_cols", 8), (2, 169, 32, "rows_cols", 16), (2, 169, 16, "rows_cols", 32),
    (2, 169, 4, "rows_cols", 128), (1, 7, 3, "rows_cols", 128), (1, 300, 4, "rows_cols", 128),
    (1, 785, 16, "rows_cols", 32),
    # head dims 256 and 512: the wide rows / cols kernels
    (2, 169, 2, "rows_cols", 256), (2, 169, 1, "rows_cols", 512), (1, 7, 1, "rows_cols", 512),
    (1, 300, 2, "rows_cols", 256), (2, 676, 1, "rows_cols", 512)])
def test_cuda_attention_backward_matches_twin(card, b, l, heads, path, dh):
    """K1b against its twin on both paths: the one-CTA-per-head kernel at
    the pool's 169 tokens (also with an odd batch x heads, 15), at a length
    that is not a multiple of 16 and at its limit of 256; the two-kernel
    path at 300 tokens, just past the switch (257), at the old cap of 768
    and past it (ViT-B/16's 785 at 448^2, 900, a ragged 1000, 640^2's
    1600), and at head dims 8 to 128 (two kernels).  A second call gives
    the same bits."""
    assert A.bwd_path(l, dh=dh) == path
    q, k, v, do = (_bf16(s, b, l, heads * dh) for s in (1, 2, 3, 4))
    o = A.fused_attention(q, k, v, heads)
    got = A.attention_bwd(q, k, v, o, do, heads)
    again = A.attention_bwd(q, k, v, o, do, heads)
    ref = A.attention_bwd_plain(q, k, v, o, do, heads)
    torch.cuda.synchronize()
    _close_all(got, ref, K1B_REL, K1B_SHARE)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    with pytest.raises(ValueError, match="head dims 8, 16, 32, 64, 128, 256 or 512"):
        A.attention_bwd(*(t[..., :96].contiguous() for t in (q, k, v, o, do)), 1)


@pytest.mark.cuda
def test_cuda_attention_backward_tolerance_sees_bf16_casts(card):
    """At K1b's main-path shapes (B=24, 169 tokens, 32 heads), the same
    kernels with the decoder blocks' cast points (P and dS rounded to bf16)
    match their own twin but fail K1b's tolerance against K1b's twin: a K1b
    that lost an f32 cast point would not pass."""
    q, k, v, do = (_bf16(s, 24, 169, 2048) for s in (1, 2, 3, 4))
    o = A.fused_attention(q, k, v, 32)
    ref = A.attention_bwd_plain(q, k, v, o, do, 32)
    _close_all(A.attention_bwd(q, k, v, o, do, 32), ref, K1B_REL, K1B_SHARE)
    lost = A.attention_bwd(q, k, v, o, do, 32, bf16_casts=True)
    _close_all(lost, A.mha_bwd_plain(q, k, v, do, 32))
    shares = [((g.float() - r.float()).abs() > 0).float().mean().item()
              for g, r in zip(lost, ref)]
    torch.cuda.synchronize()
    assert min(shares) > K1B_SHARE, shares


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,mask,dh", [
    (2, 676, 676, 8, None, 64), (2, 676, 17, 8, "ragged", 64), (1, 768, 768, 2, None, 64),
    (2, 70, 300, 4, "ragged", 64), (3, 65, 129, 3, None, 64), (2, 100, 17, 8, "all", 64),
    (1, 1, 1, 2, None, 64),
    (2, 785, 785, 8, None, 64), (1, 900, 900, 2, None, 64), (2, 1000, 1000, 2, "ragged", 64),
    (2, 1600, 1600, 8, None, 64), (2, 1600, 17, 8, "ragged", 64),
    # head dims 8-128 at D 512 (K2b's and K3b's steps at 64, 32, 16 and 4 heads)
    (2, 676, 676, 64, None, 8), (2, 676, 17, 32, "ragged", 16), (2, 676, 676, 16, None, 32),
    (2, 676, 17, 4, "ragged", 128), (2, 100, 17, 64, "all", 8), (2, 1600, 1600, 4, None, 128),
    (3, 65, 129, 3, None, 128),
    # head dims 256 and 512 (K2b's and K3b's steps at 2 and 1 heads)
    (2, 676, 676, 2, None, 256), (2, 676, 17, 2, "ragged", 256), (2, 676, 676, 1, None, 512),
    (2, 676, 17, 1, "ragged", 512), (2, 100, 17, 1, "all", 512), (3, 65, 129, 1, None, 512),
    (1, 1, 1, 1, None, 512)])
def test_cuda_decoder_attention_backward_matches_twin(card, b, lq, lk, heads, mask, dh):
    """The two-kernel attention backward with the decoder blocks' bf16 cast
    points (K2b's and K3b's attention step) against its twin: K2b's 676
    tokens, K3b's 676 queries over 17 keys with per-sample key padding,
    the old 768-key cap and past it (785, 900, 1000 with padded keys, and
    640^2's 1600 tokens and 1600 queries over 17 padded keys), lengths
    just past a 64-row tile, one query over one key, and a sample whose
    every key is masked (its rows average over the Lk keys, as the
    forward's do); at head dims 8 to 128.  A second call gives the same
    bits."""
    q, do = _bf16(1, b, lq, heads * dh), _bf16(4, b, lq, heads * dh)
    k, v = _bf16(2, b, lk, heads * dh), _bf16(3, b, lk, heads * dh)
    mask_add = None
    if mask is not None:
        keep = torch.arange(lk)[None] < torch.tensor([[max(1, lk // 3)], [lk]] + [[lk]] * (b - 2))
        if mask == "all":
            keep[0] = False
        mask_add = torch.where(keep, 0.0, A.NEG).to(card)
    o = A.attention_plain(q, k, v, heads, mask_add)
    got = A.attention_bwd(q, k, v, o, do, heads, bf16_casts=True, mask_add=mask_add)
    again = A.attention_bwd(q, k, v, o, do, heads, bf16_casts=True, mask_add=mask_add)
    ref = A.mha_bwd_plain(q, k, v, do, heads, mask_add)
    torch.cuda.synchronize()
    _close_all(got, ref)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    with pytest.raises(ValueError, match="bf16 cast points"):
        A.attention_bwd(q, k, v, o, do, heads, mask_add=mask_add if mask else
                        torch.zeros(b, lk, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 64, 32, 16, 4, 2, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_kernels_train_mode_match_twins(card, rate, heads):
    """Forward with dropout and backward, self and cross block (a padded
    key mask), L=676 as on the main path, over 8 heads of 64 and over 64,
    32, 16, 4, 2 and 1 heads (head dims 8 to 512)."""
    x, txt = _bf16(1, 2, 676, 512), _bf16(2, 2, 17, 512)
    pos, tpos = _bf16(3, 676, 512, std=0.5), _bf16(4, 17, 512, std=0.5)
    dy = _bf16(5, 2, 676, 512)
    pad = torch.arange(17, device=card)[None].expand(2, 17) >= torch.tensor(
        [[9], [17]], device=card)
    w = _block_args(10)
    y, saved = DB.self_block_fwd(x, pos, *w, heads, 7, rate, save=True)
    assert (y.float() - DB.self_block_plain(x, pos, *w, heads, 7, rate).float()).abs().max() <= 0.125
    _close_all(DB.self_block_bwd(x, saved, dy, heads, 7, rate),
               DB.self_block_bwd_plain(x, pos, *w, dy, heads, 7, rate))
    y, saved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, heads, 8, rate, save=True)
    ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, heads, 8, rate)
    assert (y.float() - ref.float()).abs().max() <= 0.125
    _close_all(DB.cross_block_bwd(x, saved, dy, heads, 8, rate),
               DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, heads, 8, rate))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="D 256, 512, 768 or 1024"):
        DB.self_block_bwd(torch.zeros(2, 676, 640, dtype=torch.bfloat16, device=card), saved,
                          dy, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_kernels_train_mode_match_twins_at_1600(card, rate):
    """K2/K2b and K3/K3b at 640^2's decoder length, past the old 768-token
    cap: 1600 tokens (their attention step on the two-kernel backward), the
    cross block's 1600 queries over 17 text keys with per-sample padding;
    forward within 0.125, every gradient within 2^-6 of its largest
    magnitude, and the backward twice with equal bits."""
    x, txt = _bf16(11, 2, 1600, 512), _bf16(12, 2, 17, 512)
    pos, tpos = _bf16(13, 1600, 512, std=0.5), _bf16(14, 17, 512, std=0.5)
    dy = _bf16(15, 2, 1600, 512)
    pad = torch.arange(17, device=card)[None].expand(2, 17) >= torch.tensor(
        [[9], [17]], device=card)
    w = _block_args(20)
    y, saved = DB.self_block_fwd(x, pos, *w, 8, 7, rate, save=True)
    assert (y.float() - DB.self_block_plain(x, pos, *w, 8, 7, rate).float()).abs().max() <= 0.125
    got = DB.self_block_bwd(x, saved, dy, 8, 7, rate)
    _close_all(got, DB.self_block_bwd_plain(x, pos, *w, dy, 8, 7, rate))
    assert all(torch.equal(u, v) for u, v in zip(got, DB.self_block_bwd(x, saved, dy, 8, 7, rate)))
    y, saved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, 8, 8, rate, save=True)
    ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, 8, 8, rate)
    assert (y.float() - ref.float()).abs().max() <= 0.125
    got = DB.cross_block_bwd(x, saved, dy, 8, 8, rate)
    _close_all(got, DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, 8, 8, rate))
    again = DB.cross_block_bwd(x, saved, dy, 8, 8, rate)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("rate,m", [(0.0, 1000), (0.1, 1000), (0.1, 129)])
def test_cuda_ffn_train_mode_matches_twin(card, rate, m):
    """K4 and K4b against their twins at M not a multiple of K4b's 128-row
    cluster tile; K4b twice gives equal bits in dx, dh, hn and the four
    column sums."""
    x, dy = _bf16(1, m, 512), _bf16(8, m, 512)
    f32 = lambda s, n, std: (torch.randn(n, generator=torch.Generator()
                                         .manual_seed(s)) * std).to(card)
    w1, b1 = _bf16(2, 2048, 512, std=512**-0.5), f32(3, 2048, 0.05)
    g, be = 1 + f32(4, 2048, 0.1), f32(5, 2048, 0.05)
    w2, b2 = _bf16(6, 512, 2048, std=2048**-0.5), f32(7, 512, 0.05)
    y = FF.ffn_fwd(x, w1, b1, g, be, w2, b2, 11, rate)
    assert (y.float() - FF.ffn_plain(x, w1, b1, g, be, w2, b2, 11, rate).float()
            ).abs().max() <= 0.125
    _close_all(FF.ffn_bwd(x, w1, b1, g, be, w2, dy, 11, rate),
               FF.ffn_bwd_plain(x, w1, b1, g, be, w2, dy, 11, rate))
    a, b = (FF.ffn_bwd(x, w1, b1, g, be, w2, dy, 11, rate, with_hidden=True)
            for _ in range(2))
    torch.cuda.synchronize()
    for i in (0, 2, 3, 4, 6, 7, 8):  # dx, db1, dgamma, dbeta, db2, dh, hn
        assert torch.equal(a[i], b[i]), i
    with pytest.raises(ValueError, match="and F=2048, got D=512, F=1024"):
        FF.ffn_bwd(x, w1[:1024], b1[:1024], g[:1024], be[:1024], w2[:, :1024], dy)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [128, 1000, 16224])
def test_cuda_ffn_forward_matches_twin_and_repeats(card, m, rate):
    """K4 (its cluster kernel and y GEMM) against its twin at one 128-row
    cluster tile, at M off the tile (1000) and at the main path's 24 x 676
    rows, under 0.125; two runs give equal bits."""
    x = _bf16(1, m, 512)
    f32 = lambda s, n, std: (torch.randn(n, generator=torch.Generator()
                                         .manual_seed(s)) * std).to(card)
    args = (x, _bf16(2, 2048, 512, std=512**-0.5), f32(3, 2048, 0.05),
            1 + f32(4, 2048, 0.1), f32(5, 2048, 0.05),
            _bf16(6, 512, 2048, std=2048**-0.5), f32(7, 512, 0.05))
    got, again = FF.ffn_fwd(*args, 13, rate), FF.ffn_fwd(*args, 13, rate)
    ref = FF.ffn_plain(*args, 13, rate)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 0.125
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,rate", [(24, 676, 0.1), (3, 301, 0.0), (3, 301, 0.1)])
def test_cuda_block_backward_gemms_match_twins_and_repeat(card, b, l, rate):
    """K2b and K3b, whose dO, fused dX and dW GEMMs are the wgmma kernels
    of csrc/gemm.cuh, against their twins under BWD_REL at the main path's
    shape (24 x 676 rows, 24 x 17 text rows) and at 3 x 301 rows (not a
    multiple of the 128-row tile); two runs give equal bits in every output
    (dx, d txt, dW, the bias and LayerNorm column sums)."""
    x, txt = _bf16(21, b, l, 512), _bf16(22, b, 17, 512)
    pos, tpos = _bf16(23, l, 512, std=0.5), _bf16(24, 17, 512, std=0.5)
    dy = _bf16(25, b, l, 512)
    lengths = torch.tensor([[4 + 13 * i // max(1, b - 1)] for i in range(b)], device=card)
    pad = torch.arange(17, device=card)[None].expand(b, 17) >= lengths
    w = _block_args(30)
    _, saved = DB.self_block_fwd(x, pos, *w, 8, 7, rate, save=True)
    got = DB.self_block_bwd(x, saved, dy, 8, 7, rate)
    _close_all(got, DB.self_block_bwd_plain(x, pos, *w, dy, 8, 7, rate))
    again = DB.self_block_bwd(x, saved, dy, 8, 7, rate)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _, saved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, 8, 8, rate, save=True)
    got = DB.cross_block_bwd(x, saved, dy, 8, 8, rate)
    _close_all(got, DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, 8, 8, rate))
    again = DB.cross_block_bwd(x, saved, dy, 8, 8, rate)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))


def _block_inputs(b, l, t, seed=40):
    x, txt = _bf16(seed, b, l, 512), _bf16(seed + 1, b, t, 512)
    pos, tpos = _bf16(seed + 2, l, 512, std=0.5), _bf16(seed + 3, t, 512, std=0.5)
    lengths = torch.tensor([[1 + (t - 1) * i // max(1, b - 1)] for i in range(b)])
    pad = (torch.arange(t)[None].expand(b, t) >= lengths).to("cuda")
    return x, txt, pos, tpos, pad


def _saved_refs(x, txt, pos, tpos, pad, w, rate, seed, cross):
    """The intermediates K2b / K3b read, from the plain twins' arithmetic:
    (name, reference) in the order of the saved tuple after its weights."""
    in_w, in_b, out_w, out_b, g_pre, b_pre = w[:6]
    b, l, d = x.shape
    x2 = x.reshape(b * l, d)
    xl = DB.ln_fast(x2, g_pre, b_pre)
    qin = xl + pos.repeat(b, 1)
    if cross:
        kv = txt.reshape(-1, d)
        kin = kv + tpos.repeat(b, 1)
        q = DB.dense(qin, in_w[:d], in_b[:d])
        k = DB.dense(kin, in_w[d:2 * d], in_b[d:2 * d])
        v = DB.dense(kv, in_w[2 * d:], in_b[2 * d:])
        mask = DB.key_mask(pad, b, txt.shape[1], x.device)
        o = A.attention_plain(q.view(b, l, d), k.view(b, -1, d), v.view(b, -1, d), 8,
                              mask).reshape(b * l, d)
        refs = [("qin", qin), ("q", q), ("o", o), ("kin", kin), ("k", k), ("v", v)]
    else:
        qk = DB.dense(qin, in_w[:2 * d], in_b[:2 * d])
        v = DB.dense(xl, in_w[2 * d:], in_b[2 * d:])
        o = A.attention_plain(qk[:, :d].reshape(b, l, d), qk[:, d:].reshape(b, l, d),
                              v.view(b, l, d), 8).reshape(b * l, d)
        refs = [("xl", xl), ("qin", qin), ("qk", qk), ("v", v), ("o", o)]
    return refs + [("op", DB.dense(o, out_w, out_b))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,t", [(24, 676, 17), (3, 301, 17), (1, 676, 9), (2, 1600, 17),
                                   (1, 1000, 9)])
@pytest.mark.parametrize("train", [False, True])
def test_cuda_block_forward_kernels_match_twins(card, b, l, t, train):
    """K2 and K3 (the wgmma projection GEMM over K-major in_proj_weight and
    the 2-CTA cluster out-projection with LN, dropout and the residual)
    against their twins at the main path's shape (24 x 676 rows, 24 x 17
    text rows), at 3 x 301 rows (M = 903, MT = 51: neither a multiple of the
    128-row tile) and at one sample of 9 text tokens (MT < 128), in eval and
    in train mode (dropout 0.1, the intermediates K2b and K3b read saved):
    the output under 0.125, each saved intermediate within 2^-6 of its
    largest magnitude (one or two bf16 steps of a flipped rounding);
    op is held to the twin's projection of the kernel's own o, so that a
    flip inside the attention step does not count twice."""
    x, txt, pos, tpos, pad = _block_inputs(b, l, t)
    w = _block_args(50)
    rate = 0.1 if train else 0.0
    for cross in (False, True):
        if cross:
            y, saved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, 8, 9, rate, save=train)
            ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, 8, 9, rate)
        else:
            y, saved = DB.self_block_fwd(x, pos, *w, 8, 9, rate, save=train)
            ref = DB.self_block_plain(x, pos, *w, 8, 9, rate)
        torch.cuda.synchronize()
        assert (y.float() - ref.float()).abs().max().item() <= 0.125, cross
        if not train:
            assert saved is None
            continue
        inter = saved[6:] if cross else saved[4:]
        refs = _saved_refs(x, txt, pos, tpos, pad, w, rate, 9, cross)
        assert len(inter) == len(refs)
        for got, (name, r) in zip(inter, refs):
            if name == "op":
                r = DB.dense(inter[-5 if cross else -2], w[2], w[3])
            assert got.shape == r.shape, name
            tol = BWD_REL * r.float().abs().max().item()
            assert (got.float() - r.float()).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,t", [(24, 676, 17), (3, 301, 17)])
def test_cuda_block_forward_kernels_repeat(card, b, l, t):
    """K2 and K3 in train mode (dropout 0.1, saved) twice: the output and
    every saved intermediate come out with equal bits (no atomics, the LN
    row sums added in rank order across the cluster)."""
    x, txt, pos, tpos, pad = _block_inputs(b, l, t)
    w = _block_args(60)
    calls = (lambda: DB.self_block_fwd(x, pos, *w, 8, 5, 0.1, save=True),
             lambda: DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, 8, 6, 0.1, save=True))
    for call in calls:
        (ya, sa), (yb, sb) = call(), call()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip((ya, *sa), (yb, *sb)))


LINCOMB_REL = 1e-4  # both f32; only the order of the pixel and column sums differs


@pytest.mark.cuda
@pytest.mark.parametrize("boxes", ["some", "full-map", "off-map", "ragged"])
@pytest.mark.parametrize("kind,t", [("bce", 1), ("smooth_l1", 4)])
def test_cuda_lincomb_kernels_match_twins(card, kind, t, boxes):
    """K5 and K5b against their twins on ragged shapes: 40x44 pixels (regions
    of 5 x 22 for K5 and 10 x 22 for K5b, not multiples of the 8-pixel
    tile), 37 anchors
    (kt not a multiple of the 16-column tile), T*M = 8 rows.  ``some``: two
    anchors' boxes lie off the map (empty crops), the rest are 0.05-0.30 of
    it; ``full-map``: every box covers the map (nothing is skipped);
    ``off-map``: every box lies off the map (the sums are the outside loss
    alone, the gradients 0); ``ragged``: 37 x 29 pixels and 7 anchors.  The
    results are the same in a second run."""
    b, ph, pw, k, m = 2, 40, 44, 37, 8 // t
    if boxes == "ragged":
        ph, pw, k = 37, 29, 7
    g = torch.Generator().manual_seed(t)
    protos = torch.relu(torch.randn(b, ph, pw, 32, generator=g))
    coef = torch.tanh(torch.randn(b, k, t, 32, generator=g))
    ds = torch.rand(b, t * m, ph * pw, generator=g)
    if kind == "bce":
        ds = (ds > 0.5).float()
    lo = torch.rand(b, k, 2, generator=g) * 0.7
    box = torch.cat([lo, lo + 0.05 + 0.25 * torch.rand(b, k, 2, generator=g)], -1)
    box[:, :2] = torch.tensor([1.2, 1.2, 1.5, 1.5])
    if boxes == "full-map":
        box[:] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    elif boxes == "off-map":
        box[:] = torch.tensor([-0.6, 1.1, -0.3, 1.4])
    sel_gt = torch.randint(0, m, (b, k), generator=g)
    gsum = torch.randn(b, k * t, generator=g).to(card)
    args = LC.kernel_args(*(x.to(card) for x in (protos, coef, ds, sel_gt, box)), t)
    got = [LC.lincomb_fwd(*args, t, loss_kind=kind),
           *LC.lincomb_bwd(*args, gsum, t, loss_kind=kind)]
    ref = [LC.lincomb_task_sums_plain(*args, t, loss_kind=kind),
           *LC.lincomb_bwd_plain(*args, gsum, t, loss_kind=kind)]
    again = [LC.lincomb_fwd(*args, t, loss_kind=kind),
             *LC.lincomb_bwd(*args, gsum, t, loss_kind=kind)]
    torch.cuda.synchronize()
    _close_all(got, ref, LINCOMB_REL)
    for a, r in zip(got, again):
        assert torch.equal(a, r)
    if boxes == "off-map":
        assert (got[1] == 0).all() and (got[2] == 0).all()
    elif boxes != "full-map":
        assert (got[1][:, :2 * t] == 0).all()  # an empty crop takes no gradient
    with pytest.raises(ValueError, match="int32"):
        LC.lincomb_fwd(*args[:3], args[3].long(), args[4], t, loss_kind=kind)
    with pytest.raises(ValueError, match="prototypes"):
        LC.lincomb_fwd(args[0][..., :16].contiguous(), args[1][..., :16].contiguous(),
                       *args[2:], t, loss_kind=kind)


@pytest.mark.cuda
def test_cuda_ssg_raw_unpack_matches_cpu(card):
    """SSG's raw unpack (plain PyTorch on the card, no hand-written kernel)
    of one batch of 2 augmented synthetic frames at 480 x 640 -> 544^2, as
    the train step calls it (pad_objs 24, emit_ds), against the CPU, both
    f32 with TF32 off: chip_smoke.py's ``unpack_gap`` and its UNPACK_*
    tolerances."""
    import random

    import chip_smoke as cs
    from crog_tpu_torch.data.ssg_rawwire import collate_ssg_raw
    from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGraspFrames

    ds = SyntheticOCIDGraspFrames(num_samples=2, raw=True, rng=random.Random(0))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        errs = cs.unpack_gap(collate_ssg_raw([ds[0], ds[1]]), card, 544, 24)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert set(errs) >= {"img", "ins_ds", "sem_ds", "grasp_ds.sin"}


S2D_REL = 2**-7  # K6: one bf16 step at the top binade; K6b: LINCOMB_REL


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64), (64, 32), (64, 64)])
def test_cuda_s2dconv_kernels_match_twins(card, ci, co):
    """K6 (forward shapes (32, 32) and (32, 64), dgrad shapes (32, 32) and
    (64, 32)) and K6b against their twins on ragged planes (20 x 37 cells:
    neither a multiple of the 8 x 16 tile); K6b gives the same gradient in
    a second run."""
    b, h, w = 2, 20, 37
    g = torch.Generator().manual_seed(ci + co)
    x = torch.relu(torch.randn(b, h, w, 4 * ci, generator=g)).to(card, torch.bfloat16)
    wt = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(card)
    dy = torch.randn(b, h, w, 4 * co, generator=g).to(card, torch.bfloat16)
    wp = SC.pack_s1(wt).to(torch.bfloat16).contiguous()
    before = SC.s2dconv_fwd.launches, SC.s2dconv_wgrad.launches
    got = SC.s2dconv_fwd(x, wp, ci, co)
    dwp = SC.s2dconv_wgrad(x, dy, ci, co)
    again = SC.s2dconv_wgrad(x, dy, ci, co)
    torch.cuda.synchronize()
    _close_all([got], [SC.conv_padded_plain(x, wp, ci, co)], S2D_REL)
    _close_all([dwp], [SC.wgrad_plain(x, dy, ci, co)], LINCOMB_REL)
    assert torch.equal(dwp, again)
    assert (SC.s2dconv_fwd.launches, SC.s2dconv_wgrad.launches) == (before[0] + 1,
                                                                   before[1] + 2)


@pytest.mark.cuda
def test_cuda_blocked_conv_autograd_matches_twins(card):
    """blocked_conv3x3_s1 on the card: forward K6, dgrad K6 with the flipped,
    swapped kernel, wgrad K6b folded by unpack_s1, each against the twins on
    the same bf16 tensors; widths the kernels do not take raise."""
    ci, co = 32, 64
    g = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn(2, 16, 24, 4 * ci, generator=g)).to(card, torch.bfloat16)
    wt = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(card)
    dy = torch.randn(2, 16, 24, 4 * co, generator=g).to(card, torch.bfloat16)
    xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
    y = SC.blocked_conv3x3_s1(xg, wg)
    y.backward(dy)
    flip = SC.pack_s1(torch.flip(wt, (0, 1)).permute(0, 1, 3, 2)).to(torch.bfloat16)
    ref_dx = SC.conv_padded_plain(dy, flip, co, ci)
    ref_dw = SC.unpack_s1(SC.wgrad_plain(x, dy, ci, co), ci, co)
    torch.cuda.synchronize()
    _close_all([y.detach(), xg.grad], [SC.conv_padded_plain(
        x, SC.pack_s1(wt).to(torch.bfloat16), ci, co), ref_dx], S2D_REL)
    _close_all([wg.grad], [ref_dw], LINCOMB_REL)
    # operands of mixed dtypes raise, before any launch
    wp16 = SC.pack_s1(wt).to(torch.bfloat16).contiguous()
    with pytest.raises(ValueError, match="wp: expected torch.float32"):
        SC.s2dconv_fwd(x.float(), wp16, ci, co)
    with pytest.raises(ValueError, match="wp: expected torch.bfloat16"):
        SC.s2dconv_fwd(x, wp16.float(), ci, co)
    with pytest.raises(ValueError, match="dy: expected torch.float32"):
        SC.s2dconv_wgrad(x.float(), dy, ci, co)
    with pytest.raises(ValueError, match="K6 takes bf16 or fp32"):
        SC.s2dconv_fwd(x.half(), wp16.half(), ci, co)
    with pytest.raises(ValueError, match="ci, co in"):
        SC.s2dconv_fwd(x[..., :64].contiguous(), SC.pack_s1(wt[:, :, :16]).to(
            torch.bfloat16).contiguous(), 16, co)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co", [(1, 13, 21, 32, 32), (3, 9, 35, 32, 64),
                                         (3, 20, 7, 32, 32), (1, 5, 3, 32, 64)])
def test_cuda_s2dconv_wgrad_ragged_planes(card, b, h, w, ci, co):
    """K6b's cluster kernel against its twin where the planes are not
    multiples of the 8 x 16 cell tile (and, at 5 x 3 cells, smaller than
    one tile and its halo) for the stem's (32, 32) and (32, 64) at batch 1
    and 3; a second call gives the same bits."""
    g = torch.Generator().manual_seed(b * h + w)
    x = torch.relu(torch.randn(b, h, w, 4 * ci, generator=g)).to(card, torch.bfloat16)
    dy = torch.randn(b, h, w, 4 * co, generator=g).to(card, torch.bfloat16)
    got = SC.s2dconv_wgrad(x, dy, ci, co)
    again = SC.s2dconv_wgrad(x, dy, ci, co)
    torch.cuda.synchronize()
    _close_all([got], [SC.wgrad_plain(x, dy, ci, co)], LINCOMB_REL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co", [(1, 13, 21, 32, 32), (3, 9, 35, 32, 64),
                                         (2, 20, 7, 64, 32), (1, 5, 3, 64, 64),
                                         (3, 40, 70, 64, 64), (2, 33, 50, 32, 64)])
def test_cuda_s2dconv_fwd_ragged_planes(card, b, h, w, ci, co):
    """K6's persistent kernel against its twin where the planes are not
    multiples of the 8 x 16 cell tile (at 5 x 3 cells smaller than one tile
    and its halo), at ci = 32 (the forward's widths: one 128-column weight
    slice, or two) and ci = 64 (the dgrad's: 64-column slices), with ranges
    of one tile and of several; a second call gives the same bits."""
    g = torch.Generator().manual_seed(b * h + w + ci)
    x = torch.relu(torch.randn(b, h, w, 4 * ci, generator=g)).to(card, torch.bfloat16)
    wt = (torch.randn(3, 3, ci, co, generator=g) * (9 * ci) ** -0.5).to(card)
    wp = SC.pack_s1(wt).to(torch.bfloat16).contiguous()
    got = SC.s2dconv_fwd(x, wp, ci, co)
    again = SC.s2dconv_fwd(x, wp, ci, co)
    torch.cuda.synchronize()
    _close_all([got], [SC.conv_padded_plain(x, wp, ci, co)], S2D_REL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_put_stage_batches_equal_host_arrays(card):
    """DataLoader's put stage (copies on a side stream from the put thread,
    an event the consumer's stream waits on, ``record_stream``) over one
    epoch of rawlb batches at 416^2 with prefetch 2 and a padded tail: every
    dense key of every batch, read back on the consumer's stream after work
    queued on it, equals the host arrays; the ragged fields pass unchanged."""
    import numpy as np

    from crog_tpu_torch.data.loader import DataLoader, DevicePut
    from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG

    ds = SyntheticOCIDVLG(num_samples=10, split="val", input_size=416, raw="lb")
    host = list(DataLoader(ds, 4, pad_last_batch=True, num_workers=1))
    got = []
    with DataLoader(ds, 4, pad_last_batch=True, num_workers=4, prefetch=2,
                    device_put_fn=DevicePut(card)) as loader:
        for batch in loader:
            dense = {k: v for k, v in batch.items() if torch.is_tensor(v)}
            assert all(v.is_cuda for v in dense.values())
            # consumer work on the current stream, queued behind the copies
            sums = {k: v.double().sum() for k, v in dense.items()}
            got.append(({k: v.cpu().numpy() for k, v in dense.items()},
                        {k: float(s) for k, s in sums.items()}, batch))
    assert len(got) == len(host) == 3
    for (dense, sums, batch), ref in zip(got, host):
        keys = sorted(k for k, v in ref.items() if isinstance(v, np.ndarray))
        assert sorted(dense) == keys and "lb_img_u8" in keys
        for k in keys:
            np.testing.assert_array_equal(dense[k], ref[k], err_msg=k)
            # f64 sums of the same values in another order
            assert sums[k] == pytest.approx(float(ref[k].astype(np.float64).sum()),
                                            rel=1e-12), k
        assert batch["sentence"] == ref["sentence"]
        assert batch.get("n_valid") == ref.get("n_valid")


# ------------------------------------------------------------ fp32 kernels
# K1-f32..K4-f32 (compute_dtype float32) against their fp32 twins, TF32 off:
# the kernels form every product as 3xTF32 (f32 accuracy) and sum in
# another order than the library, so each output is held to a relative L2
# error of 1e-5 (chip_smoke.F32_REL_L2); one TF32 pass or bf16-staged
# operands in any single product read above it.
F32_REL = 1e-5


def _f32(seed, *shape, std=1.0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * std).to(device)


def _rel_l2(got, ref):
    """as chip_smoke.rel_l2: 0 where both are exactly 0"""
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


@pytest.fixture
def exact_f32(card):
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul

    set_exact_fp32_matmul()
    return card


@pytest.mark.cuda
@pytest.mark.parametrize("l,lk,heads,masked,layout,dh", [
    (169, 169, 32, False, "plain", 64), (169, 169, 32, False, "packed", 64),  # K1's shape
    (169, 169, 32, False, "strided", 64), (676, 17, 8, True, "plain", 64),  # K3's step
    (676, 676, 8, False, "packed", 64), (70, 300, 4, True, "plain", 64),  # K2's step
    (100, 768, 8, True, "strided", 64), (64, 1, 8, False, "plain", 64),
    (65, 17, 8, "all", "plain", 64), (1, 5, 2, False, "packed", 64),
    # on and just off the 64-key tiles and 64-query CTAs
    (63, 63, 2, False, "plain", 64), (64, 64, 2, True, "packed", 64),
    (65, 65, 2, False, "strided", 64), (129, 676, 2, True, "plain", 64),
    # past the old 768-key cap (640^2's decoder: 1600 tokens, and 1600
    # queries over 17 padded keys)
    (785, 785, 8, False, "packed", 64), (900, 900, 2, True, "plain", 64),
    (1000, 1000, 2, False, "strided", 64), (1600, 1600, 8, False, "packed", 64),
    (1600, 17, 8, True, "plain", 64),
    # head dims 8-128 at D 512 (dh 128: 32-key tiles, on and off them)
    (169, 169, 64, False, "plain", 8), (676, 17, 32, True, "plain", 16),
    (676, 676, 16, False, "packed", 32), (65, 17, 64, "all", "plain", 8),
    (676, 676, 4, False, "packed", 128), (676, 17, 4, True, "plain", 128),
    (65, 17, 4, "all", "plain", 128), (129, 33, 2, True, "strided", 128),
    (63, 31, 4, False, "plain", 128), (1600, 1600, 4, False, "packed", 128),
    # head dims 256 and 512: a CTA's 128 columns of O (grid z), K in
    # 64-column chunks over 32-key tiles, on and off them
    (676, 676, 2, False, "packed", 256), (676, 17, 2, True, "plain", 256),
    (65, 17, 2, "all", "plain", 256), (129, 33, 1, True, "strided", 512),
    (676, 676, 1, False, "packed", 512), (676, 17, 1, True, "plain", 512),
    (1, 5, 1, False, "plain", 512), (1000, 1000, 1, False, "strided", 512)])
def test_cuda_attention_f32_matches_twin(exact_f32, l, lk, heads, masked, layout, dh):
    """K1-f32 against its fp32 twin, o and the row logsumexp (the one
    attention forward of K1-f32, K2-f32 and K3-f32; K1b-f32 reads the
    logsumexp), a second call with the logsumexp giving o's bits again.
    "packed": q, k and v are column thirds of one [B, L, 3D] projection
    (row stride 3D); "strided": they are the first rows of longer sequences
    (batch stride past L rows).  ``masked`` as in the bf16 test; "all"
    masks every key of sample 0, whose rows are then the mean of v.  Head
    dim ``dh``."""
    d = heads * dh
    if layout == "packed":
        qkv = _f32(1, 2, max(l, lk), 3 * d)
        q, k, v = qkv[:, :l, :d], qkv[:, :lk, d:2 * d], qkv[:, :lk, 2 * d:]
    elif layout == "strided":
        q = _f32(1, 2, l + 7, d)[:, :l]
        k, v = _f32(2, 2, lk + 3, d)[:, :lk], _f32(3, 2, lk + 3, d)[:, :lk]
    else:
        q, k, v = _f32(1, 2, l, d), _f32(2, 2, lk, d), _f32(3, 2, lk, d)
    mask = None
    if masked:
        keep = torch.tensor([[0 if masked == "all" else lk // 2], [lk]])
        mask = torch.where(torch.arange(lk)[None] >= keep, -1e30, 0.0).to(exact_f32)
    before = A.fused_attention.launches_f32
    got = A.fused_attention(q, k, v, heads, mask)
    again, lse = A.fused_attention(q, k, v, heads, mask, with_lse=True)
    ref, ref_lse = A.attention_plain(q, k, v, heads, mask, with_lse=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and A.fused_attention.launches_f32 == before + 2
    assert _rel_l2(got, ref) <= F32_REL
    assert lse.shape == (2, heads, l) and _rel_l2(lse, ref_lse) <= F32_REL
    assert torch.equal(got, again)
    if masked == "all":
        assert _rel_l2(got[0], v[0].mean(0).expand(l, d)) <= F32_REL


def _f32_block(b, l, t, seed=60, d=512):
    x, txt = _f32(seed, b, l, d), _f32(seed + 1, b, t, d)
    pos, tpos = _f32(seed + 2, l, d, std=0.5), _f32(seed + 3, t, d, std=0.5)
    lengths = torch.tensor([[1 + (t - 1) * i // max(1, b - 1)] for i in range(b)])
    pad = (torch.arange(t)[None].expand(b, t) >= lengths).to("cuda")
    w = [_f32(seed + 4, 3 * d, d, std=d**-0.5), _f32(seed + 5, 3 * d, std=0.05),
         _f32(seed + 6, d, d, std=d**-0.5), _f32(seed + 7, d, std=0.05),
         1 + _f32(seed + 8, d, std=0.1), _f32(seed + 9, d, std=0.05),
         1 + _f32(seed + 10, d, std=0.1), _f32(seed + 11, d, std=0.05)]
    return x, txt, pos, tpos, pad, w


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,t,heads", [
    (24, 676, 17, 8), (3, 301, 17, 8), (1, 676, 9, 8), (2, 5, 1, 8),
    # B*L on and off the GEMM's 128-row tiles and the 64-row warpgroups
    (1, 1, 17, 8), (1, 63, 17, 8), (1, 64, 17, 8), (1, 65, 17, 8), (1, 129, 17, 8),
    # the cross block's k and v over B*T = 408 text rows, not a multiple of 128
    (24, 5, 17, 8),
    # past the old 768-token cap: 640^2's 1600 tokens, a ragged 1000
    (2, 1600, 17, 8), (1, 1000, 17, 8),
    # head dims 8, 16, 32, 128, 256 and 512 at the main path's shape, and ragged
    (24, 676, 17, 64), (24, 676, 17, 32), (24, 676, 17, 16), (24, 676, 17, 4),
    (3, 301, 17, 4), (1, 65, 9, 16), (24, 676, 17, 2), (24, 676, 17, 1), (3, 301, 17, 1),
    (1, 65, 9, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_f32_kernels_match_twins(exact_f32, b, l, t, heads, rate):
    """K2-f32 and K3-f32 against their fp32 twins, in eval and with
    train-mode dropout (the same counter-based mask), at the main path's
    shapes and at ragged ones, over 8 heads and over 64, 32, 16, 4, 2 and 1;
    a second call gives the same bits."""
    x, txt, pos, tpos, pad, w = _f32_block(b, l, t)
    cases = ((lambda: DB.self_block_fwd(x, pos, *w, heads, 7, rate)[0],
              lambda: DB.self_block_plain(x, pos, *w, heads, 7, rate)),
             (lambda: DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, heads, 8, rate)[0],
              lambda: DB.cross_block_plain(x, txt, pos, tpos, pad, *w, heads, 8, rate)))
    for kern, plain in cases:
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert _rel_l2(got, ref) <= F32_REL
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_f32_autograd_reads_the_forwards_intermediates(exact_f32, rate):
    """Through autograd at the main path's shape (B 24, 676 tokens, 17 text
    tokens): decoder_self_block and decoder_cross_block on fp32 leaves run
    K2-f32 / K3-f32 forward and K2b-f32 / K3b-f32 backward on the
    intermediates that forward saved (the wgmma products' and the wgmma
    attention's), once each; every gradient within F32_BWD_REL of the twins'
    (self_block_bwd_plain, cross_block_bwd_plain)."""
    x, txt, pos, tpos, pad, w = _f32_block(24, 676, 17)
    dy = _f32(98, 24, 676, 512)
    counters = [(fn, "launches_f32") for fn in (DB.self_block_fwd, DB.self_block_bwd,
                                                DB.cross_block_fwd, DB.cross_block_bwd)]
    before = [getattr(fn, a) for fn, a in counters]
    leaves = [t.clone().requires_grad_() for t in (x, *w)]
    with torch.enable_grad():
        y = DB.decoder_self_block(leaves[0], pos, *leaves[1:], 8, 7, rate)
    got = torch.autograd.grad(y, leaves, dy)
    ref = DB.self_block_bwd_plain(x, pos, *w, dy, 8, 7, rate)
    _close_rel(got, ref, ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre",
                          "d_b_pre", "d_g_post", "d_b_post"))
    leaves = [t.clone().requires_grad_() for t in (x, txt, *w)]
    with torch.enable_grad():
        y = DB.decoder_cross_block(leaves[0], leaves[1], pos, tpos, pad, *leaves[2:], 8, 8, rate)
    got = torch.autograd.grad(y, leaves, dy)
    ref = DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, 8, 8, rate)
    _close_rel(got, ref, ("dx", "dtxt", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre",
                          "d_b_pre", "d_g_post", "d_b_post"))
    assert [getattr(fn, a) - b0 for (fn, a), b0 in zip(counters, before)] == [1, 1, 1, 1]


# K4-f32's and K4b-f32's row counts: the main path's 16224 (two dW chunks),
# and counts on, just off and inside the GEMM's 128-row tiles and its
# warpgroups' 64 rows
FFN_F32_ROWS = [1, 63, 64, 65, 129, 1000, 16224]


def _ffn_f32_args(m, dy: bool = False, d: int = 512):
    """K4-f32's (x, w1, b1, gamma, beta, w2, b2) over m rows of width d, or
    K4b-f32's with dy in place of b2."""
    return (_f32(1, m, d), _f32(2, 2048, d, std=d**-0.5), _f32(3, 2048, std=0.05),
            1 + _f32(4, 2048, std=0.1), _f32(5, 2048, std=0.05),
            _f32(6, d, 2048, std=2048**-0.5), _f32(8, m, d) if dy else _f32(7, d, std=0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("m", FFN_F32_ROWS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_ffn_f32_matches_twin(exact_f32, rate, m):
    """K4-f32 against its fp32 twin, eval and train-mode dropout, at the main
    path's 16224 rows and at row counts off the 128-row tile; a second call
    gives the same bits."""
    args = _ffn_f32_args(m)
    before = FF.ffn_fwd.launches_f32
    got = FF.fused_ffn(*args, 3, rate)
    ref = FF.ffn_plain(*args, 3, rate)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and FF.ffn_fwd.launches_f32 == before + 1
    assert _rel_l2(got, ref) <= F32_REL
    assert torch.equal(FF.fused_ffn(*args, 3, rate), got)


@pytest.mark.cuda
def test_cuda_fp32_kernels_tolerance_sees_tf32(exact_f32):
    """At the main path's shapes (B=24: K1 over 169 tokens and 32 heads; K2
    and K3 over 676 tokens, 17 masked text keys; K4 over 16224 rows), each
    fp32 kernel meets F32_REL, and its twin with any one of its products
    formed by one TF32 pass or from bf16-staged operands
    (chip_smoke.fp32_twin_controls) does not: a kernel that lost f32
    accuracy in any product would fail the tolerance.
    tools/torch_fp32_faults.py reads the same faults planted in the
    kernels."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    q, k, v = (_f32(s, 24, 169, 2048) for s in (1, 2, 3))
    x, txt, pos, tpos, pad, w = _f32_block(24, 676, 17)
    f = (_f32(1, 16224, 512), _f32(2, 2048, 512, std=512**-0.5), _f32(3, 2048, std=0.05),
         1 + _f32(4, 2048, std=0.1), _f32(5, 2048, std=0.05),
         _f32(6, 512, 2048, std=2048**-0.5), _f32(7, 512, std=0.05))
    kernels = {
        "attention_f32": (lambda: A.fused_attention(q, k, v, 32),
                          lambda: A.attention_plain(q, k, v, 32)),
        "decoder_self_block_f32": (lambda: DB.self_block_fwd(x, pos, *w, 8)[0],
                                   lambda: DB.self_block_plain(x, pos, *w, 8)),
        "decoder_cross_block_f32": (
            lambda: DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, 8)[0],
            lambda: DB.cross_block_plain(x, txt, pos, tpos, pad, *w, 8)),
        "ffn_f32": (lambda: FF.ffn_fwd(*f), lambda: FF.ffn_plain(*f)),
    }
    refs = {name: plain() for name, (_, plain) in kernels.items()}
    for name, (kern, _) in kernels.items():
        assert _rel_l2(kern(), refs[name]) <= F32_REL, name
    controls = cs.fp32_twin_controls({n: plain for n, (_, plain) in kernels.items()}, refs)
    assert set(controls) == set(kernels)
    for name, by_product in controls.items():
        for product, by_fault in by_product.items():
            for fault, rel in by_fault.items():
                assert rel > F32_REL, (name, product, fault)


# the fp32 backward kernels: each gradient output within a relative L2
# error of chip_smoke.F32_BWD_REL_L2 of its twin's
F32_BWD_REL = 1e-5


def _s2d_counts():
    return [getattr(f, a) for f in (SC.s2dconv_fwd, SC.s2dconv_wgrad)
            for a in ("launches", "launches_f32")]


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64), (64, 32), (64, 64)])
@pytest.mark.parametrize("b,h,w", [(2, 20, 37), (3, 9, 35), (1, 5, 3),
                                   (2, 8, 8), (1, 3, 43),  # one 128-cell tile, one cell past
                                   (1, 9, 127),  # an image edge in every tile, each shift
                                   (24, 104, 104)])  # the main path's cells
def test_cuda_s2dconv_f32_kernels_match_twins_and_repeat(exact_f32, ci, co, b, h, w):
    """K6-f32 and K6b-f32 against their fp32 twins on ragged planes (neither
    dimension a multiple of anything the kernels tile by; 5 x 3 cells fewer
    than one 128-cell tile), on exactly one 128-cell tile and one cell past
    it, at W = 127 (an image's left and right edge inside every 128-cell
    tile, at another row of it each time, so each shift of the gathered
    patch crosses one) and at the main path's B*H*W, full fp32 values:
    within F32_REL (forward) and F32_BWD_REL (wgrad), equal bits on repeat,
    counted in launches_f32 and not in the bf16 counters.  The twin
    multiplies every block of the packed weight, so at co 64, where K6-f32
    skips the structural zeros, this also holds the skip against no skip."""
    x = torch.relu(_f32(ci + co + h, b, h, w, 4 * ci))
    wp = SC.pack_s1(_f32(w, 3, 3, ci, co, std=(9 * ci) ** -0.5))
    dy = _f32(b + w, b, h, w, 4 * co)
    before = _s2d_counts()
    y, y2 = SC.s2dconv_fwd(x, wp, ci, co), SC.s2dconv_fwd(x, wp, ci, co)
    dwp, dwp2 = SC.s2dconv_wgrad(x, dy, ci, co), SC.s2dconv_wgrad(x, dy, ci, co)
    torch.cuda.synchronize()
    assert y.dtype == dwp.dtype == torch.float32
    assert _rel_l2(y, SC.conv_padded_plain(x, wp, ci, co)) <= F32_REL
    assert _rel_l2(dwp, SC.wgrad_plain(x, dy, ci, co)) <= F32_BWD_REL
    assert torch.equal(y, y2) and torch.equal(dwp, dwp2)
    assert _s2d_counts() == [before[0], before[1] + 2, before[2], before[3] + 2]


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64), (64, 32), (64, 64)])
def test_cuda_s2dconv_f32_skips_only_zero_blocks(exact_f32, ci, co):
    """K6-f32 multiplies, in each 128-column tile of its output, the
    slot-rows of the packed weight that ``fwd_f32_slot_rows`` names and no
    other: with pack_s1's structural zeros filled with noise, its output
    equals the twin's on that weight with the blocks outside each tile's
    slot-rows zeroed (at co 32 none is, at co 64 the noise is then unseen)."""
    b, h, w = 2, 13, 21
    x = torch.relu(_f32(ci + co, b, h, w, 4 * ci))
    wp = SC.pack_s1(_f32(co, 3, 3, ci, co, std=(9 * ci) ** -0.5))
    filled = (wp + (wp == 0) * _f32(ci, 16 * ci, 4 * co)).contiguous()
    seen = filled.clone()
    for n0 in range(0, 4 * co, 128):
        lo, hi = SC.fwd_f32_slot_rows(co, n0)
        seen[:lo * 4 * ci, n0:n0 + 128] = 0
        seen[hi * 4 * ci:, n0:n0 + 128] = 0
    y = SC.s2dconv_fwd(x, filled, ci, co)
    torch.cuda.synchronize()
    assert _rel_l2(y, SC.conv_padded_plain(x, seen, ci, co)) <= F32_REL
    assert (_rel_l2(y, SC.conv_padded_plain(x, filled, ci, co)) > F32_REL) == (co == 64)


@pytest.mark.cuda
def test_cuda_s2dconv_f32_tolerance_sees_tf32(exact_f32):
    """At conv3's shape on the main path (batch 24, 104 x 104 cells, ci 32,
    co 64), K6-f32 and K6b-f32 meet their limits, and their twins with the
    product formed by one TF32 pass or from bf16-staged operands
    (chip_smoke.fp32_twin_controls) do not."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    ci, co = 32, 64
    x = torch.relu(_f32(1, 24, 104, 104, 4 * ci))
    wp = SC.pack_s1(_f32(2, 3, 3, ci, co, std=(9 * ci) ** -0.5))
    dy = _f32(3, 24, 104, 104, 4 * co)
    kernels = {"s2dconv_f32": (lambda: SC.s2dconv_fwd(x, wp, ci, co),
                               lambda: SC.conv_padded_plain(x, wp, ci, co), F32_REL),
               "s2dconv_wgrad_f32": (lambda: SC.s2dconv_wgrad(x, dy, ci, co),
                                     lambda: SC.wgrad_plain(x, dy, ci, co), F32_BWD_REL)}
    for name, (kern, plain, limit) in kernels.items():
        ref = plain()
        assert _rel_l2(kern(), ref) <= limit, name
        controls = cs.fp32_twin_controls({name: plain}, {name: ref},
                                         {name: cs.F32_S2D_PRODUCTS[name]})
        for product, by_fault in controls[name].items():
            for fault, rel in by_fault.items():
                assert rel > limit, (name, product, fault)


@pytest.mark.cuda
def test_cuda_blocked_conv_f32_autograd_matches_twins(exact_f32):
    """blocked_conv3x3_s1 at fp32 on the card: forward K6-f32, dgrad K6-f32
    with the flipped, swapped kernel, wgrad K6b-f32 folded by unpack_s1,
    each against the fp32 twins; two K6-f32 and one K6b-f32 launch, no bf16
    one."""
    ci, co = 32, 64
    x = torch.relu(_f32(5, 2, 16, 24, 4 * ci))
    wt = _f32(6, 3, 3, ci, co, std=(9 * ci) ** -0.5)
    dy = _f32(7, 2, 16, 24, 4 * co)
    xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
    before = _s2d_counts()
    y = SC.blocked_conv3x3_s1(xg, wg)
    y.backward(dy)
    torch.cuda.synchronize()
    assert _s2d_counts() == [before[0], before[1] + 2, before[2], before[3] + 1]
    flip = SC.pack_s1(torch.flip(wt, (0, 1)).permute(0, 1, 3, 2))
    assert y.dtype == xg.grad.dtype == wg.grad.dtype == torch.float32
    assert _rel_l2(y.detach(), SC.conv_padded_plain(x, SC.pack_s1(wt), ci, co)) <= F32_REL
    assert _rel_l2(xg.grad, SC.conv_padded_plain(dy, flip, co, ci)) <= F32_REL
    ref_dw = SC.unpack_s1(SC.wgrad_plain(x, dy, ci, co), ci, co)
    assert _rel_l2(wg.grad, ref_dw) <= F32_BWD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64)])
def test_cuda_blocked_conv_f32_autograd_at_stem_shapes(exact_f32, ci, co):
    """blocked_conv3x3_s1 in fp32 through autograd at the stem's shapes
    (batch 24, 104 x 104 cells; conv2 ci = co = 32, conv3 ci 32 -> co 64,
    whose dgrad runs 64 -> 32): dx (K6-f32 with the flipped, swapped kernel)
    and dw (K6b-f32 folded by unpack_s1) within F32_BWD_REL of the twin
    path's, conv_padded_plain and unpack_s1 of wgrad_plain."""
    x = torch.relu(_f32(ci + 1, 24, 104, 104, 4 * ci))
    wt = _f32(co + 2, 3, 3, ci, co, std=(2.0 / (9 * ci)) ** 0.5)
    dy = _f32(co + 3, 24, 104, 104, 4 * co)
    xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
    SC.blocked_conv3x3_s1(xg, wg).backward(dy)
    torch.cuda.synchronize()
    flip = SC.pack_s1(torch.flip(wt, (0, 1)).permute(0, 1, 3, 2))
    assert _rel_l2(xg.grad, SC.conv_padded_plain(dy, flip, co, ci)) <= F32_BWD_REL
    ref_dw = SC.unpack_s1(SC.wgrad_plain(x, dy, ci, co), ci, co)
    assert _rel_l2(wg.grad, ref_dw) <= F32_BWD_REL


def _close_rel(got, ref, names, rel=F32_BWD_REL):
    for n, g, r in zip(names, got, ref):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n
        assert _rel_l2(g, r) <= rel, (n, _rel_l2(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k1b", "blocks"])
@pytest.mark.parametrize("b,lq,lk,heads,masked,dh", [
    (24, 169, 169, 32, False, 64),  # K1b's shape (the attention pool)
    (2, 676, 676, 8, False, 64), (2, 676, 17, 8, True, 64),  # K2b's and K3b's steps
    (2, 70, 300, 4, True, 64), (1, 768, 768, 2, False, 64), (3, 1, 5, 2, True, 64),
    (2, 65, 17, 8, "all", 64),
    # either side of the 64-key blocks and 32-query tiles, Lq != Lk both ways
    (2, 63, 63, 2, False, 64), (2, 64, 64, 2, True, 64), (2, 65, 65, 2, False, 64),
    (2, 129, 129, 2, True, 64), (2, 100, 768, 2, True, 64), (2, 768, 129, 2, False, 64),
    (2, 33, 64, 2, False, 64), (2, 64, 65, 2, True, 64), (2, 97, 63, 2, "peak", 64),
    # past the old 768-token cap, where a CTA walks two or three key blocks
    # into one dQ partial (ops/attention.py:f32_dq_parts)
    (2, 785, 785, 2, False, 64), (1, 900, 900, 2, True, 64), (1, 1000, 1000, 2, False, 64),
    (2, 1600, 1600, 8, False, 64), (2, 1600, 17, 8, True, 64), (2, 40, 1600, 2, True, 64),
    # head dims 8-128 at D 512 (dh 128: the pre-pass's 32-key tiles, the main
    # kernel's two column halves)
    (2, 676, 676, 64, False, 8), (2, 676, 17, 32, True, 16), (2, 676, 676, 16, False, 32),
    (2, 65, 17, 64, "all", 8), (2, 676, 676, 4, False, 128), (2, 676, 17, 4, True, 128),
    (2, 65, 17, 4, "all", 128), (2, 33, 95, 4, True, 128), (1, 1600, 1600, 4, False, 128),
    # head dims 256 and 512: the wide pre-pass and main kernel (64-column
    # chunks; a main CTA per chunk of dK, dV and dQ)
    (2, 676, 676, 2, False, 256), (2, 676, 17, 2, True, 256), (2, 65, 17, 2, "all", 256),
    (2, 676, 676, 1, False, 512), (2, 676, 17, 1, True, 512), (2, 33, 95, 1, True, 512),
    (3, 1, 5, 1, True, 512), (1, 900, 900, 1, False, 512)])
def test_cuda_attention_bwd_f32_matches_twin(exact_f32, mode, b, lq, lk, heads, masked, dh):
    """The fp32 attention backward against its fp32 twin, on o from K1-f32:
    "k1b", K1b-f32 on K1-f32's logsumexp (twin attention_bwd_plain with the
    same logsumexp; K1-f32's logsumexp itself within F32_REL of its twin's);
    "blocks", the decoder blocks' step with its pre-pass (twin
    mha_bwd_plain).  "all" masks every key of sample 0; "peak" makes key 5
    of sample 0 take all the weight of query 0 (its score 8 |q_0|^2 / 8
    above the others' ~1); head dim ``dh``.  A second call gives the same
    bits."""
    d = heads * dh
    q, do = _f32(1, b, lq, d), _f32(4, b, lq, d)
    k, v = _f32(2, b, lk, d), _f32(3, b, lk, d)
    mask = None
    if masked == "peak":
        k[0, 5] = 8 * q[0, 0]
    elif masked:
        keep = torch.tensor([[0 if masked == "all" else lk // 2]] + [[lk]] * (b - 1))
        mask = torch.where(torch.arange(lk)[None] >= keep, -1e30, 0.0).to(exact_f32)
    o, lse = A.fused_attention(q, k, v, heads, mask, with_lse=True)
    before = A.attention_bwd.launches_f32
    if mode == "k1b":
        _, ref_lse = A.attention_plain(q, k, v, heads, mask, with_lse=True)
        assert _rel_l2(lse, ref_lse) <= F32_REL
        call = lambda: A.attention_bwd(q, k, v, o, do, heads, mask_add=mask, lse=lse)
        ref = A.attention_bwd_plain(q, k, v, o, do, heads, lse, mask)
    else:
        call = lambda: A.attention_bwd(q, k, v, o, do, heads, bf16_casts=True, mask_add=mask)
        ref = A.mha_bwd_plain(q, k, v, do, heads, mask)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert A.attention_bwd.launches_f32 == before + 2
    _close_rel(got, ref, ("dq", "dk", "dv"))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if mode == "k1b":
        with pytest.raises(ValueError, match="logsumexp"):
            A.attention_bwd(q, k, v, o, do, heads, mask_add=mask)


def _attention_bwd_f64(q, k, v, do, heads):
    """dq, dk, dv of softmax attention in float64 (no mask)."""
    split = lambda t: t.double().reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    scale = qh.shape[-1] ** -0.5
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale, -1)
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (doh * (p @ vh)).sum(-1, keepdim=True)) * scale
    merge = lambda t: t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)
    return merge(ds @ kh), merge(ds.transpose(-1, -2) @ qh), merge(p.transpose(-1, -2) @ doh)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,dh", [(2, 64), (4, 128), (2, 128), (2, 256), (1, 512)])
def test_cuda_attention_bwd_f32_peak_against_float64(exact_f32, heads, dh):
    """K1b-f32 where key 5 of sample 0 takes all the weight of query 0 (the
    "peak" case of test_cuda_attention_bwd_f32_matches_twin), against the
    float64 backward: every gradient within F32_BWD_REL.  At dh 128 the
    peak's score is 8 |q_0|^2 / sqrt(128), about 90: there the twin on the
    kernel's logsumexp (its own scores from an fp32 matmul, P = exp(s -
    lse) with another rounding of s than the logsumexp's) reads dv about
    1.8e-5 from float64, over F32_BWD_REL, while the kernel, whose P takes
    s and the logsumexp from the same 3xTF32 products, reads about 1.4e-6;
    so at dh 128 this case is held against float64 and not the twin.  The
    blocks' mode (statistics from its own pre-pass) is held against its
    twin there too."""
    b, lq, lk, d = 2, 97, 63, heads * dh
    q, do = _f32(1, b, lq, d), _f32(4, b, lq, d)
    k, v = _f32(2, b, lk, d), _f32(3, b, lk, d)
    k[0, 5] = 8 * q[0, 0]
    o, lse = A.fused_attention(q, k, v, heads, with_lse=True)
    got = A.attention_bwd(q, k, v, o, do, heads, lse=lse)
    torch.cuda.synchronize()
    _close_rel(got, _attention_bwd_f64(q, k, v, do, heads), ("dq", "dk", "dv"))
    blocks = A.attention_bwd(q, k, v, o, do, heads, bf16_casts=True)
    _close_rel(blocks, A.mha_bwd_plain(q, k, v, do, heads), ("dq", "dk", "dv"))


@pytest.mark.cuda
def test_cuda_f32_dq_partials_are_the_wrappers(card):
    """The fp32 attention backward's launch writes as many dQ partials as
    the wrappers allocate (ops/attention.py:f32_dq_parts), at every key
    count from 1 to 4096: one per 64-key block up to 11 blocks, then at
    most 11 whatever the length."""
    from crog_tpu_torch.ops import cuda_build

    lib = cuda_build.load("attention_bwd_f32")
    got = [lib.crog_attention_f32_dq_parts(lk) for lk in range(1, 4097)]
    assert got == [A.f32_dq_parts(lk)[1] for lk in range(1, 4097)]
    assert max(got) == A.F32_MAX_DQ_PARTS


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,t,heads", [
    (24, 676, 17, 8), (3, 301, 17, 8), (1, 5, 9, 8), (9, 301, 23, 8), (10, 50, 17, 8),
    (2, 1600, 17, 8), (1, 1000, 17, 8),
    # head dims 8, 16, 32, 128, 256 and 512 at the main path's shape, and ragged
    (24, 676, 17, 64), (24, 676, 17, 32), (24, 676, 17, 16), (24, 676, 17, 4),
    (3, 301, 17, 4), (1, 65, 9, 64), (24, 676, 17, 2), (24, 676, 17, 1), (3, 301, 17, 1),
    (1, 65, 9, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_bwd_f32_kernels_match_twins(exact_f32, b, l, t, heads, rate):
    """K2b-f32 and K3b-f32 on the intermediates K2-f32 and K3-f32 saved,
    against their fp32 twins, in eval and with train-mode dropout, at the
    main path's shapes and at ragged ones: B*T text rows off the 32-row
    slices and over one 128-row tile (207, 170; their last slice loads
    zeros past the rows), B*L rows whose dW chunks end in a short one (2709:
    7 of 352 and one of 245; ops/decoder_blocks.py f32_bwd_chunks); a second
    call gives the same bits.  Over 8 heads and over 64, 32, 16, 4, 2 and 1."""
    x, txt, pos, tpos, pad, w = _f32_block(b, l, t)
    dy = _f32(99, b, l, 512)
    _, ssaved = DB.self_block_fwd(x, pos, *w, heads, 7, rate, save=True)
    _, csaved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, heads, 8, rate, save=True)
    before = DB.self_block_bwd.launches_f32, DB.cross_block_bwd.launches_f32
    cases = (
        (lambda: DB.self_block_bwd(x, ssaved, dy, heads, 7, rate),
         lambda: DB.self_block_bwd_plain(x, pos, *w, dy, heads, 7, rate),
         ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
          "d_g_post", "d_b_post")),
        (lambda: DB.cross_block_bwd(x, csaved, dy, heads, 8, rate),
         lambda: DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, heads, 8, rate),
         ("dx", "dtxt", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
          "d_g_post", "d_b_post")))
    for kern, plain, names in cases:
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        _close_rel(got, ref, names)
        assert all(torch.equal(u, v) for u, v in zip(got, again)), names
    assert (DB.self_block_bwd.launches_f32, DB.cross_block_bwd.launches_f32) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", FFN_F32_ROWS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_ffn_bwd_f32_matches_twin(exact_f32, rate, m):
    """K4b-f32 against its fp32 twin at the main path's 16224 rows and off
    the row blocks, eval and train-mode dropout, the twin on the kernel's
    ReLU decision (chip_smoke.ffn_f32_relu_decision: it differs from the
    twin's own only at pre-activations within rounding of 0); every output
    (dW1 and dW2 included), dh and hn repeat with equal bits."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    args = _ffn_f32_args(m, dy=True)
    before = FF.ffn_bwd.launches_f32
    got = FF.ffn_bwd(*args, 3, rate, with_hidden=True)
    again = FF.ffn_bwd(*args, 3, rate, with_hidden=True)
    ref = FF.ffn_bwd_plain(*args, 3, rate,
                           relu_mask=cs.ffn_f32_relu_decision(args, 3, rate))
    torch.cuda.synchronize()
    assert FF.ffn_bwd.launches_f32 == before + 3
    _close_rel(got, ref, ("dx", "dw1", "db1", "dgamma", "dbeta", "dw2", "db2"))
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65, 16224])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_ffn_bwd_f32_hn_is_the_forwards(exact_f32, rate, m):
    """K4b-f32 recomputes the hidden with K4-f32's own GEMM and epilogue and
    its LayerNorm statistics in K4-f32's order: its hn equals, bit for bit,
    the hn K4-f32 leaves in its workspace for the same inputs and seed."""
    args = _ffn_f32_args(m)
    _, hn_fwd = FF.ffn_fwd(*args, 5, rate, with_hidden=True)
    hn_bwd = FF.ffn_bwd(*args[:6], _f32(8, m, 512), 5, rate, with_hidden=True)[8]
    torch.cuda.synchronize()
    assert hn_fwd.dtype == hn_bwd.dtype == torch.float32 and hn_fwd.shape == (m, 2048)
    assert torch.equal(hn_fwd, hn_bwd)


def _autograd_calls(dev):
    """name -> (function of one fp32 leaf, the leaf's value) on ``dev``,
    every other operand seeded alike on any device."""
    f = lambda seed, *shape, std=1.0: _f32(seed, *shape, std=std, device=dev)
    d = 512
    pos, tpos, txt = f(62, 20, d, std=0.5), f(63, 5, d, std=0.5), f(61, 1, 5, d)
    pad = torch.tensor([[False, False, False, True, True]], device=dev)
    w = [f(64, 3 * d, d, std=d**-0.5), f(65, 3 * d, std=0.05), f(66, d, d, std=d**-0.5),
         f(67, d, std=0.05), 1 + f(68, d, std=0.1), f(69, d, std=0.05), 1 + f(70, d, std=0.1),
         f(71, d, std=0.05)]
    fw = (f(2, 2048, d, std=d**-0.5), f(3, 2048, std=0.05), 1 + f(4, 2048, std=0.1),
          f(5, 2048, std=0.05), f(6, d, 2048, std=2048**-0.5), f(7, d, std=0.05))
    return {
        "attention": (lambda a: A.FusedAttention.apply(a, a, a, 2), f(1, 1, 70, 128)),
        "self": (lambda a: DB.decoder_self_block(a, pos, *w, 8), f(60, 1, 20, d)),
        "cross": (lambda a: DB.decoder_cross_block(a, txt, pos, tpos, pad, *w, 8),
                  f(60, 1, 20, d)),
        "ffn": (lambda a: FF.fused_ffn(a, *fw), f(1, 20, d)),
    }


@pytest.mark.cuda
def test_cuda_fp32_autograd_runs_the_fp32_backward_kernels(exact_f32):
    """Through autograd: FusedAttention, decoder_self_block,
    decoder_cross_block and fused_ffn on fp32 leaves launch their fp32
    forward and backward kernels once each and no bf16 kernel, and each
    leaf's gradient matches the same function's on the CPU (the twins)."""
    counters = [(fn, attr) for fn in (A.fused_attention, A.attention_bwd, DB.self_block_fwd,
                                      DB.self_block_bwd, DB.cross_block_fwd,
                                      DB.cross_block_bwd, FF.ffn_fwd, FF.ffn_bwd)
                for attr in ("launches", "launches_f32")]
    before = [getattr(fn, attr) for fn, attr in counters]
    grads = {}
    for dev in ("cuda", "cpu"):
        for name, (fn, leaf) in _autograd_calls(dev).items():
            leaf.requires_grad_()
            fn(leaf).pow(2).sum().backward()
            grads.setdefault(name, []).append(leaf.grad.cpu())
    for name, (got, ref) in grads.items():
        assert _rel_l2(got, ref) <= F32_BWD_REL, name
    launched = [getattr(fn, attr) - b0 for (fn, attr), b0 in zip(counters, before)]
    assert launched == [0, 1] * 8, launched


# ---------------------------------------------------------- model widths
# K2-K4b and their fp32 builds at the decoder widths other than the
# configs' 512 (ops/decoder_blocks.py KERNEL_D): 256, 768 (CLIP RN50x16's
# text width, 12 heads of 64) and 1024 (RN50x64's, 8 heads of 128; and 16
# of 64), held as at D 512: bf16 forwards within 0.125, their saved
# intermediates and every backward output within BWD_REL, fp32 ones within
# F32_REL / F32_BWD_REL, and each call twice with equal bits (the
# out-projection's cluster of D / 256 CTAs adds its LN row sums in rank
# order)
WIDTHS = [(256, 4), (768, 12), (1024, 8), (1024, 16)]
BLOCK_GRADS = ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
               "d_g_post", "d_b_post")


def _width_block(d, seed, b=2, l=676, t=17):
    x, txt = _bf16(seed, b, l, d), _bf16(seed + 1, b, t, d)
    pos, tpos = _bf16(seed + 2, l, d, std=0.5), _bf16(seed + 3, t, d, std=0.5)
    dy = _bf16(seed + 4, b, l, d)
    lengths = torch.tensor([[1 + (t - 1) * i // max(1, b - 1)] for i in range(b)])
    pad = (torch.arange(t)[None].expand(b, t) >= lengths).to("cuda")
    return x, txt, pos, tpos, pad, dy, _block_args(seed + 10, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads", WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_kernels_at_width_match_twins_and_repeat(card, d, heads, rate):
    """K2/K2b and K3/K3b at D 256, 768 and 1024 (B 2, 676 tokens, 17 text
    keys with per-sample padding), in eval (rate 0) and with dropout: the
    forward and every saved intermediate, then every gradient output, each
    against its twin and twice with equal bits."""
    x, txt, pos, tpos, pad, dy, w = _width_block(d, 70)
    for cross in (False, True):
        if cross:
            fwd = lambda: DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, heads, 8, rate,
                                             save=True)
            ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, heads, 8, rate)
        else:
            fwd = lambda: DB.self_block_fwd(x, pos, *w, heads, 7, rate, save=True)
            ref = DB.self_block_plain(x, pos, *w, heads, 7, rate)
        (y, saved), (y2, saved2) = fwd(), fwd()
        torch.cuda.synchronize()
        assert y.shape == x.shape and (y.float() - ref.float()).abs().max().item() <= 0.125
        assert all(torch.equal(u, v) for u, v in zip((y, *saved), (y2, *saved2))), cross
        if cross:
            bwd = lambda: DB.cross_block_bwd(x, saved, dy, heads, 8, rate)
            plain = DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, heads, 8, rate)
        else:
            bwd = lambda: DB.self_block_bwd(x, saved, dy, heads, 7, rate)
            plain = DB.self_block_bwd_plain(x, pos, *w, dy, heads, 7, rate)
        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        _close_all(got, plain)
        assert all(torch.equal(u, v) for u, v in zip(got, again)), cross


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 768, 1024])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_ffn_kernels_at_width_match_twins_and_repeat(card, d, rate):
    """K4 and K4b at D 256, 768 and 1024 over 1000 rows (off the 128-row
    cluster tile): y within 0.125 and twice with equal bits; every gradient
    output within BWD_REL, and dx, dh, hn and the four column sums (db2 from
    each CTA's D / 8 columns) twice with equal bits."""
    m = 1000
    x, dy = _bf16(81, m, d), _bf16(88, m, d)
    f32 = lambda s, n, std: (torch.randn(n, generator=torch.Generator()
                                         .manual_seed(s)) * std).to(card)
    w1, b1 = _bf16(82, 2048, d, std=d**-0.5), f32(83, 2048, 0.05)
    g, be = 1 + f32(84, 2048, 0.1), f32(85, 2048, 0.05)
    w2, b2 = _bf16(86, d, 2048, std=2048**-0.5), f32(87, d, 0.05)
    y, y2 = (FF.ffn_fwd(x, w1, b1, g, be, w2, b2, 11, rate) for _ in range(2))
    ref = FF.ffn_plain(x, w1, b1, g, be, w2, b2, 11, rate)
    torch.cuda.synchronize()
    assert (y.float() - ref.float()).abs().max().item() <= 0.125 and torch.equal(y, y2)
    a, b = (FF.ffn_bwd(x, w1, b1, g, be, w2, dy, 11, rate, with_hidden=True)
            for _ in range(2))
    _close_all(a[:7], FF.ffn_bwd_plain(x, w1, b1, g, be, w2, dy, 11, rate))
    torch.cuda.synchronize()
    for i in (0, 2, 3, 4, 6, 7, 8):  # dx, db1, dgamma, dbeta, db2, dh, hn
        assert torch.equal(a[i], b[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads", WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_f32_kernels_at_width_match_twins_and_repeat(exact_f32, d, heads, rate):
    """K2-f32/K2b-f32 and K3-f32/K3b-f32 at D 256, 768 and 1024 (B 2, 676
    tokens, 17 text keys), in eval and with dropout: the forward within
    F32_REL, every gradient within F32_BWD_REL, each twice with equal
    bits."""
    x, txt, pos, tpos, pad, w = _f32_block(2, 676, 17, seed=90, d=d)
    dy = _f32(97, 2, 676, d)
    _, ssaved = DB.self_block_fwd(x, pos, *w, heads, 7, rate, save=True)
    _, csaved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, heads, 8, rate, save=True)
    cases = (
        (lambda: DB.self_block_fwd(x, pos, *w, heads, 7, rate)[0],
         lambda: DB.self_block_plain(x, pos, *w, heads, 7, rate),
         lambda: DB.self_block_bwd(x, ssaved, dy, heads, 7, rate),
         lambda: DB.self_block_bwd_plain(x, pos, *w, dy, heads, 7, rate), BLOCK_GRADS),
        (lambda: DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, heads, 8, rate)[0],
         lambda: DB.cross_block_plain(x, txt, pos, tpos, pad, *w, heads, 8, rate),
         lambda: DB.cross_block_bwd(x, csaved, dy, heads, 8, rate),
         lambda: DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, heads, 8, rate),
         BLOCK_GRADS[:1] + ("dtxt",) + BLOCK_GRADS[1:]))
    for fwd, fwd_plain, bwd, bwd_plain, names in cases:
        got, again, ref = fwd(), fwd(), fwd_plain()
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and _rel_l2(got, ref) <= F32_REL, names
        assert torch.equal(got, again)
        got, again, ref = bwd(), bwd(), bwd_plain()
        torch.cuda.synchronize()
        _close_rel(got, ref, names)
        assert all(torch.equal(u, v) for u, v in zip(got, again)), names


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 768, 1024])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_ffn_f32_kernels_at_width_match_twins_and_repeat(exact_f32, d, rate):
    """K4-f32 and K4b-f32 at D 256, 768 and 1024 over 1000 rows: the
    forward within F32_REL, every gradient within F32_BWD_REL (the twin on
    the kernel's ReLU decision), each twice with equal bits."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    args = _ffn_f32_args(1000, d=d)
    got, again, ref = (FF.fused_ffn(*args, 3, rate), FF.fused_ffn(*args, 3, rate),
                       FF.ffn_plain(*args, 3, rate))
    torch.cuda.synchronize()
    assert _rel_l2(got, ref) <= F32_REL and torch.equal(got, again)
    args = _ffn_f32_args(1000, dy=True, d=d)
    got = FF.ffn_bwd(*args, 3, rate, with_hidden=True)
    again = FF.ffn_bwd(*args, 3, rate, with_hidden=True)
    ref = FF.ffn_bwd_plain(*args, 3, rate,
                           relu_mask=cs.ffn_f32_relu_decision(args, 3, rate))
    torch.cuda.synchronize()
    _close_rel(got, ref, ("dx", "dw1", "db1", "dgamma", "dbeta", "dw2", "db2"))
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_widths_not_taken_raise_before_any_launch(card, dtype):
    """On CUDA tensors, D 640 (CLIP RN50x4's width) and D 768 over 8 heads
    (head dim 96: RN50x16 at the configs' num_head) at the blocks, and D 640
    and F 1024 at the FFN, raise before any launch: no counter moves, and
    no twin runs in their place."""
    counters = [DB.self_block_fwd, DB.cross_block_fwd, DB.self_block_bwd, DB.cross_block_bwd,
                FF.ffn_fwd, FF.ffn_bwd]
    before = [(f.launches, f.launches_f32) for f in counters]
    z = lambda *s: torch.zeros(*s, dtype=dtype, device=card)
    for d, heads, match in ((640, 8, "D 256, 512, 768 or 1024"),
                            (768, 8, "3, 6, 12, 24, 48 or 96 heads")):
        x, w = z(1, 20, d), [t.to(dtype) for t in _block_args(3, d)]
        with pytest.raises(ValueError, match=match):
            DB.self_block_fwd(x, z(20, d), *w, heads)
        with pytest.raises(ValueError, match=match):
            DB.cross_block_fwd(x, z(1, 17, d), z(20, d), z(17, d), None, *w, heads)
    for d, f in ((640, 2048), (512, 1024)):
        with pytest.raises(ValueError, match="FFN kernels take D 256, 512, 768 or 1024"):
            FF.ffn_fwd(z(8, d), z(f, d), z(f), z(f), z(f), z(d, f), z(d))
        with pytest.raises(ValueError, match="FFN kernels take D 256, 512, 768 or 1024"):
            FF.ffn_bwd(z(8, d), z(f, d), z(f), z(f), z(f), z(d, f), z(8, d))
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_f32) for f in counters] == before
