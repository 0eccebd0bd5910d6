"""The port's CUDA kernels K1-K4, K1b-K4b and SSG's K5/K5b against their
plain PyTorch twins, on a card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (the
kernels have no CPU mode).  This file imports neither jax nor crog_tpu, so
it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerances: kernel and twin are both bf16 with the same cast points, so
they differ only where a reordered f32 sum flips one bf16 rounding of an
intermediate: 3e-2 on attention outputs of magnitude ~1.5, 0.125 (four bf16
steps at magnitude 4-8) on the blocks' and FFN's outputs of magnitude ~6.
The forwards with dropout draw the same counter-based mask in kernel and
twin and are held alike.  Backward outputs are held to 2^-6 of each
gradient's largest magnitude (four bf16 steps: a flipped rounding of an
intermediate such as P, dS or dh feeds many outputs).  K1b rounds only its
outputs, as its twin does, so it is held to one bf16 step (2^-8 of the
largest magnitude) with at most 1% of the elements differing at all, as in
chip_smoke.py.  K5/K5b and their twins are f32 with the same products, so
each output is held to 1e-4 of its largest magnitude.
"""

import pytest
import torch

from crog_tpu_torch.ops import attention as A
from crog_tpu_torch.ops import decoder_blocks as DB
from crog_tpu_torch.ops import ffn as FF
from crog_tpu_torch.ops import lincomb as LC

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(seed, *shape, std=1.0, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * std).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("l,lk,masked", [(169, 169, False), (676, 17, True), (70, 300, True)])
def test_cuda_attention_kernel_matches_twin(card, l, lk, masked):
    q, k, v = _bf16(1, 2, l, 512), _bf16(2, 2, lk, 512), _bf16(3, 2, lk, 512)
    mask = None
    if masked:
        mask = torch.where(torch.arange(lk)[None] >= torch.tensor([[lk // 2], [lk]]),
                           -1e30, 0.0).to(card)
    got = A.fused_attention(q, k, v, 8, mask)
    ref = A.attention_plain(q, k, v, 8, mask)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= 3e-2  # bf16 steps


def _block_args(seed, d=512, device="cuda"):
    f32 = lambda s, *shape, std: (torch.randn(*shape, generator=torch.Generator()
                                              .manual_seed(s)) * std).to(device)
    return [_bf16(seed, 3 * d, d, std=d**-0.5), f32(seed + 1, 3 * d, std=0.05),
            _bf16(seed + 2, d, d, std=d**-0.5), f32(seed + 3, d, std=0.05),
            1 + f32(seed + 4, d, std=0.1), f32(seed + 5, d, std=0.05),
            1 + f32(seed + 6, d, std=0.1), f32(seed + 7, d, std=0.05)]


@pytest.mark.cuda
def test_cuda_block_kernels_match_twins(card):
    x, txt = _bf16(1, 2, 676, 512), _bf16(2, 2, 17, 512)
    pos, tpos = _bf16(3, 676, 512, std=0.5), _bf16(4, 17, 512, std=0.5)
    pad = torch.arange(17, device=card)[None].expand(2, 17) >= torch.tensor(
        [[9], [17]], device=card)
    w = _block_args(10)
    got = DB.decoder_self_block(x, pos, *w, 8)
    ref = DB.self_block_plain(x, pos, *w, 8)
    assert (got.float() - ref.float()).abs().max().item() <= 0.125
    got = DB.decoder_cross_block(x, txt, pos, tpos, pad, *w, 8)
    ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, 8)
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
def test_cuda_attention_backward_matches_twin(card):
    q, k, v, do = (_bf16(s, 2, 169, 512) for s in (1, 2, 3, 4))
    o = A.fused_attention(q, k, v, 8)
    got = A.attention_bwd(q, k, v, o, do, 8)
    ref = A.attention_bwd_plain(q, k, v, o, do, 8)
    torch.cuda.synchronize()
    _close_all(got, ref, K1B_REL, K1B_SHARE)
    with pytest.raises(ValueError, match="head dim 64"):
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
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_block_kernels_train_mode_match_twins(card, rate):
    """Forward with dropout and backward, self and cross block (a padded
    key mask), L=676 as on the main path."""
    x, txt = _bf16(1, 2, 676, 512), _bf16(2, 2, 17, 512)
    pos, tpos = _bf16(3, 676, 512, std=0.5), _bf16(4, 17, 512, std=0.5)
    dy = _bf16(5, 2, 676, 512)
    pad = torch.arange(17, device=card)[None].expand(2, 17) >= torch.tensor(
        [[9], [17]], device=card)
    w = _block_args(10)
    y, saved = DB.self_block_fwd(x, pos, *w, 8, 7, rate, save=True)
    assert (y.float() - DB.self_block_plain(x, pos, *w, 8, 7, rate).float()).abs().max() <= 0.125
    _close_all(DB.self_block_bwd(x, saved, dy, 8, 7, rate),
               DB.self_block_bwd_plain(x, pos, *w, dy, 8, 7, rate))
    y, saved = DB.cross_block_fwd(x, txt, pos, tpos, pad, *w, 8, 8, rate, save=True)
    ref = DB.cross_block_plain(x, txt, pos, tpos, pad, *w, 8, 8, rate)
    assert (y.float() - ref.float()).abs().max() <= 0.125
    _close_all(DB.cross_block_bwd(x, saved, dy, 8, 8, rate),
               DB.cross_block_bwd_plain(x, txt, pos, tpos, pad, *w, dy, 8, 8, rate))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="512"):
        DB.self_block_bwd(x[..., :256].contiguous(), saved, dy, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_ffn_train_mode_matches_twin(card, rate):
    x, dy = _bf16(1, 1000, 512), _bf16(8, 1000, 512)
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
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="D=512, F=2048"):
        FF.ffn_bwd(x, w1[:1024], b1[:1024], g[:1024], be[:1024], w2[:, :1024], dy)


LINCOMB_REL = 1e-4  # both f32; only the order of the pixel and column sums differs


@pytest.mark.cuda
@pytest.mark.parametrize("kind,t", [("bce", 1), ("smooth_l1", 4)])
def test_cuda_lincomb_kernels_match_twins(card, kind, t):
    """K5 and K5b against their twins on ragged shapes: 40x44 pixels (not a
    multiple of the 128-pixel chunk), 37 anchors (kt not a multiple of the
    32-column tile), T*M = 8 rows, two anchors whose boxes lie off the map
    (empty crops); the results are the same in a second run."""
    b, ph, pw, k, m = 2, 40, 44, 37, 8 // t
    g = torch.Generator().manual_seed(t)
    protos = torch.relu(torch.randn(b, ph, pw, 32, generator=g))
    coef = torch.tanh(torch.randn(b, k, t, 32, generator=g))
    ds = torch.rand(b, t * m, ph * pw, generator=g)
    if kind == "bce":
        ds = (ds > 0.5).float()
    lo = torch.rand(b, k, 2, generator=g) * 0.7
    box = torch.cat([lo, lo + 0.05 + 0.25 * torch.rand(b, k, 2, generator=g)], -1)
    box[:, :2] = torch.tensor([1.2, 1.2, 1.5, 1.5])
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
    assert (got[1][:, :2 * t] == 0).all()  # an empty crop takes no gradient
    with pytest.raises(ValueError, match="int32"):
        LC.lincomb_fwd(*args[:3], args[3].long(), args[4], t, loss_kind=kind)
    with pytest.raises(ValueError, match="prototypes"):
        LC.lincomb_fwd(args[0][..., :16].contiguous(), args[1][..., :16].contiguous(),
                       *args[2:], t, loss_kind=kind)
