"""The port's CUDA kernels K1-K4 against their plain PyTorch twins, on a card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (the
kernels have no CPU mode).  This file imports neither jax nor crog_tpu, so
it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerances: kernel and twin are both bf16 with the same cast points, so
they differ only where a reordered f32 sum flips one bf16 rounding of an
intermediate: 3e-2 on attention outputs of magnitude ~1.5, 0.125 (four bf16
steps at magnitude 4-8) on the blocks' and FFN's outputs of magnitude ~6.
"""

import pytest
import torch

from crog_tpu_torch.ops import attention as A
from crog_tpu_torch.ops import decoder_blocks as DB
from crog_tpu_torch.ops import ffn as FF

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
