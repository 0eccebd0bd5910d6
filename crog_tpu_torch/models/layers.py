"""CROG fusion layers: cross-modal FPN neck, vision-language transformer
decoder, and the language-conditioned projectors.

Counterpart of crog_tpu/models/layers.py.  Module names follow the reference
torch key schema (reference model/layers.py); tensors are NHWC.  On a CUDA
tensor the decoder layer runs its attention blocks and FFN through the
hand-written kernels K2, K3 and K4 (and their backward kernels) whenever
``d_model % 128 == 0 and dim_ffn % 128 == 0``, as the JAX package runs its
Pallas kernels on a TPU.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn

from crog_tpu_torch.models.clip import AvgPool, BatchNorm, Conv2d, LayerNormFp32
from crog_tpu_torch.ops.attention import Linear, MultiheadAttention
from crog_tpu_torch.ops.decoder_blocks import (
    cross_block_plain,
    decoder_cross_block,
    decoder_self_block,
    self_block_plain,
)
from crog_tpu_torch.ops.dropout import apply_dropout, draw_seed
from crog_tpu_torch.ops.dynconv import dynamic_group_conv_fused
from crog_tpu_torch.ops.ffn import ffn_plain, fused_ffn
from crog_tpu_torch.ops.resize import upsample2x_bilinear


def conv_layer(in_dim: int, out_dim: int, kernel_size: int = 1, padding: int = 0,
               stride: int = 1) -> nn.Sequential:
    """Bias-free conv + BN + ReLU (reference model/layers.py:8-12)."""
    return nn.Sequential(
        Conv2d(in_dim, out_dim, kernel_size, stride, padding, bias=False),
        BatchNorm(out_dim),
        nn.ReLU(),
    )


def linear_layer(in_dim: int, out_dim: int) -> nn.Sequential:
    """Bias-free linear + BN + ReLU (reference model/layers.py:14-16)."""
    return nn.Sequential(
        Linear(in_dim, out_dim, bias=False), BatchNorm(out_dim), nn.ReLU()
    )


class CoordConv(nn.Module):
    """Append normalized xy grids then conv (reference model/layers.py:19-44)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv1 = conv_layer(in_channels + 2, out_channels, kernel_size, padding)

    def forward(self, x):
        b, h, w, _ = x.shape
        xr = torch.linspace(-1.0, 1.0, w, device=x.device)
        yr = torch.linspace(-1.0, 1.0, h, device=x.device)
        gy, gx = torch.meshgrid(yr, xr, indexing="ij")
        coord = torch.stack([gx, gy], dim=-1)[None].expand(b, h, w, 2)
        return self.conv1(torch.cat([x, coord.to(x.dtype)], dim=-1))


class FPN(nn.Module):
    """Cross-modal FPN (reference model/layers.py:342-398): fuses v3, v4, v5
    with the text state; text-gated f5, top-down concat fusion, 3-way
    aggregation, CoordConv.  NHWC in and out."""

    def __init__(self, in_channels=(512, 1024, 1024), out_channels=(256, 512, 1024)):
        super().__init__()
        c3, c4, c5 = out_channels
        self.txt_proj = linear_layer(in_channels[2], c5)
        self.f1_v_proj = conv_layer(in_channels[2], c5, 1, 0)
        self.norm_layer = nn.Sequential(BatchNorm(c5), nn.ReLU())
        self.f2_v_proj = conv_layer(in_channels[1], c4, 3, 1)
        self.f2_cat = conv_layer(c4 + c5, c4, 1, 0)
        self.f3_v_proj = conv_layer(in_channels[0], c3, 3, 1)
        self.f3_cat = conv_layer(c3 + c4, c4, 1, 0)
        self.f4_proj5 = conv_layer(c5, c4, 3, 1)
        self.f4_proj4 = conv_layer(c4, c4, 3, 1)
        self.f4_proj3 = conv_layer(c4, c4, 3, 1)
        self.aggr = conv_layer(3 * c4, c4, 1, 0)
        self.coordconv = nn.Sequential(
            CoordConv(c4, c4, 3, 1), conv_layer(c4, c4, 3, 1)
        )
        self.pool = AvgPool(2)

    def forward(self, imgs, state):
        v3, v4, v5 = imgs
        # fusion 1
        s = self.txt_proj(state)
        f5 = self.f1_v_proj(v5) * s[:, None, None, :]
        f5 = self.norm_layer(f5)
        # fusion 2
        f4 = self.f2_v_proj(v4)
        f4 = self.f2_cat(torch.cat([f4, upsample2x_bilinear(f5)], dim=-1))
        # fusion 3
        f3 = self.pool(self.f3_v_proj(v3))
        f3 = self.f3_cat(torch.cat([f3, f4], dim=-1))
        # fusion 4 + aggregation
        fq5 = upsample2x_bilinear(self.f4_proj5(f5))
        fq4 = self.f4_proj4(f4)
        fq3 = self.f4_proj3(f3)
        fq = self.aggr(torch.cat([fq3, fq4, fq5], dim=-1))
        return self.coordconv(fq)


@lru_cache(maxsize=None)
def _pos1d(d_model: int, length: int) -> np.ndarray:
    """Fixed 1-D sin/cos encoding (reference model/layers.py:195-212)."""
    pe = np.zeros((length, d_model), np.float32)
    position = np.arange(length)[:, None].astype(np.float64)
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@lru_cache(maxsize=None)
def _pos2d(d_model: int, height: int, width: int) -> np.ndarray:
    """Fixed 2-D sin/cos encoding, returned as [H*W, d_model] (reference
    model/layers.py:214-241)."""
    if d_model % 4 != 0:
        raise ValueError(f"d_model must be divisible by 4, got {d_model}")
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    div_term = np.exp(
        np.arange(0.0, half, 2, dtype=np.float64) * -(math.log(10000.0) / half)
    )
    pos_w = np.arange(0.0, width)[:, None].astype(np.float64)
    pos_h = np.arange(0.0, height)[:, None].astype(np.float64)
    sw = np.sin(pos_w * div_term).T  # (half/2, W)
    cw = np.cos(pos_w * div_term).T
    sh = np.sin(pos_h * div_term).T  # (half/2, H)
    ch = np.cos(pos_h * div_term).T
    pe[0:half:2, :, :] = np.repeat(sw[:, None, :], height, axis=1)
    pe[1:half:2, :, :] = np.repeat(cw[:, None, :], height, axis=1)
    pe[half::2, :, :] = np.repeat(sh[:, :, None], width, axis=2)
    pe[half + 1 :: 2, :, :] = np.repeat(ch[:, :, None], width, axis=2)
    return pe.reshape(d_model, height * width).T


class TransformerDecoderLayer(nn.Module):
    """Pre-LN self-attn / cross-attn / FFN layer (reference
    model/layers.py:280-339).  In train mode dropout acts inside the two
    attention blocks and the FFN (as in the fused kernels) and once more on
    the FFN output (``d3``), each with its own seed drawn from the caller's
    ``generator``."""

    def __init__(self, d_model: int = 512, nhead: int = 8, dim_ffn: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.nhead = nhead
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.ffn = nn.Sequential(
            Linear(d_model, dim_ffn), nn.ReLU(), nn.Dropout(dropout),
            LayerNormFp32(dim_ffn), Linear(dim_ffn, d_model),
        )
        self.norm1 = LayerNormFp32(d_model)
        self.norm2 = LayerNormFp32(d_model)
        self.norm3 = LayerNormFp32(d_model)
        self.self_attn_norm = LayerNormFp32(d_model)
        self.cross_attn_norm = LayerNormFp32(d_model)
        self.fuse = d_model % 128 == 0 and dim_ffn % 128 == 0
        self.rate = dropout

    def forward(self, vis, txt, vis_pos, txt_pos, pad_mask, generator=None):
        rate = self.rate if self.training else 0.0
        seeds = [0] * 4
        if rate > 0.0:
            if generator is None:
                raise ValueError(
                    "train-mode dropout draws its seeds from an explicit "
                    "torch.Generator: pass generator="
                )
            seeds = [draw_seed(generator) for _ in range(4)]
        if self.fuse:
            self_blk, cross_blk, ffn = decoder_self_block, decoder_cross_block, fused_ffn
        else:
            self_blk, cross_blk, ffn = self_block_plain, cross_block_plain, ffn_plain
        sa, ca = self.self_attn, self.multihead_attn
        vis = self_blk(
            vis, vis_pos, sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight,
            sa.out_proj.bias, self.norm1.weight, self.norm1.bias,
            self.self_attn_norm.weight, self.self_attn_norm.bias, self.nhead,
            seeds[0], rate,
        )
        vis = cross_blk(
            vis, txt, vis_pos, txt_pos, pad_mask, ca.in_proj_weight,
            ca.in_proj_bias, ca.out_proj.weight, ca.out_proj.bias,
            self.norm2.weight, self.norm2.bias, self.cross_attn_norm.weight,
            self.cross_attn_norm.bias, self.nhead, seeds[1], rate,
        )
        b, l, c = vis.shape
        fc1, ln, fc2 = self.ffn[0], self.ffn[3], self.ffn[4]
        y = ffn(self.norm3(vis).reshape(b * l, c), fc1.weight, fc1.bias,
                ln.weight, ln.bias, fc2.weight, fc2.bias, seeds[2], rate)
        return vis + apply_dropout(y.reshape(b, l, c), seeds[3], rate)


class TransformerDecoder(nn.Module):
    """Stack of decoder layers with fixed sin/cos positions (reference
    model/layers.py:176-277).  vis [B,H,W,C], txt [B,L,C], pad [B,L] ->
    [B,H,W,C]."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_ffn: int,
                 dropout: float):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, nhead, dim_ffn, dropout)
            for _ in range(num_layers)
        ])
        self.norm = LayerNormFp32(d_model)

    def forward(self, vis, txt, pad_mask, generator=None):
        b, h, w, c = vis.shape
        l = txt.shape[1]
        vis_pos = torch.from_numpy(_pos2d(c, h, w)).to(vis.device)
        txt_pos = torch.from_numpy(_pos1d(txt.shape[-1], l)).to(vis.device)
        x = vis.reshape(b, h * w, c)
        for layer in self.layers:
            x = layer(x, txt, vis_pos, txt_pos, pad_mask, generator)
        return self.norm(x).reshape(b, h, w, c)


class MultiTaskProjector(nn.Module):
    """Decode fq to ``num_tasks`` maps via a language-conditioned dynamic
    conv (reference model/layers.py:47-173).  fq [B,26,26,512] -> vis tower
    -> [B,104,104,256]; the text state generates a per-sample 3x3 kernel +
    bias applied to every task's channels.  Returns [B,104,104,T] fp32
    logits (mask, qua, sin, cos, wid for T=5)."""

    def __init__(self, word_dim: int = 1024, in_dim: int = 256,
                 kernel_size: int = 3, num_tasks: int = 5):
        super().__init__()
        self.in_dim = in_dim
        self.kernel_size = kernel_size
        self.num_tasks = num_tasks
        self.vis = nn.Sequential(
            nn.Upsample(scale_factor=2),  # index 0: applied by forward
            conv_layer(in_dim * 2, in_dim * 2, 3, padding=1),
            nn.Upsample(scale_factor=2),  # index 2: applied by forward
            conv_layer(in_dim * 2, in_dim, 3, padding=1),
            nn.Conv2d(in_dim, in_dim * num_tasks, 1),
        )
        self.txt = Linear(word_dim, in_dim * kernel_size * kernel_size + 1)

    def forward(self, x, word):
        x = self.vis[1](upsample2x_bilinear(x))
        x = self.vis[3](upsample2x_bilinear(x))
        w = self.txt(word)
        weight, bias = w[:, :-1], w[:, -1]
        k = self.kernel_size
        weight = weight.reshape(w.shape[0], self.in_dim, k, k)
        # the 1x1 vis[4] conv is folded into the dynamic conv
        out = self.vis[4]
        return dynamic_group_conv_fused(
            x, out.weight, out.bias, weight, bias.float(), self.num_tasks
        )


class Projector(MultiTaskProjector):
    """Single-mask variant (reference model/layers.py:135-173)."""

    def __init__(self, word_dim: int = 1024, in_dim: int = 256,
                 kernel_size: int = 3, num_tasks: int = 1):
        super().__init__(word_dim, in_dim, kernel_size, num_tasks)
