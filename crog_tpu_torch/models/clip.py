"""CLIP RN50 dual encoder in PyTorch.

Counterpart of crog_tpu/models/clip.py: a ModifiedResNet vision tower
(3-conv stem, anti-aliased bottlenecks, attention pooling that keeps the
spatial map) emitting (x2, x3, x4-pooled), and a causal text transformer
returning per-token features plus the projected EOT sentence embedding.

Module and parameter names follow the reference torch CLIP (model/clip.py),
so a reference state_dict loads with plain ``load_state_dict``.  Tensors are
NHWC at every public boundary, as in the JAX package; each conv runs on an
NCHW view of the NHWC tensor (channels-last memory, no copy).

Precision: parameters are fp32; the compute dtype is the dtype of the input
(bf16 on the card).  Convs and Linears cast their weights to it; BatchNorm
and LayerNorm compute in fp32 and cast back, as the flax modules do.  Only
inference is ported: BatchNorm always uses its running statistics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from crog_tpu_torch.ops.attention import Linear, MultiheadAttention, attention_core
from crog_tpu_torch.ops.resize import resize_bicubic


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Conv2d(nn.Conv2d):
    """nn.Conv2d over NHWC tensors, computing in the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm over the last axis with the running statistics,
    computed in fp32 (eps 1e-5) and cast back to the input dtype."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm belongs to the training slice of the port"
            )
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(x.dtype)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm in fp32 with flax's fast variance E[x^2] - E[x]^2, cast
    back to the input dtype."""

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = (mu2 - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class AvgPool(nn.Module):
    """k x k average pool, stride k, over NHWC."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, x):
        if self.k == 1:
            return x
        return F.avg_pool2d(x.permute(0, 3, 1, 2), self.k).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck (reference model/clip.py:10-57): all
    convs stride 1; an avgpool follows conv2 (and prefixes the downsample
    path) when stride > 1."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.avgpool = AvgPool(stride)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", AvgPool(stride)),
                ("0", Conv2d(inplanes, planes * 4, 1, bias=False)),
                ("1", BatchNorm(planes * 4)),
            ]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Spatial attention pooling that keeps the spatial map (reference
    model/clip.py:60-144): q=k=v = features + bicubic-resized positional
    embedding, global MHA over all positions, plus a conv+BN residual
    ``connect``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim**2 + 1, embed_dim) / embed_dim**0.5
        )
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)
        self.connect = nn.Sequential(
            Conv2d(embed_dim, output_dim, 1, bias=False), BatchNorm(output_dim)
        )

    def forward(self, x):
        b, h, w, c = x.shape
        res = self.connect(x)
        s = self.spacial_dim
        grid = self.positional_embedding[1:].reshape(s, s, c)
        if (h, w) != (s, s):
            grid = resize_bicubic(grid, (h, w), align_corners=False)
        tokens = x.reshape(b, h * w, c) + grid.reshape(1, h * w, c).to(x.dtype)
        q = self.q_proj(tokens)
        k = self.k_proj(tokens)
        v = self.v_proj(tokens)
        out = self.c_proj(attention_core(q, k, v, self.num_heads))
        return F.relu(out.reshape(b, h, w, -1) + res)


class ModifiedResNet(nn.Module):
    """Reference model/clip.py:147-223 with the plain 3-conv stem; returns
    (x2, x3, x4_attnpooled)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(width)
        self.avgpool = AvgPool(2)
        self._inplanes = width
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
        self.attnpool = AttentionPool2d(
            input_resolution // 32, width * 32, heads, output_dim
        )

    def _make_layer(self, planes: int, blocks: int, stride: int = 1):
        mods = [Bottleneck(self._inplanes, planes, stride)]
        self._inplanes = planes * Bottleneck.expansion
        mods += [Bottleneck(self._inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        x = self.layer1(x)
        x2 = self.layer2(x)
        x3 = self.layer3(x2)
        x4 = self.attnpool(self.layer4(x3))
        return x2, x3, x4


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with QuickGELU (reference model/clip.py:239-265)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = MultiheadAttention(d_model, n_head)
        self.ln_1 = LayerNormFp32(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Linear(d_model, d_model * 4)),
            ("gelu", _QuickGELU()),
            ("c_proj", Linear(d_model * 4, d_model)),
        ]))
        self.ln_2 = LayerNormFp32(d_model)

    def forward(self, x, attn_mask=None):
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, attn_mask=attn_mask)
        return x + self.mlp(self.ln_2(x))


class _QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads) for _ in range(layers)]
        )

    def forward(self, x, attn_mask=None):
        for blk in self.resblocks:
            x = blk(x, attn_mask)
        return x


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (reference model/clip.py:424-430)."""
    mask = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(mask, diagonal=1)


class CLIPRN50(nn.Module):
    """Dual encoder; field names mirror what the reference's build_model
    infers from a checkpoint (model/clip.py:503-546).  ``dtype`` is the
    compute dtype."""

    def __init__(self, embed_dim: int = 1024, image_resolution: int = 224,
                 vision_layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
                 vision_width: int = 64, context_length: int = 77,
                 vocab_size: int = 49408, transformer_width: int = 512,
                 transformer_heads: int = 8, transformer_layers: int = 12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.visual = ModifiedResNet(
            vision_layers, embed_dim, vision_width * 32 // 64,
            image_resolution, vision_width,
        )
        self.transformer = Transformer(
            transformer_width, transformer_layers, transformer_heads
        )
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, transformer_width)
        )
        self.ln_final = LayerNormFp32(transformer_width)
        self.text_projection = nn.Parameter(torch.empty(transformer_width, embed_dim))
        # unused here; kept so reference checkpoints load strictly
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        nn.init.normal_(self.positional_embedding, std=0.01)
        nn.init.normal_(self.text_projection, std=transformer_width**-0.5)

    def encode_image(self, image):
        return self.visual(image.to(self.dtype))

    def encode_text(self, text):
        """text [B, L] int token ids, zero-padded; EOT has the max id."""
        b, l = text.shape
        x = self.token_embedding.weight[text].to(self.dtype)
        x = x + self.positional_embedding[:l].to(self.dtype)
        x = self.transformer(x, causal_mask(l, text.device))
        x = self.ln_final(x)
        eot = torch.argmax(text, dim=-1)
        state = x[torch.arange(b, device=text.device), eot]
        return x, state @ self.text_projection.to(self.dtype)

    def forward(self, image, text):
        return self.encode_image(image), *self.encode_text(text)
