"""CLIP dual encoders in PyTorch: RN50 and the ViT family.

Counterpart of crog_tpu/models/clip.py: a ModifiedResNet vision tower
(3-conv stem, anti-aliased bottlenecks, attention pooling that keeps the
spatial map) emitting (x2, x3, x4-pooled), or a VisionTransformer tower
emitting projected patch tokens (``CLIPViT``, the checkpoint family the
reference's build_model also accepts; CROG builds RN50 only), and a causal
text transformer returning per-token features plus the projected EOT
sentence embedding.

Module and parameter names follow the reference torch CLIP (model/clip.py),
so a reference state_dict loads with plain ``load_state_dict``.  Tensors are
NHWC at every public boundary, as in the JAX package; each conv runs on an
NCHW view of the NHWC tensor (channels-last memory, no copy).

Precision: parameters are fp32; the compute dtype is the dtype of the input
(bf16 on the card).  Convs and Linears cast their weights to it; BatchNorm
and LayerNorm compute in fp32 and cast back, as the flax modules do.
BatchNorm follows ``self.training``: batch statistics and a running-average
update in train mode, the running statistics in eval mode.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from crog_tpu_torch.ops.attention import Linear, MultiheadAttention, attention_core
from crog_tpu_torch.ops.resize import resize_bicubic
from crog_tpu_torch.ops.s2d import (
    block_kernel_s1,
    block_kernel_s2,
    block_mean,
    space_to_depth,
)
from crog_tpu_torch.ops.s2dconv import blocked_conv3x3_s1
from crog_tpu_torch.parallel.dist import all_reduce_sum, replayed_sum, world


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Conv2d(nn.Conv2d):
    """nn.Conv2d over NHWC tensors, computing in the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class _RematFrame:
    """What the BatchNorms of one checkpointed bottleneck share between its
    forward and its recompute: the recompute (``replay``) updates no
    running statistic and, under a process group of world > 1, reads the
    all-reduced sums of the forward (``sums``, in call order) instead of
    reducing again."""

    def __init__(self):
        self.replay = False
        self.sums = []
        self.at = 0

    @contextlib.contextmanager
    def run(self, replay: bool, inner):
        """``inner`` (a checkpoint context) with this frame current on this
        thread (the recompute runs on the autograd engine's)."""
        prev = _REMAT.frame
        _REMAT.frame, self.replay, self.at = self, replay, 0
        try:
            with inner:
                yield
        finally:
            _REMAT.frame = prev


class _RematState(threading.local):
    frame = None  # the _RematFrame of the bottleneck running on this thread


_REMAT = _RematState()


def _replaying() -> bool:
    return _REMAT.frame is not None and _REMAT.frame.replay


def _reduced(sums: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum(sums)``; in a checkpointed bottleneck's recompute,
    the value its forward reduced (``replayed_sum``)."""
    frame = _REMAT.frame
    if frame is None:
        return all_reduce_sum(sums)
    if frame.replay:
        frame.at += 1
        return replayed_sum(sums, frame.sums[frame.at - 1])
    total = all_reduce_sum(sums)
    frame.sums.append(total.detach())
    return total


def batch_moments(xf: torch.Tensor, blocks: int = 1):
    """Per-channel (E[x], E[x^2]) of ``xf`` [..., blocks * c] over every
    axis but the last and over the ``blocks`` slot groups of the last: of
    this process's batch, or under a process group of world > 1 of every
    rank's, from [sum x, sum x^2, count] summed over the ranks by a
    differentiable all-reduce (so dx also carries the other ranks' terms)."""
    dims = tuple(range(xf.dim() - 1))
    if world() == 1:
        m1, m2 = xf.mean(dims), (xf * xf).mean(dims)
        if blocks == 1:
            return m1, m2
        return m1.reshape(blocks, -1).mean(0), m2.reshape(blocks, -1).mean(0)
    c = xf.shape[-1] // blocks
    count = xf.new_full((1,), xf.numel() // c)
    sums = _reduced(torch.cat([xf.sum(dims).reshape(blocks, c).sum(0),
                               (xf * xf).sum(dims).reshape(blocks, c).sum(0),
                               count]))
    return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]


def _update_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """The running-average update of a train-mode forward; none in a
    checkpointed bottleneck's recompute, so each statistic moves once."""
    if _replaying():
        return
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked += 1


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the last axis (NHWC or [B, C]), computed in fp32 (eps
    1e-5) and cast back to the input dtype.

    Train mode is flax ``nn.BatchNorm(momentum=0.9)``: batch statistics in
    f32 with the fast variance E[x^2] - E[x]^2 clipped at 0, and running
    statistics updated with that *biased* variance (torch momentum 0.1 is
    flax momentum 0.9), where ``nn.BatchNorm2d`` would store the unbiased
    one.  Under a process group of world > 1 the statistics are the global
    batch's (``batch_moments``), as on the JAX package's mesh.  Eval mode
    uses the running statistics."""

    def forward(self, x):
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean) * mul + self.bias
            return y.to(x.dtype)
        xf = x.float()
        mean, sq = batch_moments(xf)
        var = (sq - mean * mean).clamp_min(0.0)
        _update_running(self, mean, var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def blocked_bn_relu(bn: BatchNorm, x: torch.Tensor, c: int) -> torch.Tensor:
    """``bn`` then ReLU over a 2x2-blocked tensor [..., 4c] (slot-major):
    statistics per original channel over batch, space and the four slots
    (crog_tpu/models/clip.py:136 ``_blocked_bn_relu``), i.e. ``bn`` of the
    un-blocked tensor, with the same running update."""
    if bn.training:
        mean, sq = batch_moments(x.float(), blocks=4)
        var = (sq - mean * mean).clamp_min(0.0)
        _update_running(bn, mean, var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x.float() - mean.repeat(4)) * mul.repeat(4) + bn.bias.repeat(4)
    return F.relu(y.to(x.dtype))


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's [co, ci, 3, 3] weight as the JAX package's [3, 3, ci, co]."""
    return conv.weight.permute(2, 3, 1, 0)


def _conv_blocked(x: torch.Tensor, k: torch.Tensor, pad) -> torch.Tensor:
    """Stride-1 conv of NHWC x with the blocked HWIO kernel k, padding
    ((top, bottom), (left, right)), in x's dtype."""
    (top, bottom), (left, right) = pad
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    return F.conv2d(xp, k.permute(3, 2, 0, 1).to(x.dtype)).permute(0, 2, 3, 1)


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


REMAT_MODES = (False, True, "selective")


def remat_mode(remat):
    """``remat`` if it is one of ``REMAT_MODES`` (crog_tpu's ``False``,
    ``True`` or ``"selective"``); anything else raises."""
    if isinstance(remat, bool) or remat == "selective":
        return remat
    raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")


def _save_convs(ctx, op, *args, **kwargs):
    """Selective remat's policy: keep the conv outputs (crog_tpu's
    ``"bottleneck_conv"`` names), recompute every other op."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(block: Bottleneck, x: torch.Tensor, remat) -> torch.Tensor:
    """``block(x)`` under activation checkpointing (non-reentrant): full
    remat saves ``x`` and recomputes the block in the backward; selective
    saves its conv outputs too and recomputes the rest (the permutes, the
    fp32 casts, BatchNorm, ReLU, the avgpool).  The recompute updates no
    running statistic and issues no forward all-reduce (``_RematFrame``);
    the backward runs through the forward's own graph, so the gradient
    through the batch statistics is kept."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    def contexts():
        frame = _RematFrame()
        if remat == "selective":
            fwd, again = create_selective_checkpoint_contexts(_save_convs)
        else:
            fwd, again = contextlib.nullcontext(), contextlib.nullcontext()
        return frame.run(False, fwd), frame.run(True, again)

    return checkpoint(block, x, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)


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
    """Reference model/clip.py:147-223; returns (x2, x3, x4_attnpooled).

    ``stem_s2d`` runs the 3-conv stem in the space-to-depth domain
    (crog_tpu/models/clip.py:306 ``_stem_s2d``) on the same modules, so the
    state_dict is unchanged: the image is blocked 4x4, conv1 becomes one
    stride-1 conv with ``block_kernel_s2`` of its weight, conv2 and conv3
    stride-1 convs of 2x2-blocked tensors, the BatchNorms reduce over the
    block slots too, and the pool is ``block_mean``.  ``fused_stem`` (the
    counterpart of CROG_FUSED_STEM=1) runs conv2 and conv3 through
    ``blocked_conv3x3_s1``, the gathered K6/K6b kernels on the card, in
    bf16 or, at ``compute_dtype: float32``, K6-f32/K6b-f32 (3xTF32): the
    JAX package hands that op the stem's activations in either dtype.
    Without it they are ``F.conv2d`` with ``block_kernel_s1`` of the weight.
    An input whose H or W is not a multiple of 4 takes the plain stem.

    ``remat`` (crog_tpu/models/clip.py:377 ``remat``): ``True`` checkpoints
    every bottleneck of layer1-layer4, ``"selective"`` keeps their conv
    outputs (``checkpointed``); the stem and the attention pool are never
    recomputed, and an eval-mode or no-grad forward is not checkpointed."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 stem_s2d: bool = False, fused_stem: bool = False, remat=False):
        super().__init__()
        self.width = width
        self.stem_s2d = stem_s2d
        self.fused_stem = fused_stem
        self.remat = remat_mode(remat)
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

    def _stem_plain(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        return self.avgpool(x)

    def _conv_s1(self, x, conv):
        if self.fused_stem:
            return blocked_conv3x3_s1(x, _hwio(conv))
        return _conv_blocked(x, block_kernel_s1(_hwio(conv)), ((1, 1), (1, 1)))

    def _stem_s2d(self, x):
        w, h = self.width, self.width // 2
        x = _conv_blocked(space_to_depth(x, 4), block_kernel_s2(_hwio(self.conv1)),
                          ((1, 0), (1, 0)))
        x = blocked_bn_relu(self.bn1, x, h)
        x = blocked_bn_relu(self.bn2, self._conv_s1(x, self.conv2), h)
        x = blocked_bn_relu(self.bn3, self._conv_s1(x, self.conv3), w)
        return block_mean(x, w)

    def forward(self, x):
        if self.stem_s2d and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0:
            x = self._stem_s2d(x)
        else:
            x = self._stem_plain(x)
        x = self._layer(self.layer1, x)
        x2 = self._layer(self.layer2, x)
        x3 = self._layer(self.layer3, x2)
        x4 = self.attnpool(self._layer(self.layer4, x3))
        return x2, x3, x4

    def _layer(self, layer: nn.Sequential, x):
        remat = remat_mode(self.remat)
        if not (remat and self.training and torch.is_grad_enabled()):
            return layer(x)
        for block in layer:
            x = checkpointed(block, x, remat)
        return x


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


class VisionTransformer(nn.Module):
    """CLIP ViT tower (reference model/clip.py:286-332,
    crog_tpu/models/clip.py:456 ``VisionTransformer``): a patch conv without
    bias, the class token, the positional embedding's first gh*gw+1 rows
    (sliced, not resized, for an input smaller than ``input_resolution``,
    as the JAX package does), ``ln_pre``, pre-LN residual attention blocks,
    then ``ln_post`` on the patch tokens only (the reference's modified
    variant drops only the class token) and ``@ proj``.  NHWC image in,
    [B, gh*gw, output_dim] out.  Its unmasked self-attention over at least
    64 tokens goes through ``attention_core`` to K1 / K1b on the card."""

    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, output_dim: int):
        super().__init__()
        scale = width**-0.5
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn((input_resolution // patch_size) ** 2 + 1, width))
        self.ln_pre = LayerNormFp32(width)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = LayerNormFp32(width)
        self.proj = nn.Parameter(scale * torch.randn(width, output_dim))

    def forward(self, x):
        x = self.conv1(x)
        b, gh, gw, w = x.shape
        x = x.reshape(b, gh * gw, w)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], 1) + self.positional_embedding[:gh * gw + 1].to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 1:]) @ self.proj.to(x.dtype)


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


class _CLIP(nn.Module):
    """The dual encoder around a ``visual`` tower: the causal text tower
    and the forward both CLIP families share.  ``dtype`` is the compute
    dtype."""

    def __init__(self, visual: nn.Module, embed_dim: int, context_length: int,
                 vocab_size: int, transformer_width: int, transformer_heads: int,
                 transformer_layers: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.visual = visual
        self.transformer = Transformer(
            transformer_width, transformer_layers, transformer_heads
        )
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, transformer_width)
        )
        self.ln_final = LayerNormFp32(transformer_width)
        self.text_projection = nn.Parameter(torch.empty(transformer_width, embed_dim))
        # unused here; kept so reference checkpoints load strictly.  The JAX
        # package has no such leaf, so it takes no gradient and no update.
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)),
                                        requires_grad=False)
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


class CLIPRN50(_CLIP):
    """Dual encoder with the ModifiedResNet tower; field names mirror what
    the reference's build_model infers from a checkpoint
    (model/clip.py:503-546)."""

    def __init__(self, embed_dim: int = 1024, image_resolution: int = 224,
                 vision_layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
                 vision_width: int = 64, context_length: int = 77,
                 vocab_size: int = 49408, transformer_width: int = 512,
                 transformer_heads: int = 8, transformer_layers: int = 12,
                 dtype: torch.dtype = torch.float32, stem_s2d: bool = False,
                 fused_stem: bool = False, remat=False):
        visual = ModifiedResNet(
            vision_layers, embed_dim, vision_width * 32 // 64,
            image_resolution, vision_width, stem_s2d, fused_stem, remat,
        )
        super().__init__(visual, embed_dim, context_length, vocab_size,
                         transformer_width, transformer_heads, transformer_layers, dtype)


class CLIPViT(_CLIP):
    """Dual encoder with the ViT tower (crog_tpu/models/clip.py:621
    ``CLIPViT``, reference model/clip.py:506-521); vision heads follow the
    reference rule vision_width // 64.  ``encode_image`` returns the
    projected patch tokens [B, gh*gw, embed_dim]."""

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 vision_layers: int = 12, vision_width: int = 768,
                 vision_patch_size: int = 32, context_length: int = 77,
                 vocab_size: int = 49408, transformer_width: int = 512,
                 transformer_heads: int = 8, transformer_layers: int = 12,
                 dtype: torch.dtype = torch.float32):
        visual = VisionTransformer(
            image_resolution, vision_patch_size, vision_width, vision_layers,
            vision_width // 64, embed_dim,
        )
        super().__init__(visual, embed_dim, context_length, vocab_size,
                         transformer_width, transformer_heads, transformer_layers, dtype)
