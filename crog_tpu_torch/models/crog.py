"""CROG: CLIP-based referring grasp synthesis, inference.

Counterpart of crog_tpu/models/crog.py ``CROG`` (30) and ``build_crog``
(164): image [B,416,416,3] + word ids [B,17] -> 5 maps at 104x104: instance
mask logit + grasp quality / sin2theta / cos2theta / width logits.  The
losses (``crog_losses``) belong to the training slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from crog_tpu_torch.models.clip import CLIPRN50
from crog_tpu_torch.models.layers import (
    FPN,
    MultiTaskProjector,
    Projector,
    TransformerDecoder,
)


class CROG(nn.Module):
    """Config fields mirror config/OCID-VLG/*.yaml TRAIN keys.  ``dtype`` is
    the compute dtype; parameters stay fp32."""

    def __init__(
        self,
        word_len: int = 17,
        word_dim: int = 1024,
        vis_dim: int = 512,
        fpn_in: Tuple[int, int, int] = (512, 1024, 1024),
        fpn_out: Tuple[int, int, int] = (256, 512, 1024),
        num_layers: int = 3,
        num_head: int = 8,
        dim_ffn: int = 2048,
        dropout: float = 0.1,
        input_resolution: int = 416,
        use_contrastive: bool = True,
        use_grasp_masks: bool = True,
        vision_layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
        transformer_layers: int = 12,
        vision_width: int = 64,
        transformer_width: int = 512,
        vocab_size: int = 49408,
        clip_resolution: int = 224,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.input_resolution = input_resolution
        self.use_contrastive = use_contrastive
        self.backbone = CLIPRN50(
            embed_dim=word_dim,
            image_resolution=clip_resolution,  # pos-embed resized at use
            vision_layers=vision_layers,
            vision_width=vision_width,
            vocab_size=vocab_size,
            transformer_width=transformer_width,
            transformer_heads=transformer_width // 64,
            transformer_layers=transformer_layers,
            dtype=dtype,
        )
        self.neck = FPN(in_channels=tuple(fpn_in), out_channels=tuple(fpn_out))
        if use_contrastive:
            self.decoder = TransformerDecoder(
                num_layers, vis_dim, num_head, dim_ffn, dropout
            )
        proj_cls = MultiTaskProjector if use_grasp_masks else Projector
        self.proj = proj_cls(word_dim=word_dim, in_dim=vis_dim // 2, kernel_size=3)

    def forward(self, img, word):
        """img [B,H,W,3] normalized; word [B,L] int padded token ids.
        Returns [B,H/4,W/4,5] (or [...,1] without grasp masks) fp32 logits."""
        word = word.long()
        pad_mask = word == 0
        vis = self.backbone.encode_image(img)
        word_feat, state = self.backbone.encode_text(word)
        fq = self.neck(vis, state)
        if self.use_contrastive:
            fq = self.decoder(fq, word_feat, pad_mask)
        return self.proj(fq, state)


def build_crog(cfg, dtype: torch.dtype | None = None) -> CROG:
    """The model of a flattened config (reference model/__init__.py:6-23);
    ``dtype`` overrides the config's ``compute_dtype``."""
    if dtype is None:
        bf16 = cfg.get("compute_dtype", "bfloat16") == "bfloat16"
        dtype = torch.bfloat16 if bf16 else torch.float32
    return CROG(
        word_len=cfg.word_len,
        word_dim=cfg.word_dim,
        vis_dim=cfg.vis_dim,
        fpn_in=tuple(cfg.fpn_in),
        fpn_out=tuple(cfg.fpn_out),
        num_layers=cfg.num_layers,
        num_head=cfg.num_head,
        dim_ffn=cfg.dim_ffn,
        dropout=cfg.dropout,
        input_resolution=cfg.input_size,
        use_contrastive=cfg.use_contrastive,
        use_grasp_masks=cfg.use_grasp_masks,
        dtype=dtype,
    )


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter and BatchNorm statistic with seeded random
    values of a trained network's scale: weights ~ N(0, gain/fan_in) (gain 2
    for convs, which feed ReLUs), norm scales ~ 1 + N(0, 0.1^2), biases and
    running means ~ N(0, 0.05^2), running variances in [0.5, 1.5).  The
    bottlenecks' last BN scales (``bn3``, zero at init in the reference) are
    a quarter of that, so the residual stream stays bounded through the
    tower, as in a trained network; no scale is zero, so no branch is
    silently skipped."""

    def randn(shape):
        return torch.randn(shape, generator=generator)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() <= 1:
            if leaf == "weight":  # LayerNorm / BatchNorm scale
                p.copy_(1.0 + 0.1 * randn(p.shape))
                if name.endswith(".bn3.weight") and ".layer" in name:
                    p.mul_(0.25)
            else:
                p.copy_(0.05 * randn(p.shape))
        elif p.dim() == 4:
            fan_in = p[0].numel()
            p.copy_(randn(p.shape) * (2.0 / fan_in) ** 0.5)
        else:
            fan_in = p.shape[1] if leaf != "text_projection" else p.shape[0]
            p.copy_(randn(p.shape) / fan_in**0.5)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.05 * randn(buf.shape))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=generator))
    return model
