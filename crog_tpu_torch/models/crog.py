"""CROG: CLIP-based referring grasp synthesis, and its training losses.

Counterpart of crog_tpu/models/crog.py ``CROG`` (30), ``smooth_l1`` (116),
``weighted_bce_with_logits`` (122), ``crog_losses`` (131) and
``build_crog`` (164): image [B,416,416,3] + word ids [B,17] -> 5 maps at
104x104: instance mask logit + grasp quality / sin2theta / cos2theta /
width logits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from crog_tpu_torch.models.clip import CLIPRN50
from crog_tpu_torch.models.layers import (
    FPN,
    MultiTaskProjector,
    Projector,
    TransformerDecoder,
)
from crog_tpu_torch.ops.resize import resize_nearest


class CROG(nn.Module):
    """Config fields mirror config/OCID-VLG/*.yaml TRAIN keys.  ``dtype`` is
    the compute dtype; parameters stay fp32.  ``stem_s2d`` (default on, as
    in the JAX package) runs the vision stem in the space-to-depth domain;
    ``fused_stem`` runs its two stride-1 convs through the K6/K6b kernels
    (``clip.ModifiedResNet``)."""

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
        stem_s2d: bool = True,
        fused_stem: bool = False,
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
            stem_s2d=stem_s2d,
            fused_stem=fused_stem,
        )
        self.neck = FPN(in_channels=tuple(fpn_in), out_channels=tuple(fpn_out))
        if use_contrastive:
            self.decoder = TransformerDecoder(
                num_layers, vis_dim, num_head, dim_ffn, dropout
            )
        proj_cls = MultiTaskProjector if use_grasp_masks else Projector
        self.proj = proj_cls(word_dim=word_dim, in_dim=vis_dim // 2, kernel_size=3)

    def forward(self, img, word, generator=None):
        """img [B,H,W,3] normalized; word [B,L] int padded token ids.
        Returns [B,H/4,W/4,5] (or [...,1] without grasp masks) fp32 logits.
        In train mode the decoder's dropout seeds come from ``generator``.
        Each submodule runs in a profiler range of its name, the regions of
        tools/torch_profile_step.py."""
        word = word.long()
        pad_mask = word == 0
        with record_function("backbone"):
            vis = self.backbone.encode_image(img)
            word_feat, state = self.backbone.encode_text(word)
        with record_function("neck"):
            fq = self.neck(vis, state)
        if self.use_contrastive:
            with record_function("decoder"):
                fq = self.decoder(fq, word_feat, pad_mask, generator)
        with record_function("proj"):
            return self.proj(fq, state)


def smooth_l1(pred, target, beta: float = 1.0):
    """torch F.smooth_l1_loss, mean reduction."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def weighted_bce_with_logits(logits, targets, weight):
    """F.binary_cross_entropy_with_logits(pred, mask, weight=w), in the
    stable log-sigmoid form the JAX package writes out."""
    loss = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return (loss * weight).mean()


def crog_losses(preds, targets: Dict[str, torch.Tensor], use_grasp_masks: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training losses (reference model/crog.py:76-111), all in f32: weighted
    BCE on the instance mask (weight = mask * 0.5 + 1) plus smooth-L1 on
    qua/sin/cos/wid, an unweighted sum.  Targets at input size are resized
    to the prediction's size by nearest neighbour."""
    ph, pw = preds.shape[1:3]

    def fit(x):
        x = x.float()
        if tuple(x.shape[1:3]) != (ph, pw):
            x = resize_nearest(x[..., None], (ph, pw))[..., 0]
        return x

    mask = fit(targets["mask"])
    loss_ins = weighted_bce_with_logits(preds[..., 0].float(), mask, mask * 0.5 + 1.0)
    loss_dict = {"m_ins": loss_ins}
    total = loss_ins
    for i, key in enumerate(("qua", "sin", "cos", "wid"), start=1):
        if use_grasp_masks:
            loss_dict[f"m_{key}"] = smooth_l1(preds[..., i].float(), fit(targets[key]))
            total = total + loss_dict[f"m_{key}"]
        else:
            loss_dict[f"m_{key}"] = torch.zeros((), device=preds.device)
    return total, loss_dict


def build_crog(cfg, dtype: torch.dtype | None = None, fused_stem: bool = False) -> CROG:
    """The model of a flattened config (reference model/__init__.py:6-23);
    ``dtype`` overrides the config's ``compute_dtype``; ``stem_s2d`` comes
    from the config (default True), ``fused_stem`` from the caller (the
    counterpart of the JAX package's CROG_FUSED_STEM=1)."""
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
        stem_s2d=bool(cfg.get("stem_s2d", True)),
        fused_stem=fused_stem,
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
