"""SSG: vision-only YOLACT-style instance grasp synthesis.

Counterpart of crog_tpu/models/ssg.py: ``ResBottleneck`` (41),
``ResNetBackbone`` (82, a 4-channel RGB-D stem with depth), ``SSGFPN``
(111, p3-p7), ``ProtoNet`` (134, 32 prototypes at twice p3's resolution),
``PredictionModule`` (159, one head shared by the five levels), ``SSG``
(191) and ``build_ssg`` (281).

Module names follow the reference torch SSG (model/ssg.py), so its
state_dict (and ``models/convert.py:ssg_state_dict_from_flax``) loads with
plain ``load_state_dict``.  Tensors are NHWC, as in the JAX package; the
head's outputs flatten (rows, cols, ratios) so anchors line up with
``ops/boxes.py:make_anchors``.  Parameters are fp32; the compute dtype is
``dtype`` (bf16 on the card), with BatchNorm in fp32 (models/clip.py).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from crog_tpu_torch.models.clip import BatchNorm, Conv2d
from crog_tpu_torch.models.crog import random_init_  # noqa: F401  (seeded weights)
from crog_tpu_torch.ops.boxes import make_anchors
from crog_tpu_torch.ops.resize import upsample2x_bilinear


def _conv(cin, cout, k, stride=1, padding=0, bias=True):
    """A conv initialized as the reference's: Xavier-uniform, zero bias."""
    conv = Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
    nn.init.xavier_uniform_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class ResBottleneck(nn.Module):
    """torchvision-style bottleneck: stride on the 3x3 conv, downsample a
    strided 1x1 conv + BN."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(_conv(inplanes, planes * 4, 1, stride, bias=False),
                                            BatchNorm(planes * 4))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNetBackbone(nn.Module):
    """7x7 stem, 3x3 max-pool, four bottleneck stages; returns every
    stage's output."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), in_channels: int = 4):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        stages, inplanes = [], 64
        for si, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage = [ResBottleneck(inplanes, planes, 1 if si == 0 else 2)]
            inplanes = planes * 4
            stage += [ResBottleneck(inplanes, planes) for _ in range(1, blocks)]
            stages.append(nn.Sequential(*stage))
        self.layers = nn.ModuleList(stages)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        # -inf padding, as flax's max_pool
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for stage in self.layers:
            x = stage(x)
            outs.append(x)
        return tuple(outs)


class SSGFPN(nn.Module):
    """Five-level FPN: lateral 1x1s with 2x upsampling (align_corners
    False), 3x3 prediction convs, two stride-2 downsampling convs."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), width: int = 256):
        super().__init__()
        self.lat_layers = nn.ModuleList(_conv(c, width, 1) for c in in_channels)
        self.pred_layers = nn.ModuleList(
            nn.Sequential(_conv(width, width, 3, 1, 1), nn.ReLU()) for _ in in_channels)
        self.downsample_layers = nn.ModuleList(
            nn.Sequential(_conv(width, width, 3, 2, 1), nn.ReLU()) for _ in range(2))

    def forward(self, c3, c4, c5):
        p5_1 = self.lat_layers[2](c5)
        p4_1 = self.lat_layers[1](c4) + upsample2x_bilinear(p5_1)
        p3_1 = self.lat_layers[0](c3) + upsample2x_bilinear(p4_1)
        p5 = self.pred_layers[2](p5_1)
        p4 = self.pred_layers[1](p4_1)
        p3 = self.pred_layers[0](p3_1)
        p6 = self.downsample_layers[0](p5)
        p7 = self.downsample_layers[1](p6)
        return p3, p4, p5, p6, p7


class ProtoNet(nn.Module):
    """Three 3x3 convs, a 2x upsample (align_corners True), a 3x3 conv and a
    1x1 conv to ``coef_dim`` prototypes, each followed by a ReLU."""

    def __init__(self, coef_dim: int = 32, width: int = 256):
        super().__init__()
        self.proto1 = nn.Sequential(
            _conv(width, width, 3, 1, 1), nn.ReLU(), _conv(width, width, 3, 1, 1), nn.ReLU(),
            _conv(width, width, 3, 1, 1), nn.ReLU())
        self.proto2 = nn.Sequential(_conv(width, width, 3, 1, 1), nn.ReLU(),
                                    _conv(width, coef_dim, 1), nn.ReLU())

    def forward(self, x):
        x = upsample2x_bilinear(self.proto1(x), align_corners=True)
        return self.proto2(x)


class PredictionModule(nn.Module):
    """Per-level head: class logits, box offsets, tanh instance
    coefficients and (with grasp masks) tanh grasp coefficients per anchor."""

    def __init__(self, num_classes: int, num_ratios: int = 3, coef_dim: int = 32,
                 with_grasp_masks: bool = True, width: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.coef_dim = coef_dim
        self.upfeature = nn.Sequential(_conv(width, width, 3, 1, 1), nn.ReLU())
        self.conf_layer = _conv(width, num_ratios * num_classes, 3, 1, 1)
        self.bbox_layer = _conv(width, num_ratios * 4, 3, 1, 1)
        self.coef_layer = nn.Sequential(_conv(width, num_ratios * coef_dim, 3, 1, 1),
                                        nn.Tanh())
        self.grasp_coef_layer = None
        if with_grasp_masks:
            self.grasp_coef_layer = nn.Sequential(
                _conv(width, num_ratios * coef_dim * 4, 3, 1, 1), nn.Tanh())

    def forward(self, x):
        b = x.shape[0]
        x = self.upfeature(x)
        # NHWC channels are (ratio, value): a reshape flattens (rows, cols,
        # ratios), the order of make_anchors
        out = [self.conf_layer(x).reshape(b, -1, self.num_classes),
               self.bbox_layer(x).reshape(b, -1, 4),
               self.coef_layer(x).reshape(b, -1, self.coef_dim)]
        if self.grasp_coef_layer is not None:
            out.append(self.grasp_coef_layer(x).reshape(b, -1, 4, self.coef_dim))
        return out


class SSG(nn.Module):
    """The whole detector; anchors are computed from the configuration."""

    def __init__(self, num_classes: int = 32, img_size: int = 544,
                 resnet_layers: Tuple[int, ...] = (3, 4, 6, 3),
                 anchor_strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 aspect_ratios: Tuple[float, ...] = (1, 0.5, 2), num_protos: int = 32,
                 with_depth: bool = True, with_grasp_masks: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.img_size = img_size
        self.with_depth = with_depth
        self.anchor_strides = tuple(anchor_strides)
        self.aspect_ratios = tuple(aspect_ratios)
        self.with_grasp_masks = with_grasp_masks
        self.dtype = dtype
        self.backbone = ResNetBackbone(resnet_layers, 4 if with_depth else 3)
        self.fpn = SSGFPN()
        self.proto_net = ProtoNet(num_protos)
        self.prediction_layers = PredictionModule(num_classes, len(self.aspect_ratios),
                                                  num_protos, with_grasp_masks)
        self.semantic_seg_conv = _conv(256, num_classes, 1)

    def anchors(self) -> np.ndarray:
        scales = [int(self.img_size / 544 * a) for a in (24, 48, 96, 192, 384)]
        shapes = [math.ceil(self.img_size / s) for s in self.anchor_strides]
        return np.concatenate([
            make_anchors(size, size, scale, self.aspect_ratios, self.img_size)
            for size, scale in zip(shapes, scales)
        ], axis=0)

    def forward(self, img) -> Dict[str, torch.Tensor]:
        """img [B, S, S, 3 (+1 depth)] -> the output dict.  In train mode the
        coefficient stacks stay in the compute dtype (the loss converts the
        gathered rows to f32) and ``seg_pred`` is added; in eval mode the
        stacks are f32 and ``cls_pred`` is the softmax."""
        _, c3, c4, c5 = self.backbone(img.to(self.dtype))
        feats = self.fpn(c3, c4, c5)
        protos = self.proto_net(feats[0])
        heads = [self.prediction_layers(f) for f in feats]
        cls_logits = torch.cat([h[0] for h in heads], dim=1).float()
        output = OrderedDict(
            protos=protos.float(), cls_logits=cls_logits,
            box_pred=torch.cat([h[1] for h in heads], dim=1).float())
        coef = torch.cat([h[2] for h in heads], dim=1)
        output["ins_coef_pred"] = coef if self.training else coef.float()
        if not self.training:
            output["cls_pred"] = torch.softmax(cls_logits, dim=-1)
        if self.with_grasp_masks:
            grasp = torch.cat([h[3] for h in heads], dim=1)
            output["grasp_coef_pred"] = grasp if self.training else grasp.float()
        if self.training:
            output["seg_pred"] = self.semantic_seg_conv(feats[0]).float()
        return output


def build_ssg(cfg, dtype: torch.dtype | None = None) -> SSG:
    """The model of a flattened config; ``dtype`` overrides the config's
    ``compute_dtype``."""
    if dtype is None:
        bf16 = cfg.get("compute_dtype", "bfloat16") == "bfloat16"
        dtype = torch.bfloat16 if bf16 else torch.float32
    return SSG(
        num_classes=cfg.num_classes,
        img_size=cfg.img_size,
        resnet_layers=tuple(cfg.resnet_layers),
        anchor_strides=tuple(cfg.anchor_strides),
        aspect_ratios=tuple(cfg.aspect_ratios),
        num_protos=cfg.num_protos,
        with_depth=cfg.with_depth,
        with_grasp_masks=cfg.with_grasp_masks,
        dtype=dtype,
    )
