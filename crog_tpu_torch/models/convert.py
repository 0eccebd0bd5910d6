"""JAX package parameters -> the port's state_dict, and checkpoint loading.

``ssg_state_dict_from_flax`` is the inverse of crog_tpu/models/convert.py
``convert_ssg_state_dict`` (523), for SSG.  For CROG, the inverse of
crog_tpu/models/convert.py ``convert_crog_state_dict`` (384):
the JAX package's flax ``params`` / ``batch_stats`` trees (as numpy) become
a state_dict in the reference torch key schema (``backbone.``, ``neck.``,
``decoder.``, ``proj.``; packed ``in_proj_weight`` for torch
MultiheadAttention, separate ``q_proj``/``k_proj``/``v_proj``/``c_proj``
for the CLIP attention pool), which the port's ``CROG`` loads with plain
``load_state_dict``, as it loads a reference ``.pth``.

Layouts: flax conv kernels (kH, kW, I, O) -> torch (O, I, kH, kW); flax
Dense kernels (I, O) -> torch (O, I).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _conv(k):  # (kH, kW, I, O) -> (O, I, kH, kW)
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _dense_w(k):  # (I, O) -> (O, I)
    return np.transpose(np.asarray(k))


class _Builder:
    def __init__(self, params: Mapping, stats: Mapping):
        self.params = params
        self.stats = stats
        self.sd: Dict[str, np.ndarray] = {}

    def p(self, *path):
        node = self.params
        for k in path:
            node = node[k]
        return node

    def s(self, *path):
        node = self.stats
        for k in path:
            node = node[k]
        return node

    def put(self, key, value):
        self.sd[key] = np.asarray(value, np.float32)

    def conv(self, dst, *path):
        self.put(f"{dst}.weight", _conv(self.p(*path, "kernel")))
        if "bias" in self.p(*path):
            self.put(f"{dst}.bias", self.p(*path, "bias"))

    def dense(self, dst, *path):
        self.put(f"{dst}.weight", _dense_w(self.p(*path, "kernel")))
        if "bias" in self.p(*path):
            self.put(f"{dst}.bias", self.p(*path, "bias"))

    def bn(self, dst, *path):
        self.put(f"{dst}.weight", self.p(*path, "scale"))
        self.put(f"{dst}.bias", self.p(*path, "bias"))
        self.put(f"{dst}.running_mean", self.s(*path, "mean"))
        self.put(f"{dst}.running_var", self.s(*path, "var"))
        self.sd[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)

    def ln(self, dst, *path):
        self.put(f"{dst}.weight", self.p(*path, "LayerNorm_0", "scale"))
        self.put(f"{dst}.bias", self.p(*path, "LayerNorm_0", "bias"))

    def mha_packed(self, dst, *path):
        """q/k/v/out_proj Dense tree -> torch MultiheadAttention."""
        qkv = [self.p(*path, n) for n in ("q_proj", "k_proj", "v_proj")]
        self.put(f"{dst}.in_proj_weight",
                 np.concatenate([_dense_w(t["kernel"]) for t in qkv], 0))
        self.put(f"{dst}.in_proj_bias", np.concatenate([t["bias"] for t in qkv], 0))
        self.dense(f"{dst}.out_proj", *path, "out_proj")

    def cbr(self, dst, *path):
        """ConvBnRelu {conv, bn} -> conv_layer Sequential (.0 conv, .1 BN)."""
        self.conv(f"{dst}.0", *path, "conv")
        self.bn(f"{dst}.1", *path, "bn")


def _clip(b: _Builder, pre: str):
    vi = ("backbone", "visual")
    for i in (1, 2, 3):
        b.conv(f"{pre}visual.conv{i}", *vi, f"conv{i}")
        b.bn(f"{pre}visual.bn{i}", *vi, f"bn{i}")
    blocks = sorted(
        (int(m.group(1)), int(m.group(2)))
        for k in b.p(*vi) if (m := re.fullmatch(r"layer(\d)_(\d+)", k))
    )
    for layer, idx in blocks:
        src = vi + (f"layer{layer}_{idx}",)
        dst = f"{pre}visual.layer{layer}.{idx}"
        for i in (1, 2, 3):
            b.conv(f"{dst}.conv{i}", *src, f"conv{i}")
            b.bn(f"{dst}.bn{i}", *src, f"bn{i}")
        if "downsample_conv" in b.p(*src):
            b.conv(f"{dst}.downsample.0", *src, "downsample_conv")
            b.bn(f"{dst}.downsample.1", *src, "downsample_bn")
    ap = vi + ("attnpool",)
    b.put(f"{pre}visual.attnpool.positional_embedding",
          b.p(*ap, "positional_embedding"))
    for name, src in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                      ("v_proj", "v_proj"), ("c_proj", "out_proj")):
        b.dense(f"{pre}visual.attnpool.{name}", *ap, "attn", src)
    b.conv(f"{pre}visual.attnpool.connect.0", *ap, "connect_conv")
    b.bn(f"{pre}visual.attnpool.connect.1", *ap, "connect_bn")

    tr = ("backbone", "transformer")
    b.put(f"{pre}token_embedding.weight", b.p(*tr, "token_embedding"))
    b.put(f"{pre}positional_embedding", b.p(*tr, "positional_embedding"))
    b.put(f"{pre}text_projection", b.p(*tr, "text_projection"))
    b.ln(f"{pre}ln_final", *tr, "ln_final")
    n_blocks = sum(1 for k in b.p(*tr) if k.startswith("resblock_"))
    for i in range(n_blocks):
        src = tr + (f"resblock_{i}",)
        dst = f"{pre}transformer.resblocks.{i}"
        b.mha_packed(f"{dst}.attn", *src, "attn")
        b.ln(f"{dst}.ln_1", *src, "ln_1")
        b.ln(f"{dst}.ln_2", *src, "ln_2")
        b.dense(f"{dst}.mlp.c_fc", *src, "mlp_c_fc")
        b.dense(f"{dst}.mlp.c_proj", *src, "mlp_c_proj")


def state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                         logit_scale: float = float(np.log(1 / 0.07))
                         ) -> Dict[str, np.ndarray]:
    """The JAX package's CROG variables -> the port's state_dict (numpy)."""
    b = _Builder(params, batch_stats)
    _clip(b, "backbone.")
    b.put("backbone.logit_scale", np.asarray(logit_scale))

    nk = ("neck",)
    b.dense("neck.txt_proj.0", *nk, "txt_proj", "linear")
    b.bn("neck.txt_proj.1", *nk, "txt_proj", "bn")
    for name in ("f1_v_proj", "f2_v_proj", "f2_cat", "f3_v_proj", "f3_cat",
                 "f4_proj5", "f4_proj4", "f4_proj3", "aggr"):
        b.cbr(f"neck.{name}", *nk, name)
    b.bn("neck.norm_layer.0", *nk, "norm_layer_bn")
    b.cbr("neck.coordconv.0.conv1", *nk, "coordconv_0", "conv1")
    b.cbr("neck.coordconv.1", *nk, "coordconv_1")

    if "decoder" in params:
        dec = ("decoder",)
        n_layers = sum(1 for k in b.p(*dec) if k.startswith("layer_"))
        for i in range(n_layers):
            src = dec + (f"layer_{i}",)
            dst = f"decoder.layers.{i}"
            for ln in ("norm1", "norm2", "norm3", "self_attn_norm",
                       "cross_attn_norm"):
                b.ln(f"{dst}.{ln}", *src, ln)
            b.mha_packed(f"{dst}.self_attn", *src, "self_attn")
            b.mha_packed(f"{dst}.multihead_attn", *src, "multihead_attn")
            b.dense(f"{dst}.ffn.0", *src, "ffn_fc1")
            b.ln(f"{dst}.ffn.3", *src, "ffn_ln")
            b.dense(f"{dst}.ffn.4", *src, "ffn_fc2")
        b.ln("decoder.norm", *dec, "norm")

    pj = ("proj",)
    b.cbr("proj.vis.1", *pj, "vis_conv1")
    b.cbr("proj.vis.3", *pj, "vis_conv2")
    b.conv("proj.vis.4", *pj, "vis_out")
    b.dense("proj.txt", *pj, "txt")
    return b.sd


def ssg_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                             ) -> Dict[str, np.ndarray]:
    """The JAX package's SSG variables -> the port's state_dict (numpy), in
    the reference key schema that crog_tpu/models/convert.py
    ``convert_ssg_state_dict`` (523) reads."""
    b = _Builder(params, batch_stats)
    bb = ("backbone",)
    b.conv("backbone.conv1", *bb, "conv1")
    b.bn("backbone.bn1", *bb, "bn1")
    blocks = sorted(
        (int(m.group(1)), int(m.group(2)))
        for k in b.p(*bb) if (m := re.fullmatch(r"layer(\d)_(\d+)", k))
    )
    for stage, idx in blocks:
        src = bb + (f"layer{stage}_{idx}",)
        dst = f"backbone.layers.{stage - 1}.{idx}"
        for i in (1, 2, 3):
            b.conv(f"{dst}.conv{i}", *src, f"conv{i}")
            b.bn(f"{dst}.bn{i}", *src, f"bn{i}")
        if "downsample_conv" in b.p(*src):
            b.conv(f"{dst}.downsample.0", *src, "downsample_conv")
            b.bn(f"{dst}.downsample.1", *src, "downsample_bn")
    for j in range(3):
        b.conv(f"fpn.lat_layers.{j}", "fpn", f"lat{j}")
        b.conv(f"fpn.pred_layers.{j}.0", "fpn", f"pred{j}")
    for j in range(2):
        b.conv(f"fpn.downsample_layers.{j}.0", "fpn", f"down{j}")
    for i, idx in enumerate((0, 2, 4)):
        b.conv(f"proto_net.proto1.{idx}", "proto_net", f"proto1_{i}")
    b.conv("proto_net.proto2.0", "proto_net", "proto2_0")
    b.conv("proto_net.proto2.2", "proto_net", "proto2_1")
    pl = "prediction_layers"
    b.conv(f"{pl}.upfeature.0", pl, "upfeature")
    b.conv(f"{pl}.conf_layer", pl, "conf_layer")
    b.conv(f"{pl}.bbox_layer", pl, "bbox_layer")
    b.conv(f"{pl}.coef_layer.0", pl, "coef_layer")
    if "grasp_coef_layer" in b.p(pl):
        b.conv(f"{pl}.grasp_coef_layer.0", pl, "grasp_coef_layer")
    if "semantic_seg_conv" in params:  # present when initialized in train mode
        b.conv("semantic_seg_conv", "semantic_seg_conv")
    return b.sd


def load_numpy_state_dict(model: torch.nn.Module, sd: Mapping) -> None:
    """Strict load of a numpy (or tensor) state_dict into ``model``."""
    tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` / ``.pt`` CROG checkpoint as a state_dict:
    ``{'state_dict': ...}`` or a bare state_dict, with any DDP ``module.``
    prefix removed."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck["state_dict"] if isinstance(ck, dict) and "state_dict" in ck else ck
    return {
        (k[len("module."):] if k.startswith("module.") else k): v.float()
        if v.is_floating_point() else v
        for k, v in sd.items()
    }
