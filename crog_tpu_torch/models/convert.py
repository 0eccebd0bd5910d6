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

``clip_state_dict_from_flax`` does the same for a stand-alone CLIP of
either family (crog_tpu's ``CLIPRN50`` or ``CLIPViT`` variables, the
inverse of ``convert_clip_state_dict``, crog_tpu/models/convert.py:163),
in the OpenAI CLIP key schema (``visual.conv1.weight``,
``visual.transformer.resblocks.{i}.attn.in_proj_weight``, ...).

``load_torch_state_dict`` and ``merge_pretrained_clip`` are the
counterparts of crog_tpu/models/convert.py:27 and :314: a CLIP archive
(the OpenAI torch.jit release, or a plain state dict) loads non-strictly
into ``model.backbone``, whose keys already follow that schema.
``infer_clip_config`` and ``build_clip`` (crog_tpu/models/convert.py:45,
:106) read a CLIP family's architecture off its keys and build it;
``clip_from_state_dict`` loads such an archive strictly into the CLIP it
describes.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping

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


def _resblocks(b: _Builder, pre: str, *tower):
    """A flax tower's ``resblock_{i}`` -> ``{pre}resblocks.{i}``."""
    n_blocks = sum(1 for k in b.p(*tower) if k.startswith("resblock_"))
    for i in range(n_blocks):
        src = tower + (f"resblock_{i}",)
        dst = f"{pre}resblocks.{i}"
        b.mha_packed(f"{dst}.attn", *src, "attn")
        b.ln(f"{dst}.ln_1", *src, "ln_1")
        b.ln(f"{dst}.ln_2", *src, "ln_2")
        b.dense(f"{dst}.mlp.c_fc", *src, "mlp_c_fc")
        b.dense(f"{dst}.mlp.c_proj", *src, "mlp_c_proj")


def _vit(b: _Builder, pre: str, *vi):
    b.conv(f"{pre}visual.conv1", *vi, "conv1")
    for name in ("class_embedding", "positional_embedding", "proj"):
        b.put(f"{pre}visual.{name}", b.p(*vi, name))
    b.ln(f"{pre}visual.ln_pre", *vi, "ln_pre")
    b.ln(f"{pre}visual.ln_post", *vi, "ln_post")
    _resblocks(b, f"{pre}visual.transformer.", *vi)


def _clip(b: _Builder, pre: str, *root):
    """A CLIP's ``visual`` (either family) and ``transformer`` subtrees
    under ``root`` -> keys under ``pre``."""
    vi = root + ("visual",)
    if "proj" in b.p(*vi):
        _vit(b, pre, *vi)
    else:
        _resnet(b, pre, *vi)
    tr = root + ("transformer",)
    b.put(f"{pre}token_embedding.weight", b.p(*tr, "token_embedding"))
    b.put(f"{pre}positional_embedding", b.p(*tr, "positional_embedding"))
    b.put(f"{pre}text_projection", b.p(*tr, "text_projection"))
    b.ln(f"{pre}ln_final", *tr, "ln_final")
    _resblocks(b, f"{pre}transformer.", *tr)


def _resnet(b: _Builder, pre: str, *vi):
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


def clip_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                              logit_scale: float = float(np.log(1 / 0.07))
                              ) -> Dict[str, np.ndarray]:
    """The JAX package's ``CLIPRN50`` or ``CLIPViT`` variables -> the
    port's state_dict (numpy) of the same family, which ``build_clip`` of
    its ``infer_clip_config`` loads strictly."""
    b = _Builder(params, batch_stats)
    _clip(b, "")
    b.put("logit_scale", np.asarray(logit_scale))
    return b.sd


def _decoder(b: _Builder, pre: str, *dec):
    """The flax TransformerDecoder at ``dec`` -> the port's under ``pre``."""
    n_layers = sum(1 for k in b.p(*dec) if k.startswith("layer_"))
    for i in range(n_layers):
        src = dec + (f"layer_{i}",)
        dst = f"{pre}layers.{i}"
        for ln in ("norm1", "norm2", "norm3", "self_attn_norm", "cross_attn_norm"):
            b.ln(f"{dst}.{ln}", *src, ln)
        b.mha_packed(f"{dst}.self_attn", *src, "self_attn")
        b.mha_packed(f"{dst}.multihead_attn", *src, "multihead_attn")
        b.dense(f"{dst}.ffn.0", *src, "ffn_fc1")
        b.ln(f"{dst}.ffn.3", *src, "ffn_ln")
        b.dense(f"{dst}.ffn.4", *src, "ffn_fc2")
    b.ln(f"{pre}norm", *dec, "norm")


def state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                         logit_scale: float = float(np.log(1 / 0.07))
                         ) -> Dict[str, np.ndarray]:
    """The JAX package's CROG variables -> the port's state_dict (numpy)."""
    b = _Builder(params, batch_stats)
    _clip(b, "backbone.", "backbone")
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
        _decoder(b, "decoder.", "decoder")

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


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch.jit archive (the OpenAI CLIP release), else a plain
    state-dict checkpoint (``{'state_dict': ...}`` or bare), as tensors on
    the CPU, floating ones in fp32 (the release stores fp16)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items() if torch.is_tensor(v)}


def _count(sd: Mapping, prefix: str, field: int) -> int:
    """How many distinct values the key path's ``field``-th part takes over
    the keys under ``prefix``: blocks of a tower or a stage."""
    return len({k.split(".")[field] for k in sd if k.startswith(prefix)})


def infer_clip_config(sd: Mapping) -> Dict:
    """A CLIP's architecture from its state_dict's keys and shapes
    (crog_tpu/models/convert.py:45, reference model/clip.py:503-542, both
    families): the constructor fields of ``CLIPViT`` or ``CLIPRN50`` and a
    ``vision_arch`` discriminator ('vit' or 'resnet') for ``build_clip``."""
    common = dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=_count(sd, "transformer.resblocks", 2),
    )
    if "visual.proj" in sd:
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        return dict(
            vision_arch="vit",
            image_resolution=patch * grid,
            vision_layers=_count(sd, "visual.transformer.resblocks", 3),
            vision_width=sd["visual.conv1.weight"].shape[0],
            vision_patch_size=patch,
            **common,
        )
    if "visual.layer1.0.conv1.weight" not in sd:
        raise KeyError("unrecognized CLIP family: neither visual.proj (ViT) nor "
                       "visual.layer1.0.conv1.weight (ResNet) in the state dict")
    output_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    return dict(
        vision_arch="resnet",
        image_resolution=output_width * 32,
        vision_layers=tuple(_count(sd, f"visual.layer{i}", 2) for i in (1, 2, 3, 4)),
        vision_width=sd["visual.layer1.0.conv1.weight"].shape[0],
        **common,
    )


def build_clip(cfg: Mapping, dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The CLIP of an ``infer_clip_config`` result (the reference
    build_model's class dispatch, model/clip.py:540-546); ``dtype`` is the
    compute dtype."""
    from crog_tpu_torch.models.clip import CLIPRN50, CLIPViT

    cfg = dict(cfg)
    cls = CLIPViT if cfg.pop("vision_arch", "resnet") == "vit" else CLIPRN50
    return cls(dtype=dtype, **cfg)


# what the OpenAI archive holds beside the weights; its build_model drops them
CLIP_ARCHIVE_META = ("input_resolution", "context_length", "vocab_size")


def clip_from_state_dict(sd: Mapping[str, torch.Tensor],
                         dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The CLIP that ``sd`` (``load_torch_state_dict`` of a CLIP archive, of
    either family) describes, with its weights (the reference's build_model,
    model/clip.py:503-556).  Every key must match but those of the RN50
    attention pool's ``connect`` branch, which CROG adds to CLIP and an
    archive lacks (they keep their initialization): a ViT archive loads
    strictly."""
    sd = {k: v for k, v in sd.items() if k not in CLIP_ARCHIVE_META}
    model = build_clip(infer_clip_config(sd), dtype)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if ".attnpool.connect." not in k]
    if missing or unexpected:
        raise KeyError(f"CLIP state dict: missing {missing[:5]}, unexpected "
                       f"{unexpected[:5]}")
    return model


def merge_pretrained_clip(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]
                          ) -> List[str]:
    """Load a CLIP state dict into ``model.backbone`` non-strictly, as the
    reference does (model/clip.py:554, strict=False): the backbone's keys
    that the archive lacks keep their initialization (the attention pool's
    ``connect`` branch, which CROG adds to CLIP), and the archive's keys
    that the backbone lacks (``input_resolution``, ``context_length``,
    ``vocab_size``) are skipped.  Any other backbone key the archive lacks
    raises, naming the keys, as the JAX package's conversion reads every
    CLIP key by name (``num_batches_tracked`` and ``logit_scale``, which it
    does not read, may be absent).  A shape mismatch raises, naming the
    key.  Returns the keys loaded."""
    own = model.backbone.state_dict()
    take = {}
    for k, v in sd.items():
        if k not in own:
            continue
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"CLIP archive key {k!r}: shape {tuple(v.shape)}, "
                             f"the backbone holds {tuple(own[k].shape)}")
        take[k] = v
    missing = sorted(k for k in own if k not in take and ".connect." not in k
                     and not k.endswith(("num_batches_tracked", "logit_scale")))
    if missing:
        raise KeyError(f"the CLIP archive lacks {len(missing)} backbone keys, e.g. "
                       f"{missing[:5]} (it holds {len(take)} of them)")
    model.backbone.load_state_dict(take, strict=False)
    return sorted(take)
