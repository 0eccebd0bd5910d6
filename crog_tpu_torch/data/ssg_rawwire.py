"""SSG's raw uint8 wire: the augmentation and the per-instance grasp-map
raster run on the device.

Counterpart of crog_tpu/data/ssg_rawwire.py.  The host ships per sample

  * ``ssg_img_u8`` [H0, W0, 3] uint8: the BGR camera frame;
  * ``ssg_depth_u16`` [H0, W0] uint16: the inverted-normalized depth
    (1 - d/max, in [0, 1]) times 65535, rounded (a legacy f32
    ``ssg_depth`` is accepted too);
  * ``ins_mask_bits`` [M, H0, W0/8] uint8: the instance masks bit-packed,
    MSB-first; M is the batch's occupied slot count (``collate_ssg_raw``);
  * ``ssg_rect_corners`` [M, R, 4, 2] int32 / ``ssg_rect_vals`` [M, R, 3]
    f32: each instance's grasp raster parameters
    (``data/rawwire.py:pack_raster_params``);
  * ``aug`` [7] f32: the drawn augmentation (b_delta, c_factor, h1, h2,
    mirror, pad_y0, pad_x0);
  * ``boxes`` / ``labels`` / ``obj_valid``: the final normalized boxes,
    their mirror / pad / resize applied on the host.

``unpack_ssg_raw`` replays ``DataAugmentor.apply`` and the raster on the
device: (1) the photometric distortion through the HSV maps, the
reference's double hue shift kept; (2) the per-instance raster with the
exact integer PNPOLY of ``data/rawwire.py:_rasterize``, instances folded
into the batch in chunks; (3) mirror, pad-to-square and resize as two
matrix products per plane: per sample a column window of one static
resize matrix in padded-canvas space, at the sample's pad offset, its
columns reversed for a mirror; the gaussian blur (sigma 3) of the quality
and width canvases folded into them; (4) the image padded with the 0-1
CLIP mean on a 0-255 image (a reference quirk, kept) as warp(img - mean) +
mean; (5) /255 and BGR -> RGB, depth as channel 3, and sin/cos(2 ang) of
the degree-unit canvas after the warp (a reference quirk, kept).  Every
product is f32 and needs TF32 off
(``engine/crog_engine.py:set_exact_fp32_matmul``).  No augmentation
parameter is read back to the host.  Against the legacy host path the
quality and width differ by its uint8 quantization, about 2/255.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import numpy as np
import torch

from crog_tpu_torch.data.ocid_vlg import CLIP_MEAN
from crog_tpu_torch.data.rawwire import (
    _blur_matrix,
    _rasterize,
    pack_raster_params,
    unpack_mask_bits,
)
from crog_tpu_torch.ops.resize import downsample_masks, interp_matrix

SSG_RAW_KEYS = ("ssg_img_u8", "ssg_depth", "ssg_depth_u16", "ins_mask_bits",
                "ssg_rect_corners", "ssg_rect_vals", "aug")
# what a train step copies to the card, and what an eval forward does
SSG_RAW_STEP_KEYS = SSG_RAW_KEYS + ("boxes", "labels", "obj_valid")
SSG_RAW_EVAL_KEYS = ("ssg_img_u8", "ssg_depth", "ssg_depth_u16", "aug")
AUG_FIELDS = ("b_delta", "c_factor", "h1", "h2", "mirror", "pad_y0", "pad_x0")


def is_ssg_raw(batch: Dict) -> bool:
    return "ssg_img_u8" in batch


# ------------------------------------------------------------------ host side
def aug_params_vector(p: Dict) -> np.ndarray:
    """``DataAugmentor.draw`` dict -> the [7] f32 wire vector."""
    return np.asarray([float(p[k]) for k in AUG_FIELDS], np.float32)


def transform_boxes_host(boxes_px: np.ndarray, p: Dict, h0: int, w0: int) -> np.ndarray:
    """The augmentor's box arithmetic (mirror, pad offset, resize and
    normalize) on the host: normalized padded-canvas coordinates."""
    b = np.asarray(boxes_px, np.float32).reshape(-1, boxes_px.shape[-1]).copy()
    if p["mirror"]:
        x1 = b[:, 0].copy()
        b[:, 0] = w0 - b[:, 2]
        b[:, 2] = w0 - x1
    size = float(max(h0, w0))
    b[:, [0, 2]] = (b[:, [0, 2]] + p["pad_x0"]) / size
    b[:, [1, 3]] = (b[:, [1, 3]] + p["pad_y0"]) / size
    return b


def pack_ssg_raw(pre: Dict, augmentor, max_objs: int = 24, max_rects: int = 16) -> Dict:
    """A pre-augment sample (BGR f32 0-255 rgb, depth, bboxes [M, 5] in
    pixels, labels, ins_masks [M, H, W] 0/1, ins_grasp_rects [Ri, 6] each)
    -> a raw wire sample, the augmentation drawn here by ``augmentor.draw``."""
    rgb = pre["rgb"]
    h0, w0 = rgb.shape[:2]
    if w0 % 8:
        raise ValueError(f"bit-packed masks need a frame width divisible by 8, got {w0}")
    p = augmentor.draw(h0, w0)

    m = min(pre["ins_masks"].shape[0], max_objs)
    mask_bits = np.zeros((max_objs, h0, w0 // 8), np.uint8)
    if m:
        mask_bits[:m] = np.packbits(pre["ins_masks"][:m] > 0, axis=-1)
    corners = np.zeros((max_objs, max_rects, 4, 2), np.int32)
    vals = np.zeros((max_objs, max_rects, 3), np.float32)
    for i in range(m):
        corners[i], vals[i] = pack_raster_params(
            np.asarray(pre["ins_grasp_rects"][i], np.float64), max_rects)

    boxes = np.zeros((max_objs, 4), np.float32)
    labels = np.zeros((max_objs,), np.int32)
    valid = np.zeros((max_objs,), bool)
    if m:
        boxes[:m] = transform_boxes_host(pre["bboxes"][:m, :4], p, h0, w0)
        labels[:m] = pre["labels"][:m]
        valid[:m] = True
    return {
        "ssg_img_u8": np.clip(rgb, 0, 255).astype(np.uint8),
        # the depth is in [0, 1]: u16 costs at most 0.5/65535
        "ssg_depth_u16": np.round(np.clip(pre["depth"], 0.0, 1.0) * 65535.0
                                  ).astype(np.uint16),
        "ins_mask_bits": mask_bits,
        "ssg_rect_corners": corners,
        "ssg_rect_vals": vals,
        "aug": aug_params_vector(p),
        "boxes": boxes,
        "labels": labels,
        "obj_valid": valid,
        "ori_size": np.asarray(rgb.shape[:2], np.int32),
        "ins_grasp_rects": pre["ins_grasp_rects"][:m],
    }


def collate_ssg_raw(samples: List[Dict], slot_round: int = 4) -> Dict:
    """Stack raw wire samples; the ragged GT rects stay a list (the
    Jacquard check reads them on the host).  The instance axis is trimmed to
    the batch's largest object count rounded up to ``slot_round`` (the
    unpack's ``instance_chunk``); ``unpack_ssg_raw(pad_objs=...)`` pads the
    dense targets back."""
    out: Dict = {}
    for k in SSG_RAW_STEP_KEYS + ("ori_size",):
        if k in samples[0]:
            out[k] = np.stack([s[k] for s in samples])
    m_wire = out["obj_valid"].shape[1]
    occ = int(out["obj_valid"].sum(axis=1).max()) if m_wire else 0
    mb = min(m_wire, max(slot_round, -(-occ // slot_round) * slot_round))
    if mb < m_wire:
        for k in ("ins_mask_bits", "ssg_rect_corners", "ssg_rect_vals", "boxes",
                  "labels", "obj_valid"):
            out[k] = np.ascontiguousarray(out[k][:, :mb])
    out["ins_grasp_rects"] = [s["ins_grasp_rects"] for s in samples]
    return out


# --------------------------------------------------------------- device side
def _bgr_hsv(img: torch.Tensor):
    """cv2's float32 BGR -> (H, S, V) on [..., 3] tensors."""
    b, g, r = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), 0.0)
    mask = delta > 0
    safe = delta.clamp_min(1e-12)
    rc = torch.where(mask, (maxc - r) / safe, 0.0)
    gc = torch.where(mask, (maxc - g) / safe, 0.0)
    bc = torch.where(mask, (maxc - b) / safe, 0.0)
    h = torch.zeros_like(maxc)
    h = torch.where(maxc == r, bc - gc, h)
    h = torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, h)
    h = torch.where((maxc == b) & (maxc != r) & (maxc != g), 4.0 + gc - rc, h)
    return torch.remainder(h * 60.0, 360.0), s, maxc


def _hsv_bgr(h, s, v) -> torch.Tensor:
    h6 = torch.remainder(h, 360.0) / 60.0
    fl = torch.floor(h6)
    i = torch.remainder(fl.int(), 6)
    f = h6 - fl
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))

    def choose(opts):  # np.choose(i, opts)
        return torch.gather(torch.stack(opts, -1), -1, i.long()[..., None])[..., 0]

    return torch.stack([choose([p, p, t, v, v, q]), choose([t, v, v, q, p, p]),
                        choose([v, q, p, p, t, v])], dim=-1)


def _photometric_distort(img: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, 3] BGR f32 0-255, aug [B, 7]: brightness, contrast and
    the double hue shift of ``DataAugmentor._photometric_distort``."""
    a = aug[:, :, None, None]
    img = torch.clamp(img + a[:, 0, ..., None], 0.0, 255.0)
    img = torch.clamp(img * a[:, 1, ..., None], 0.0, 255.0)
    h, s, v = _bgr_hsv(img)
    h = torch.remainder(h + a[:, 2], 360.0)
    h = torch.remainder(h + a[:, 3], 360.0)
    return torch.clamp(_hsv_bgr(h, s, v), 0.0, 255.0)


@lru_cache(maxsize=None)
def _static_matrices(h0: int, w0: int, out: int, device: str, sigma: float = 3.0):
    """The [out, size] resize matrix in padded-canvas space (pad-to-square
    then resize is, per axis, this one matrix) and the [h0, h0] / [w0, w0]
    f32 blur matrices, on ``device``."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return (t(interp_matrix(max(h0, w0), out, "linear", False)),
            t(_blur_matrix(h0, sigma)), t(_blur_matrix(w0, sigma)))


def _axis_matrices(aug: torch.Tensor, h0: int, w0: int, out: int):
    """Per-sample row [B, out, H0] and column [B, out, W0] resample
    matrices, plain and with the blur folded in, built on the device from
    ``aug``: the static matrix's columns at pad + arange, reversed for a
    mirror."""
    wp, brow, bcol = _static_matrices(h0, w0, out, str(aug.device))
    size = wp.shape[1]
    ar_y = torch.arange(h0, device=aug.device)
    ar_x = torch.arange(w0, device=aug.device)
    pad_y = aug[:, 5].long().clamp(0, size - h0)
    pad_x = aug[:, 6].long().clamp(0, size - w0)
    cols_x = torch.where(aug[:, 4, None] > 0, w0 - 1 - ar_x, ar_x)
    wrow = wp[:, pad_y[:, None] + ar_y].permute(1, 0, 2)  # [B, out, H0]
    wcol = wp[:, pad_x[:, None] + cols_x].permute(1, 0, 2)  # [B, out, W0]
    return wrow, wcol, torch.matmul(wrow, brow), torch.matmul(wcol, bcol)


def _warp(x: torch.Tensor, wrow: torch.Tensor, wcol: torch.Tensor) -> torch.Tensor:
    """x [B, C, H0, W0] with per-sample wrow [B, S, H0] / wcol [B, S, W0]
    -> [B, C, S, S]."""
    y = torch.einsum("bsh,bchw->bcsw", wrow, x)
    return torch.einsum("btw,bcsw->bcst", wcol, y)


def _pad_inst(x: torch.Tensor, pad_objs: int) -> torch.Tensor:
    """Zero-pad the instance axis 1 to ``pad_objs``."""
    if pad_objs and x.shape[1] < pad_objs:
        pad = x.new_zeros((x.shape[0], pad_objs - x.shape[1]) + x.shape[2:])
        return torch.cat([x, pad], 1)
    return x


def unpack_ssg_raw(batch: Dict[str, torch.Tensor], img_size: int, with_depth: bool = True,
                   targets: bool = True, instance_chunk: int = 4, pad_objs: int = 0,
                   emit_ds: bool = False) -> Dict[str, torch.Tensor]:
    """Raw wire batch (tensors on one device) -> the dense layout of
    ``data/ocid_grasp.py:collate_ssg`` that the model and the loss take
    (img [B, S, S, 4], boxes, labels, obj_valid, ins_masks, grasp_qua /
    sin / cos / wid [B, M, S, S]); other keys pass through.

    ``targets=False`` unpacks only the image (the eval forward).
    ``pad_objs`` zero-pads the instance axis of the targets and of boxes /
    labels / obj_valid back to that count (0 keeps the wire's).  The
    instances are rasterized and warped ``instance_chunk`` at a time, which
    bounds the [B * chunk, H0, W0] raster canvases.  ``emit_ds`` returns
    the targets as the loss consumes them instead: ``ins_ds`` [B, M, S/4,
    S/4] and ``sem_ds`` [B, M, S/8, S/8] binarized, ``grasp_ds`` [B, 4, M,
    S/4, S/4] (qua, sin, cos, wid), each the
    ``downsample_masks`` of the full map that the loss takes, taken chunk by chunk so that the
    full-resolution maps of all instances never exist at once."""
    img8 = batch["ssg_img_u8"]
    b, h0, w0 = img8.shape[:3]
    aug = batch["aug"].float()
    wrow, wcol, wrow_b, wcol_b = _axis_matrices(aug, h0, w0, img_size)

    mean = torch.from_numpy(CLIP_MEAN).to(img8.device)
    img = _photometric_distort(img8.float(), aug) - mean
    img = _warp(img.permute(0, 3, 1, 2), wrow, wcol).permute(0, 2, 3, 1) + mean
    img = img.flip(-1) / 255.0  # BGR -> RGB

    out = {k: v for k, v in batch.items() if k not in SSG_RAW_KEYS}
    if with_depth and ("ssg_depth" in batch or "ssg_depth_u16" in batch):
        if "ssg_depth_u16" in batch:
            d0 = batch["ssg_depth_u16"].float() / 65535.0
        else:
            d0 = batch["ssg_depth"].float()
        depth = _warp(d0[:, None], wrow, wcol)
        out["img"] = torch.cat([img, depth.permute(0, 2, 3, 1)], -1)
    else:
        out["img"] = img
    for k in ("boxes", "labels", "obj_valid"):
        if k in out:
            out[k] = _pad_inst(out[k], pad_objs)
    if not targets:
        return out

    bits = batch["ins_mask_bits"]
    m = bits.shape[1]
    corners = batch["ssg_rect_corners"].int()
    vals = batch["ssg_rect_vals"].float()
    valid = batch["obj_valid"].float()[:, :, None, None]
    c = max(1, min(instance_chunk, m))
    ph, sh = img_size // 4, img_size // 8  # prototype and semantic-head maps
    parts = []
    for i0 in range(0, m, c):
        n = min(c, m - i0)
        sl = slice(i0, i0 + n)
        masks = unpack_mask_bits(bits[:, sl], w0)  # [B, n, H0, W0]
        pos, ang, wid = (x.reshape(b, n, h0, w0) for x in _rasterize(
            corners[:, sl].reshape(b * n, -1, 4, 2), vals[:, sl].reshape(b * n, -1, 3),
            h0, w0))
        ang_w = _warp(ang, wrow, wcol)
        maps = {"ins_masks": _warp(masks, wrow, wcol),
                "grasp_qua": _warp(pos, wrow_b, wcol_b),
                "grasp_wid": _warp(wid, wrow_b, wcol_b),
                "grasp_sin": torch.sin(2.0 * ang_w),
                # cos(0) = 1 would fill empty slots: gate by obj_valid
                "grasp_cos": torch.cos(2.0 * ang_w) * valid[:, sl]}
        if emit_ds:
            ins = maps.pop("ins_masks")
            maps = {"ins_ds": downsample_masks(ins, (ph, ph)),
                    "sem_ds": downsample_masks(ins, (sh, sh)),
                    "grasp_ds": torch.stack(
                        [downsample_masks(maps[f"grasp_{k}"], (ph, ph), False)
                         for k in ("qua", "sin", "cos", "wid")], 1)}
        parts.append(maps)
    for k in parts[0]:
        axis = 2 if k == "grasp_ds" else 1
        x = torch.cat([p[k] for p in parts], axis)
        out[k] = (_pad_inst(x.transpose(1, 2), pad_objs).transpose(1, 2) if axis == 2
                  else _pad_inst(x, pad_objs))
    return out
