"""Static-shape image resizing as matrix products.

Counterpart of crog_tpu/ops/resize.py: each 1-D interpolation is a dense
(out, in) weight matrix built on the host in numpy with torch's coordinate
rules, and a 2-D resize is two small matmuls.

  align_corners=True : src = dst * (in-1) / (out-1)
  align_corners=False: src = (dst + 0.5) * in/out - 0.5   (clamped >= 0 for
                       linear; taps clamped to the edge for cubic)
  nearest            : src = floor(dst * in/out)
Cubic kernel uses A = -0.75.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_CUBIC_A = -0.75


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    A = _CUBIC_A
    out = np.where(
        x <= 1.0,
        ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A, 0.0),
    )
    return out


@lru_cache(maxsize=None)
def interp_matrix(
    in_size: int, out_size: int, mode: str, align_corners: bool
) -> np.ndarray:
    """Dense (out_size, in_size) float32 interpolation matrix."""
    w = np.zeros((out_size, in_size), np.float64)
    dst = np.arange(out_size, dtype=np.float64)
    if mode == "nearest":
        src = np.floor(dst * (in_size / out_size)).astype(np.int64)
        src = np.clip(src, 0, in_size - 1)
        w[np.arange(out_size), src] = 1.0
        return w.astype(np.float32)

    if align_corners:
        if out_size == 1:
            src = np.zeros(out_size)
        else:
            src = dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5

    if mode == "linear":
        if not align_corners:
            src = np.maximum(src, 0.0)
        x0 = np.floor(src).astype(np.int64)
        t = src - x0
        for dx, weight in ((0, 1.0 - t), (1, t)):
            xi = np.clip(x0 + dx, 0, in_size - 1)
            np.add.at(w, (np.arange(out_size), xi), weight)
    elif mode == "cubic":
        x0 = np.floor(src).astype(np.int64)
        t = src - x0
        for dx in (-1, 0, 1, 2):
            weight = _cubic_kernel(dx - t)
            xi = np.clip(x0 + dx, 0, in_size - 1)
            np.add.at(w, (np.arange(out_size), xi), weight)
    else:
        raise ValueError(f"unknown mode {mode}")
    return w.astype(np.float32)


def resize2d(x: torch.Tensor, out_hw, mode: str, align_corners: bool = False,
             exact: bool = True) -> torch.Tensor:
    """Resize an NHWC (or HWC / HW) tensor to ``out_hw`` with torch semantics.

    ``exact=True`` computes in fp32 (eval-metric numerics, GT resizes; the
    caller keeps TF32 off); ``exact=False`` stays in the input dtype, for
    model-internal feature upsampling.
    """
    out_h, out_w = out_hw
    h_axis = x.ndim - 3 if x.ndim >= 3 else 0
    in_h, in_w = x.shape[h_axis], x.shape[h_axis + 1]
    dtype = torch.float32 if exact else x.dtype
    wh = torch.from_numpy(interp_matrix(in_h, out_h, mode, align_corners))
    ww = torch.from_numpy(interp_matrix(in_w, out_w, mode, align_corners))
    wh = wh.to(device=x.device, dtype=dtype)
    ww = ww.to(device=x.device, dtype=dtype)
    y = torch.tensordot(wh, x.to(dtype), dims=([1], [h_axis]))
    y = torch.movedim(y, 0, h_axis)
    y = torch.tensordot(ww, y, dims=([1], [h_axis + 1]))
    y = torch.movedim(y, 0, h_axis + 1)
    return y.to(x.dtype)


def resize_bilinear(x, out_hw, align_corners: bool = False):
    """Bilinear resize in fp32 (crog_tpu/ops/resize.py:214), e.g. SSG's
    ground-truth downsample to prototype resolution."""
    return resize2d(x, out_hw, "linear", align_corners)


def resize_bicubic(x, out_hw, align_corners: bool = True):
    return resize2d(x, out_hw, "cubic", align_corners)


def resize_nearest(x, out_hw):
    return resize2d(x, out_hw, "nearest", False)


def upsample2x_bilinear(x, align_corners: bool = False):
    """2x bilinear upsample of NHWC, matching torch Upsample(scale_factor=2),
    in the incoming dtype."""
    h, w = x.shape[-3], x.shape[-2]
    return resize2d(x, (2 * h, 2 * w), "linear", align_corners, exact=False)


def batched_affine_axis_matrix(
    in_size: int,
    out_size: int,
    scale: torch.Tensor,
    offset: torch.Tensor,
    valid_out=None,
    mode: str = "cubic",
) -> torch.Tensor:
    """[B, out_size, in_size] warp matrices, one per sample: row o of matrix
    b samples ``src = scale[b]*o + offset[b]`` with a constant-0 border.  The
    kernel weight for input pixel i is K(src - i).  Rows at or beyond
    ``valid_out[b]`` are zeroed so padded output regions stay exactly 0."""
    dev = scale.device
    dst = torch.arange(out_size, dtype=torch.float32, device=dev)
    src = scale[:, None] * dst[None, :] + offset[:, None]
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    d = src[..., None] - i
    if mode == "cubic":
        a = _CUBIC_A
        ad = d.abs()
        w = torch.where(
            ad <= 1.0,
            ((a + 2.0) * ad - (a + 3.0)) * ad * ad + 1.0,
            torch.where(
                ad < 2.0, ((a * ad - 5.0 * a) * ad + 8.0 * a) * ad - 4.0 * a,
                torch.zeros_like(ad),
            ),
        )
    elif mode == "linear":
        w = (1.0 - d.abs()).clamp_min(0.0)
    else:
        raise ValueError(mode)
    if valid_out is not None:
        keep = dst[None, :] < valid_out.to(torch.float32)[:, None]
        w = w * keep[..., None]
    return w
