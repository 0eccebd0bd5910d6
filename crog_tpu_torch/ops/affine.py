"""Host-side affine warps.

Replacements for the OpenCV calls of the reference input pipeline
(cv2.getAffineTransform / cv2.warpAffine at utils/dataset.py:825-890).
The readers warp with ``crog_tpu_torch.native.warp_affine``, the C++
kernel (crog_tpu/ops/affine.py dispatches to the same); ``warp_affine_np``
here is its numpy twin, the tests' reference.

Interpolation numerics: bicubic uses the kernel with A = -0.75 (the OpenCV
INTER_CUBIC constant), bilinear is standard.  Out-of-range samples take a
constant border value.
"""

from __future__ import annotations

import numpy as np


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine mapping the 3 ``src`` points onto ``dst`` (cv2.getAffineTransform)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for i in range(3):
        a[i, 0:2] = src[i]
        a[i, 2] = 1.0
        a[i + 3, 3:5] = src[i]
        a[i + 3, 5] = 1.0
        b[i] = dst[i, 0]
        b[i + 3] = dst[i, 1]
    x = np.linalg.solve(a, b)
    return x.reshape(2, 3)


def letterbox_transform(ori_size, input_size):
    """Letterbox (aspect-preserving pad-to-square) affine + its inverse.

    Matches ``OCIDVLGDataset.get_transform_mat`` (reference
    utils/dataset.py:825-840): scale to fit, center with symmetric bias.
    Returns (mat, mat_inv), each 2x3 float64.
    """
    ori_h, ori_w = ori_size
    inp_h, inp_w = input_size
    scale = min(inp_h / ori_h, inp_w / ori_w)
    new_h, new_w = ori_h * scale, ori_w * scale
    bias_x, bias_y = (inp_w - new_w) / 2.0, (inp_h - new_h) / 2.0
    src = np.array([[0, 0], [ori_w, 0], [0, ori_h]], np.float32)
    dst = np.array(
        [[bias_x, bias_y], [new_w + bias_x, bias_y], [bias_x, new_h + bias_y]],
        np.float32,
    )
    mat = get_affine_transform(src, dst)
    mat_inv = get_affine_transform(dst, src)
    return mat, mat_inv


def invert_affine(mat: np.ndarray) -> np.ndarray:
    """2x3 affine inverse by the cofactor formula cv2.invertAffineTransform
    uses (imgproc) — bit-matching its float64 arithmetic order."""
    m = np.asarray(mat, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11 = m[1, 1] * d
    a22 = m[0, 0] * d
    a12 = -m[0, 1] * d
    a21 = -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def _fma32(a, b, c):
    """fmaf(a, b, c) for float32 arrays, emulated exactly: the f32*f32
    product is exact in float64 (24+24 < 53 mantissa bits), so one float64
    add + one rounding to f32 equals the fused result except in
    vanishing double-rounding corner cases."""
    return (
        np.asarray(a, np.float64) * np.asarray(b, np.float64)
        + np.asarray(c, np.float64)
    ).astype(np.float32)


def _cubic_weights_cv(f: np.ndarray):
    """OpenCV interpolateCubic (A = -0.75) evaluated in float32 with the
    last coefficient as 1 - c0 - c1 - c2, matching cv2's arithmetic."""
    A = np.float32(-0.75)
    one = np.float32(1.0)
    f = f.astype(np.float32)
    c0 = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A
    c1 = ((A + 2) * f - (A + 3)) * f * f + 1
    c2 = ((A + 2) * (one - f) - (A + 3)) * (one - f) * (one - f) + 1
    return [c0, c1, c2, one - c0 - c1 - c2]


def warp_affine_np(
    img: np.ndarray,
    mat: np.ndarray,
    out_size,
    interpolation: str = "linear",  # or "cubic", "nearest"
    border_value=0.0,
) -> np.ndarray:
    """Host warpAffine with cv2 (OpenCV 5) arithmetic parity.

    ``dst(x,y) = src(M^-1 @ (x,y,1))``; ``out_size`` is (width, height) to
    match the cv2 call convention used by the reference
    (utils/dataset.py:858-890).  ``img`` is HW or HWC uint8/float32; border
    is constant.

    Parity model:
      * inverse matrix by the cofactor formula in float64, cast to float32;
      * source coordinates ``inv @ (x, y, 1)`` computed in float32;
      * linear: two x-lerps then a y-lerp, each ``v0 + f*(v1-v0)`` with FMA
        contraction;
      * cubic: float32 coefficient polynomials (c3 = 1-c0-c1-c2) and
        FMA-chained 4-tap dot products, rows then columns;
      * nearest: round-half-even of the float32 coordinates;
      * uint8: borderValue saturate_cast to uint8 first; final value
        round-half-even then clipped.
    """
    out_w, out_h = out_size
    inv = invert_affine(mat).astype(np.float32)
    gx, gy = np.meshgrid(
        np.arange(out_w, dtype=np.float32), np.arange(out_h, dtype=np.float32)
    )
    sx = inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]
    sy = inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]

    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    border = np.broadcast_to(np.asarray(border_value, np.float64), (c,))
    if img.dtype == np.uint8:
        border = np.clip(np.rint(border), 0, 255)
    border = border.astype(np.float32)

    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(np.float32)[..., None]
    fy = (sy - y0).astype(np.float32)[..., None]

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return np.where(
            inside[..., None],
            img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(np.float32),
            border,
        )

    if interpolation == "nearest":
        out = tap(np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64))
    elif interpolation == "linear":
        v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
        v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
        p0 = _fma32(fx, v01 - v00, v00)
        p1 = _fma32(fx, v11 - v10, v10)
        out = _fma32(fy, p1 - p0, p0)
    elif interpolation == "cubic":
        wxs = _cubic_weights_cv(fx)
        wys = _cubic_weights_cv(fy)

        def dot4(wgt, vals):
            return _fma32(
                wgt[3], vals[3],
                _fma32(wgt[2], vals[2], _fma32(wgt[1], vals[1], wgt[0] * vals[0])),
            )

        rows = [
            dot4(wxs, [tap(x0 + i - 1, y0 + j - 1) for i in range(4)])
            for j in range(4)
        ]
        out = dot4(wys, rows)
    else:
        raise ValueError(f"unknown interpolation {interpolation}")

    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out
