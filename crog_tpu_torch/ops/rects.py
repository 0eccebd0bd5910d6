"""Rotated-rectangle geometry: corner extraction and rasterization.

Host-side replacements for cv2.boxPoints and skimage.draw.polygon as used by
the reference's grasp-mask generation (utils/dataset.py:643-682) and
rotated-rect IoU (utils/grasp_eval.py:305-347).
"""

from __future__ import annotations

import numpy as np


def box_points(rect) -> np.ndarray:
    """Corners of a rotated rect ((cx, cy), (w, h), angle_deg), OpenCV order.

    Equivalent to cv2.boxPoints: angle is clockwise degrees; returns 4 points
    float32 [4, 2] in the order (bl, tl, tr, br) relative to the rotation.
    """
    (cx, cy), (w, h), angle = rect
    rad = angle * np.pi / 180.0
    b = np.cos(rad) * 0.5
    a = np.sin(rad) * 0.5
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (2 * cx - p0[0], 2 * cy - p0[1])
    p3 = (2 * cx - p1[0], 2 * cy - p1[1])
    return np.array([p0, p1, p2, p3], dtype=np.float32)


def polygon_indices(r, c, shape=None):
    """Pixel indices inside a polygon — skimage.draw.polygon semantics.

    ``r``/``c`` are polygon vertices; returns (rr, cc) integer index arrays of
    interior points by even-odd ray casting over the polygon's bounding box,
    optionally clipped to ``shape``.
    """
    r = np.asarray(r, np.float64)
    c = np.asarray(c, np.float64)
    minr = int(max(0, r.min()))
    maxr = int(np.ceil(r.max()))
    minc = int(max(0, c.min()))
    maxc = int(np.ceil(c.max()))
    if shape is not None:
        maxr = min(shape[0] - 1, maxr)
        maxc = min(shape[1] - 1, maxc)
    if maxr < minr or maxc < minc:
        return np.empty(0, np.intp), np.empty(0, np.intp)
    rr, cc = np.meshgrid(
        np.arange(minr, maxr + 1), np.arange(minc, maxc + 1), indexing="ij"
    )
    inside = _points_in_polygon(rr.ravel(), cc.ravel(), r, c)
    return rr.ravel()[inside], cc.ravel()[inside]


def _points_in_polygon(pr, pc, vr, vc):
    """Vectorized even-odd rule (ray cast along +c)."""
    n = len(vr)
    inside = np.zeros(pr.shape, bool)
    j = n - 1
    for i in range(n):
        cond = (vr[i] > pr) != (vr[j] > pr)
        denom = vr[j] - vr[i]
        with np.errstate(divide="ignore", invalid="ignore"):
            xcross = (vc[j] - vc[i]) * (pr - vr[i]) / denom + vc[i]
        crossed = cond & (pc < xcross)
        inside ^= crossed
        j = i
    return inside


def polygon_mask(r, c, shape) -> np.ndarray:
    """Boolean mask of the polygon interior."""
    mask = np.zeros(shape, bool)
    rr, cc = polygon_indices(r, c, shape)
    mask[rr, cc] = True
    return mask


def rotated_rect_iou(rect_p, rect_gt, shape=(480, 640), angle_threshold=30.0):
    """Rasterized IoU of two grasp rects with the reference's 30-degree angle
    gate (utils/grasp_eval.py:305-347).  rect_p: (cx, cy, w, h, theta);
    rect_gt: (cx, cy, w, h, theta, cls)."""
    if (
        abs(rect_p[4] - rect_gt[4]) > angle_threshold
        and abs(rect_p[4] + rect_gt[4]) > angle_threshold
    ):
        return 0.0

    def rect_pixels(rect):
        cx, cy, w, h, theta = rect[:5]
        box = box_points(((cx, cy), (w, h), -theta)).astype(np.int64)
        # reference passes x-coords as the first polygon axis, then clips
        rr, cc = polygon_indices(box[:, 0], box[:, 1], shape)
        keep = (rr < shape[1]) & (cc < shape[0])
        return rr[keep], cc[keep]

    rr1, cc1 = rect_pixels(rect_gt)
    rr2, cc2 = rect_pixels(rect_p)
    area = np.zeros(shape, np.int32)
    area[cc1, rr1] += 1
    area[cc2, rr2] += 1
    union = int(np.sum(area > 0))
    inter = int(np.sum(area == 2))
    if union <= 0:
        return 0.0
    return inter / union
