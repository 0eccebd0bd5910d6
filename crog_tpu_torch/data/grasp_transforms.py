"""Grasp rectangle conversions and grasp-map rasterization.

Parity target: ``GraspTransforms`` (reference utils/dataset.py:607-682):
4-corner-point grasps <-> (cx, cy, w, h, theta, cls) with theta in (-90, 90],
and rasterized quality/angle/width maps (rects drawn at HALF width, gaussian
sigma 3 on quality and width, width normalized by ``width_factor``).  The
polygon fill and the blur run in the C++ host ops of crog_tpu_torch/native,
as crog_tpu's do; ``ops/rects.py:polygon_indices`` and
``ops/filters.py:gaussian_blur_np`` are their numpy twins.
"""

from __future__ import annotations

import numpy as np

from crog_tpu_torch import native
from crog_tpu_torch.ops.rects import box_points


class GraspTransforms:
    def __init__(self, width_factor: int = 100, width: int = 640, height: int = 480):
        self.width_factor = width_factor
        self.width = width
        self.height = height

    def __call__(self, grasp_rectangles: np.ndarray, target) -> np.ndarray:
        """[M, 4, 2] corner points -> [M, 6] (cx, cy, w, h, theta_deg, cls)."""
        m = grasp_rectangles.shape[0]
        p1, p2, p3, p4 = np.split(grasp_rectangles.astype(np.float64), 4, axis=1)
        center_x = (p1[..., 0] + p3[..., 0]) / 2
        center_y = (p1[..., 1] + p3[..., 1]) / 2
        width = np.hypot(p1[..., 0] - p4[..., 0], p1[..., 1] - p4[..., 1])
        height = np.hypot(p1[..., 0] - p2[..., 0], p1[..., 1] - p2[..., 1])
        theta = (
            np.arctan2(p4[..., 0] - p1[..., 0], p4[..., 1] - p1[..., 1])
            * 180.0
            / np.pi
        )
        theta = np.where(theta > 0, theta - 90.0, theta + 90.0)
        cls = np.tile(np.array([[target]], np.float64), (m, 1))
        return np.concatenate(
            [center_x, center_y, width, height, theta, cls], axis=1
        )

    def generate_masks(self, grasp_rectangles) -> dict:
        """Rasterize grasp maps (reference utils/dataset.py:643-682): each
        rect drawn at half width; quality/width maps gaussian-blurred; all
        returned uint8 like the reference (values then /255 downstream)."""
        pos = np.zeros((self.height, self.width))
        ang = np.zeros((self.height, self.width))
        wid = np.zeros((self.height, self.width))
        dirty = [self.height, self.width, -1, -1]  # y0, x0, y1, x1 inclusive
        for rect in grasp_rectangles:
            cx, cy, w_rect, h_rect, theta = rect[:5]
            box = box_points(
                ((cx, cy), (w_rect / 2.0, h_rect), -(theta + 180.0))
            ).astype(np.int64)
            dirty[0] = min(dirty[0], int(box[:, 1].min()))
            dirty[1] = min(dirty[1], int(box[:, 0].min()))
            dirty[2] = max(dirty[2], int(box[:, 1].max()))
            dirty[3] = max(dirty[3], int(box[:, 0].max()))
            ang_v = float(int(theta + 180) if theta < 0 else int(theta))
            wid_v = np.clip(w_rect, 0.0, self.width_factor) / self.width_factor
            # the reference clips rr<width and cc<height after rasterizing
            # (utils/dataset.py:658-664); the native fill skips the canvas
            # [cc, rr] writes off the canvas, which is the same set of pixels
            native.polygon_fill(pos, box[:, 0], box[:, 1], 1.0)
            native.polygon_fill(ang, box[:, 0], box[:, 1], ang_v)
            native.polygon_fill(wid, box[:, 0], box[:, 1], float(wid_v))
        qua = (_blur_dirty(pos, 3.0, dirty) * 255).astype(np.uint8)
        pos8 = (pos * 255).astype(np.uint8)
        ang8 = ang.astype(np.uint8)
        wid8 = (_blur_dirty(wid, 3.0, dirty) * 255).astype(np.uint8)
        return {"pos": pos8, "qua": qua, "ang": ang8, "wid": wid8}


def _blur_dirty(m: np.ndarray, sigma: float, dirty) -> np.ndarray:
    """Gaussian blur restricted to the dirty bounding box.

    The maps are zero outside the rect bbox; blurring a crop expanded by
    2*radius is EXACT (pixels within radius of the crop border are >= radius
    from any nonzero value, so replicated-edge padding sees only zeros or the
    true image edge).
    """
    y0, x0, y1, x1 = dirty
    if y1 < 0:  # nothing drawn
        return m
    h, w = m.shape
    r = int(4.0 * sigma + 0.5)
    cy0 = max(0, y0 - 2 * r)
    cy1 = min(h, y1 + 2 * r + 1)
    cx0 = max(0, x0 - 2 * r)
    cx1 = min(w, x1 + 2 * r + 1)
    out = np.zeros_like(m)
    out[cy0:cy1, cx0:cx1] = native.gaussian_blur(m[cy0:cy1, cx0:cx1], sigma)
    return out
