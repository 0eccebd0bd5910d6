"""Qualitative figures: predicted grasps, grasp maps and the prototype
linear combination.

Counterpart of crog_tpu/utils/visualization.py.  The rect drawing is
numpy; the figures need matplotlib, imported where a figure is made.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from crog_tpu_torch.ops.rects import box_points


def _draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2):
    """Integer line rasterizer for annotation images."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    r = thickness // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            img[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)] = color


def draw_grasp_rects(img: np.ndarray, rects: Sequence) -> np.ndarray:
    """A copy of ``img`` with grasp rectangles (cx, cy, w, h, theta) drawn:
    gripper jaws red, fingers blue."""
    out = np.ascontiguousarray(img).copy()
    for rect in rects:
        cx, cy, w, h, theta = rect[:5]
        a, b, c, d = box_points(((cx, cy), (w, h), -(theta + 180.0))).astype(int)
        _draw_line(out, a, b, (255, 0, 0))
        _draw_line(out, d, c, (255, 0, 0))
        _draw_line(out, b, c, (0, 0, 255))
        _draw_line(out, a, d, (0, 0, 255))
    return out


def _figure(panels, shape, figsize, title: str, save_path: str, colorbar):
    """One figure of (image, title, imshow kwargs) panels on a ``shape``
    grid, written to ``save_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=figsize)
    for i, (data, name, kw) in enumerate(panels, start=1):
        ax = fig.add_subplot(*shape, i)
        im = ax.imshow(data, **kw)
        ax.set_title(name)
        ax.axis("off")
        if colorbar(kw):
            plt.colorbar(im)
    plt.suptitle(title, fontsize=20)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close(fig)
    return save_path


def visualize_grasp_prediction(img: np.ndarray, mask: np.ndarray, grasp_masks,
                               grasps: Sequence, text: str,
                               save_path: Optional[str] = None):
    """Six panels: RGB (uint8), predicted grasps, instance mask, quality,
    angle and width maps; written to ``save_path`` when given."""
    qua, ang, wid = grasp_masks
    jet = dict(cmap="jet", vmin=0, vmax=1)
    panels = [(img / 255.0, "RGB", {}),
              (draw_grasp_rects(img, grasps) / 255.0, "predicted grasps", {}),
              (mask, "predicted instance mask", {}),
              (qua, "Grasp quality", jet), (ang, "Grasp Angle", jet),
              (wid, "Grasp Width", jet)]
    if not save_path:
        return None
    return _figure(panels, (2, 3), (25, 10), text, save_path, bool)


def draw_proto_lincomb(protos: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """A 4 x 8 grid of the running sigmoid combination of the prototypes
    [ph, pw, P], taken in order of |coefficient|, thresholded at 0.5."""
    p_h, p_w, n = protos.shape
    idx = np.argsort(-np.abs(coeffs))
    arr_h, arr_w = 4, 8
    grid = np.zeros((p_h * arr_h, p_w * arr_w), np.float32)
    running = np.zeros((p_h, p_w), np.float32)
    for y in range(arr_h):
        for x in range(arr_w):
            i = arr_w * y + x
            if i >= n:
                break
            running = running + protos[:, :, idx[i]] * coeffs[idx[i]]
            nonlin = 1.0 / (1.0 + np.exp(-running))
            grid[y * p_h:(y + 1) * p_h, x * p_w:(x + 1) * p_w] = nonlin > 0.5
    return grid


def visualize_gt_sample(sample, save_path: str, annotated: Optional[np.ndarray] = None):
    """Ground-truth figure of a CROG dataset sample (CLIP-normalized HWC
    img, mask, qua / sin / cos / wid maps, optional depth): ``annotated`` is
    an optional frame with the ground-truth rects drawn."""
    from crog_tpu_torch.data.ocid_vlg import CLIP_MEAN, CLIP_STD

    img = np.clip(np.asarray(sample["img"], np.float32) * CLIP_STD + CLIP_MEAN, 0.0, 1.0)
    panels = [(img, "RGB", {})]
    if "depth" in sample:
        panels.append((np.asarray(sample["depth"]), "Depth", dict(cmap="gray")))
    panels.append((np.asarray(sample["mask"]), "Segm Mask", {}))
    if annotated is not None:
        panels.append((annotated, "Box & Grasp", {}))
    for key, name, kw in (("qua", "Grasp quality", dict(cmap="jet", vmin=0, vmax=1)),
                          ("sin", "Angle-sine", dict(cmap="rainbow", vmin=-1, vmax=1)),
                          ("cos", "Angle-cosine", dict(cmap="rainbow", vmin=-1, vmax=1)),
                          ("wid", "Width", dict(cmap="jet", vmin=0, vmax=1))):
        if key in sample:
            panels.append((np.asarray(sample[key]), name, kw))
    return _figure(panels, (2, 4), (25, 10), str(sample.get("sentence", "")), save_path,
                   lambda kw: "vmin" in kw)
