"""Raw uint8 wire format: the grasp maps are rasterized, blurred and
letterboxed on the device.

Counterpart of crog_tpu/data/rawwire.py.  The host ships per sample

  * ``raw_img_u8`` [H0, W0, 3]: the unwarped camera image, or ``lb_img_u8``
    [S, S, 3]: the image letterboxed on the host with the legacy uint8 warp
    (the "rawlb" wire, bit-exact legacy image numerics);
  * ``raw_mask_bits`` [H0, ceil(W0/8)] uint8: the unwarped 0/255 instance
    mask packed to bits, MSB-first;
  * ``rect_corners`` [R, 4, 2] int32 and ``rect_vals`` [R, 3] f32: each
    grasp's integer corners and its (angle in degrees, width, valid) canvas
    values, as the host rasterizer computes them;

and ``unpack_raw`` rebuilds the dense batch on the device: (1) the pos /
ang / wid canvases by the exact even-odd polygon test in int32, later rects
overwriting earlier ones; (2) the gaussian blur (sigma 3, truncate 4,
replicate edges) folded into the letterbox warp, since both are linear maps
along each axis; (3) the warp as two matrix products per plane in f32
(cubic for the image, linear for the mask and targets, constant-0 border;
the image is CLIP-normalized first through the 256-entry table, which makes
the zero border equal to cv2's CLIP-mean border); (4) degrees -> radians ->
sin/cos(2 theta) after the warp.  The products need TF32 off
(``engine.crog_engine.set_exact_fp32_matmul``).  Against the legacy host
path the targets differ by the legacy path's uint8 quantizations, bounded
by about 2/255 (tests/test_torch_wire.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from crog_tpu_torch.data.compact import normalize_image
from crog_tpu_torch.ops.affine import letterbox_transform
from crog_tpu_torch.ops.filters import _gaussian_kernel1d
from crog_tpu_torch.ops.rects import box_points
from crog_tpu_torch.ops.resize import affine_axis_matrix

RAW_KEYS = ("raw_img_u8", "lb_img_u8", "raw_mask_bits", "rect_corners", "rect_vals")


def is_raw(batch: Dict) -> bool:
    return "raw_img_u8" in batch or "lb_img_u8" in batch


def pack_mask_bits(mask_u8: np.ndarray) -> np.ndarray:
    """[H, W] 0/255 uint8 instance mask -> [H, ceil(W/8)] uint8 bit plane,
    MSB-first.  A non-binary mask has no 1-bit form and raises."""
    m = np.asarray(mask_u8)
    if m.dtype != np.bool_:
        bad = m[(m != 0) & (m != 255)]
        if bad.size:
            raise ValueError(
                f"pack_mask_bits requires a binary 0/255 mask; got values "
                f"{np.unique(bad)[:8]}; use the legacy or compact wire format "
                "for non-binary masks"
            )
    return np.packbits(m > 0, axis=-1)


def unpack_mask_bits(bits: torch.Tensor, w0: int) -> torch.Tensor:
    """Inverse of ``pack_mask_bits``: [..., H, ceil(W/8)] uint8 ->
    [..., H, w0] f32 0/1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    mask = ((bits.int()[..., None] >> shifts) & 1).float()
    return mask.reshape(*mask.shape[:-2], -1)[..., :w0]


def pack_raster_params(grasps: np.ndarray, max_rects: int = 16,
                       width_factor: float = 100.0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-rect integer corners and canvas values, padded to ``max_rects``:
    the per-rect host preparation of ``GraspTransforms.generate_masks``
    (corners at half width with the -(theta+180) angle, truncated to
    integers; angle int(theta+180) or int(theta); width clip(w)/factor).
    Later rects win overlaps, so past ``max_rects`` the last ones are kept."""
    grasps = np.asarray(grasps, np.float64).reshape(-1, grasps.shape[-1])
    if grasps.shape[0] > max_rects:
        grasps = grasps[grasps.shape[0] - max_rects:]
    corners = np.zeros((max_rects, 4, 2), np.int32)
    vals = np.zeros((max_rects, 3), np.float32)
    for i, rect in enumerate(grasps):
        cx, cy, w_rect, h_rect, theta = rect[:5]
        corners[i] = box_points(
            ((cx, cy), (w_rect / 2.0, h_rect), -(theta + 180.0))).astype(np.int64)
        vals[i, 0] = float(int(theta + 180) if theta < 0 else int(theta))
        vals[i, 1] = np.clip(w_rect, 0.0, width_factor) / width_factor
        vals[i, 2] = 1.0
    return corners, vals


@lru_cache(maxsize=None)
def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """[n, n] gaussian band matrix with replicate edges: the kernel of
    ``gaussian_blur_np`` (truncate 4)."""
    k = _gaussian_kernel1d(sigma).astype(np.float64)
    r = (len(k) - 1) // 2
    b = np.zeros((n, n), np.float64)
    idx = np.arange(n)
    for off in range(-r, r + 1):
        np.add.at(b, (idx, np.clip(idx + off, 0, n - 1)), k[off + r])
    return b


@lru_cache(maxsize=None)
def _letterbox_axis_matrices(ori_hw, input_size: int, sigma: float = 3.0):
    """Per-axis warp matrices of the letterbox: cubic (image), linear (mask,
    angle) and linear after the blur (quality, width)."""
    _, mat_inv = letterbox_transform(ori_hw, (input_size, input_size))
    sy, oy = float(mat_inv[1, 1]), float(mat_inv[1, 2])
    sx, ox = float(mat_inv[0, 0]), float(mat_inv[0, 2])
    h0, w0 = ori_hw
    row_lin = affine_axis_matrix(h0, input_size, sy, oy, "linear")
    col_lin = affine_axis_matrix(w0, input_size, sx, ox, "linear")
    return {
        "cub": (affine_axis_matrix(h0, input_size, sy, oy, "cubic"),
                affine_axis_matrix(w0, input_size, sx, ox, "cubic")),
        "lin": (row_lin, col_lin),
        "blur": ((row_lin.astype(np.float64) @ _blur_matrix(h0, sigma)).astype(np.float32),
                 (col_lin.astype(np.float64) @ _blur_matrix(w0, sigma)).astype(np.float32)),
    }


@lru_cache(maxsize=None)
def _device_matrices(ori_hw, input_size: int, device: str):
    return {k: tuple(torch.from_numpy(m).to(device) for m in v)
            for k, v in _letterbox_axis_matrices(ori_hw, input_size).items()}


def _rasterize(corners: torch.Tensor, vals: torch.Tensor, h0: int, w0: int):
    """[B, R, 4, 2] int32 corners -> pos / ang / wid canvases [B, H0, W0] f32.

    The host PNPOLY even-odd test with its division cross-multiplied into
    exact int32 arithmetic: bit-identical to the host rasterizer.  Corners
    are (x, y); the rects are drawn in order, so a later one overwrites an
    earlier one."""
    b, r_max = corners.shape[:2]
    dev = corners.device
    ys = torch.arange(h0, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w0, dtype=torch.int32, device=dev)[None, :]
    pos = torch.zeros(b, h0, w0, device=dev)
    ang = torch.zeros_like(pos)
    wid = torch.zeros_like(pos)
    for m in range(r_max):
        vx = corners[:, m, :, 0, None, None]  # [B, 4, 1, 1]
        vy = corners[:, m, :, 1, None, None]
        inside = torch.zeros(b, h0, w0, dtype=torch.bool, device=dev)
        for i in range(4):
            j = (i - 1) % 4
            vxi, vxj, vyi, vyj = vx[:, i], vx[:, j], vy[:, i], vy[:, j]
            cond = (vxi > xs) != (vxj > xs)
            # pc < (vyj - vyi) * (pr - vxi) / (vxj - vxi) + vyi, exactly:
            # (pc - vyi) * d < (vyj - vyi) * (pr - vxi), flipped for d < 0
            d = vxj - vxi
            lhs = (ys - vyi) * d
            rhs = (vyj - vyi) * (xs - vxi)
            inside = inside ^ (cond & torch.where(d > 0, lhs < rhs, lhs > rhs))
        inside = inside & (vals[:, m, 2] > 0)[:, None, None]
        pos = torch.where(inside, 1.0, pos)
        ang = torch.where(inside, vals[:, m, 0, None, None], ang)
        wid = torch.where(inside, vals[:, m, 1, None, None], wid)
    return pos, ang, wid


def _warp(x: torch.Tensor, wrow: torch.Tensor, wcol: torch.Tensor) -> torch.Tensor:
    """[B, H0, W0, ...] -> [B, S, S, ...] through the separable matrices."""
    y = torch.einsum("oh,bhw...->bow...", wrow, x)
    return torch.einsum("pw,bow...->bop...", wcol, y)


def unpack_raw(batch: Dict, input_size: int) -> Dict:
    """Raw wire batch (tensors on the device) -> the dense float batch the
    model sees, with the legacy pipeline's keys (img, mask, qua, wid, ang,
    sin, cos); other keys pass through.  With ``lb_img_u8`` the image was
    letterboxed on the host and only the table normalization runs here; the
    source frame is then read off the mask bit plane, so its width must be
    a multiple of 8 (OCID is 480 x 640)."""
    lb = "lb_img_u8" in batch
    if lb:
        img8 = batch["lb_img_u8"]
        bits = batch["raw_mask_bits"]
        h0, w0 = bits.shape[-2], bits.shape[-1] * 8
    else:
        img8 = batch["raw_img_u8"]
        h0, w0 = img8.shape[1:3]
    mats = _device_matrices((int(h0), int(w0)), int(input_size), str(img8.device))
    img = normalize_image(img8)
    out = {k: v for k, v in batch.items() if k not in RAW_KEYS}
    out["img"] = img if lb else _warp(img, *mats["cub"])
    out["mask"] = _warp(unpack_mask_bits(batch["raw_mask_bits"], w0), *mats["lin"])
    if "rect_corners" in batch:
        pos, ang, wid = _rasterize(batch["rect_corners"].int(), batch["rect_vals"].float(),
                                   h0, w0)
        out["qua"] = _warp(pos, *mats["blur"])
        out["wid"] = _warp(wid, *mats["blur"])
        ang_rad = _warp(ang, *mats["lin"]) * (np.pi / 180.0)
        out["ang"] = ang_rad
        out["sin"] = torch.sin(2.0 * ang_rad)
        out["cos"] = torch.cos(2.0 * ang_rad)
    return out
