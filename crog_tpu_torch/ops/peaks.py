"""Batched grasp peak detection on the device.

Counterpart of crog_tpu/ops/peaks.py ``find_peaks`` (110),
``grasp_rects_from_values`` (195) and ``detect_grasp_peaks`` (213): the
reference's skimage ``peak_local_max`` (min_distance=2, threshold_abs=0.4,
utils/grasp_eval.py:289-302) as a 5x5 max-pool equality test plus
num_peaks rounds of argmax and suppression, for a whole batch at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def find_peaks(qua, num_peaks: int = 5, min_distance: int = 2,
               threshold_abs: float = 0.4, valid_hw=None):
    """[B, H, W] quality maps -> (pr, pc, valid), each [B, num_peaks], peaks
    in score-descending order.

    A peak is a local max of the (2d+1)^2 window (ties included), strictly
    above threshold, at least ``min_distance`` from the sample's border
    (``valid_hw`` [B, 2] gives each sample's true (h, w) in a zero-padded
    canvas), on a map that is not constant (skimage's trivial-image rule).
    The greedy walk then accepts the global argmax (lowest flat index among
    ties, as ``torch.argmax`` returns) and suppresses the open Chebyshev
    ball of radius ``min_distance`` around it.  A slot is valid only where
    its score is finite.
    """
    b, h, w = qua.shape
    k = 2 * min_distance + 1
    qf = qua.float()
    # constant(0) boundary of scipy's maximum_filter: clamp below at 0; the
    # pool's own padding is -inf
    pooled = F.max_pool2d(qf.clamp_min(0.0)[:, None], k, stride=1,
                          padding=k // 2)[:, 0]
    is_max = qf == pooled
    nontrivial = ~is_max.reshape(b, -1).all(dim=1)
    is_peak = is_max & (qf > threshold_abs) & nontrivial[:, None, None]
    rows = torch.arange(h, device=qua.device)[:, None]
    cols = torch.arange(w, device=qua.device)[None, :]
    if valid_hw is None:
        vh = torch.full((b, 1, 1), h, device=qua.device)
        vw = torch.full((b, 1, 1), w, device=qua.device)
    else:
        vh = valid_hw[:, 0].long()[:, None, None]
        vw = valid_hw[:, 1].long()[:, None, None]
    border = (
        (rows[None] >= min_distance)
        & (rows[None] < vh - min_distance)
        & (cols[None] >= min_distance)
        & (cols[None] < vw - min_distance)
    )
    is_peak = is_peak & border
    score = torch.where(is_peak, qf, torch.full_like(qf, -math.inf))
    prs, pcs, vals = [], [], []
    for _ in range(num_peaks):
        flat = score.reshape(b, h * w)
        idx = torch.argmax(flat, dim=1)
        v = torch.gather(flat, 1, idx[:, None])[:, 0]
        pr_i = idx // w
        pc_i = idx % w
        prs.append(pr_i)
        pcs.append(pc_i)
        vals.append(torch.isfinite(v))
        suppress = ((rows[None] - pr_i[:, None, None]).abs() < min_distance) & (
            (cols[None] - pc_i[:, None, None]).abs() < min_distance
        )
        score = score.masked_fill(suppress, -math.inf)
    return torch.stack(prs, 1), torch.stack(pcs, 1), torch.stack(vals, 1)


def grasp_rects_from_values(pr, pc, ang_at, wid_at, max_width: float = 100.0):
    """[B, K, 5] grasp rects (x, y, width_px, 20, angle_deg) from peak
    coordinates and the angle/width values at those peaks (reference
    detect_grasps, utils/grasp_eval.py:294-301)."""
    return torch.stack(
        [
            pc.float(),
            pr.float(),
            wid_at.float() * max_width,
            torch.full(pr.shape, 20.0, device=pr.device),
            ang_at.float() / math.pi * 180.0,
        ],
        dim=-1,
    )


def detect_grasp_peaks(qua, sin, cos, wid, num_peaks: int = 5,
                       min_distance: int = 2, threshold_abs: float = 0.4,
                       max_width: float = 100.0, valid_hw=None):
    """[B, H, W] quality / sin2t / cos2t / width maps -> (rects [B, K, 5],
    valid [B, K]): peaks of the quality map, angle and width read there."""
    b = qua.shape[0]
    pr, pc, valid = find_peaks(qua, num_peaks, min_distance, threshold_abs,
                               valid_hw)
    ang = torch.atan2(sin, cos) / 2.0
    bi = torch.arange(b, device=qua.device)[:, None]
    rects = grasp_rects_from_values(pr, pc, ang[bi, pr, pc], wid[bi, pr, pc],
                                    max_width)
    return rects, valid
