"""Gaussian filtering.

The host path mirrors skimage.filters.gaussian defaults (mode='nearest',
truncate=4.0) used in grasp-mask generation (reference
utils/dataset.py:673-676): the grasp maps take the C++ blur
``native.gaussian_blur`` (crog_tpu/ops/filters.py ``gaussian_blur_np``
dispatches to the same), and ``gaussian_blur_np`` here is its scipy twin,
the tests' reference; ``gaussian_blur`` is the separable device version
of crog_tpu/ops/filters.py ``gaussian_blur_jax`` (38) that smooths SSG's
quality maps in eval (reference utils/grasp_eval.py:198).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy import ndimage


def gaussian_blur_np(img: np.ndarray, sigma: float) -> np.ndarray:
    return ndimage.gaussian_filter(
        img.astype(np.float64), sigma=sigma, mode="nearest", truncate=4.0
    )


@lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of [..., H, W] in fp32 with edge ('nearest')
    padding: along H, then along W, each a tap-by-tap weighted sum."""
    k = _gaussian_kernel1d(float(sigma)).tolist()
    r = (len(k) - 1) // 2
    h, w = img.shape[-2:]
    x = img.float()
    rows = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    xp = x[..., rows, :]
    x = sum(k[i] * xp[..., i:i + h, :] for i in range(len(k)))
    cols = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    xp = x[..., cols]
    x = sum(k[i] * xp[..., i:i + w] for i in range(len(k)))
    return x.to(img.dtype)
