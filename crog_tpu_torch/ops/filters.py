"""Host gaussian filtering, mirroring skimage.filters.gaussian defaults
(mode='nearest', truncate=4.0) used in grasp-mask generation (reference
utils/dataset.py:673-676)."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def gaussian_blur_np(img: np.ndarray, sigma: float) -> np.ndarray:
    return ndimage.gaussian_filter(
        img.astype(np.float64), sigma=sigma, mode="nearest", truncate=4.0
    )
