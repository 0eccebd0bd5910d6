"""Seeding.

Counterpart of crog_tpu/utils/seed.py ``set_random_seed``: host RNGs
(python, numpy: data order) are seeded, and the run's randomness on the
device comes from one explicit ``torch.Generator``, never the global torch
RNG.  That generator lives on the host: the train step draws from it one
seed per dropout site and launch (ops/dropout.py ``draw_seed``), and every
kernel and twin hashes that seed with the element's index, so the same
generator serves the CPU and the card and no draw waits for the device.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> torch.Generator:
    """Seed python and numpy and return the run's dropout generator."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
