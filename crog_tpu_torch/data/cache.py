"""In-RAM sample cache (counterpart of crog_tpu/data/cache.py:57): each
sample is decoded and preprocessed once, and later epochs are served from
memory.

CROG's samples are deterministic per index (no random augmentation), so
serving epoch 1's sample dicts again is exact.  A dataset that augments in
``__getitem__`` (SSG's OCID-Grasp reader in train mode: its augmentor's
``mode`` is "train") is refused unless ``force``: the cache would freeze
epoch 1's draws.  ``max_bytes`` bounds the resident size; once it is full,
the remaining indices fall through to the dataset every epoch.  Cached
arrays are served without a copy; collate stacks (copies) them.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


def _sample_nbytes(sample) -> int:
    if isinstance(sample, dict):
        values = sample.values()
    elif isinstance(sample, (list, tuple)):
        values = sample
    else:
        values = (sample,)
    n = 0
    for v in values:
        if isinstance(v, np.ndarray):
            n += v.nbytes
        elif isinstance(v, (dict, list, tuple)):
            n += _sample_nbytes(v)
        elif isinstance(v, (bytes, str)):
            n += len(v)
        else:
            n += 8
    return n


class SampleCache:
    """Memoizing wrapper around a map-style dataset; thread-safe for the
    loader's thread pool.  A pickled copy (a process-pool worker) starts
    empty, so each worker process builds its own cache."""

    def __init__(self, dataset, max_bytes: Optional[int] = 4 << 30, force: bool = False):
        aug = getattr(dataset, "augmentor", None)
        if aug is not None and getattr(aug, "mode", "") == "train" and not force:
            raise ValueError(
                f"{type(dataset).__name__} applies random augmentation per "
                "__getitem__; caching would freeze epoch 1's draws. Pass "
                "force=True to cache anyway.")
        self.dataset = dataset
        self.max_bytes = max_bytes
        self._cache: Dict[int, object] = {}
        self._bytes = 0
        self._full = False
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        # the dataset's attributes (split, input_size, max_ori_size, ...)
        if name == "dataset":  # not set yet (while unpickling)
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def __getstate__(self):
        return {"dataset": self.dataset, "max_bytes": self.max_bytes}

    def __setstate__(self, state):
        self.__init__(state["dataset"], state["max_bytes"], force=True)

    @property
    def cached_bytes(self) -> int:
        return self._bytes

    @property
    def cached_count(self) -> int:
        return len(self._cache)

    def __getitem__(self, i: int):
        hit = self._cache.get(i)
        if hit is not None:
            return hit
        sample = self.dataset[i]
        if not self._full:
            with self._lock:
                if i not in self._cache:
                    nb = _sample_nbytes(sample)
                    if self.max_bytes is None or self._bytes + nb <= self.max_bytes:
                        self._cache[i] = sample
                        self._bytes += nb
                    else:
                        self._full = True
        return sample
