"""Batchers: a sequential eval batcher and a shuffling train batcher.

``SequentialLoader`` collates samples in index order, with the JAX
package's tail-padding rule: a short last batch is padded to the full batch
size by repeating its last sample and carries ``n_valid``, the count of real
samples, so every batch has one shape and consumers slice outputs to
``n_valid``.  ``ShuffleLoader`` draws batches through ``EpochSampler``
(crog_tpu/data/loader.py:39): a ``np.random.RandomState(seed + epoch)``
shuffle, reseeded by ``set_epoch``, on one host.  Both load samples on the
caller's thread.  Both collate with ``collate_crog`` unless given another
``collate_fn`` (SSG's ``data/ocid_grasp.py:collate_ssg``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

_STACK_KEYS = (
    "img", "mask", "qua", "sin", "cos", "wid", "ang", "word", "inverse",
    "ori_size",
)
_LIST_KEYS = ("grasps", "sentence", "sent_id", "scene_id", "target", "bbox")


def collate_crog(samples: List[Dict]) -> Dict:
    """Stack tensors; keep ragged fields (grasps, sentences, ids) as lists
    (reference collate_fn, utils/dataset.py:1041-1064)."""
    batch: Dict = {}
    for k in _STACK_KEYS:
        if k in samples[0]:
            batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    for k in _LIST_KEYS:
        if k in samples[0]:
            batch[k] = [s[k] for s in samples]
    return batch


def pad_batch(batch: Dict, batch_size: int, n_valid: int) -> Dict:
    """Pad a short tail batch to ``batch_size`` by repeating the last sample,
    recording ``n_valid``."""
    out: Dict = {"n_valid": n_valid}
    pad = batch_size - n_valid
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n_valid:
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
        elif isinstance(v, list) and len(v) == n_valid:
            out[k] = v + [v[-1]] * pad
        else:
            out[k] = v
    return out


class EpochSampler:
    """DistributedSampler semantics on one host: seeded shuffle reseeded per
    epoch (``set_epoch``), optional ``drop_last``."""

    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, batch_size: int = 1):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.batch_size = batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def batches(self) -> Iterator[List[int]]:
        idx = np.arange(self.num_samples)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        for i in range(0, len(self) * self.batch_size, self.batch_size):
            yield idx[i : i + self.batch_size].tolist()

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)


class ShuffleLoader:
    """Train batches of ``dataset`` in ``EpochSampler`` order (drop_last)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True, collate_fn=collate_crog):
        self.dataset = dataset
        self.sampler = EpochSampler(len(dataset), shuffle, seed, drop_last, batch_size)
        self.collate_fn = collate_fn

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict]:
        for idx in self.sampler.batches():
            yield self.collate_fn([self.dataset[i] for i in idx])


class SequentialLoader:
    """Batches ``dataset`` in order, one sample at a time on the caller's
    thread."""

    def __init__(self, dataset, batch_size: int, pad_last_batch: bool = True,
                 collate_fn=collate_crog):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_last_batch = pad_last_batch
        self.collate_fn = collate_fn

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            idx = range(start, min(start + self.batch_size, n))
            batch = self.collate_fn([self.dataset[i] for i in idx])
            if self.pad_last_batch and len(idx) < self.batch_size:
                batch = pad_batch(batch, self.batch_size, len(idx))
            yield batch
