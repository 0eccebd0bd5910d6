"""Host input pipeline: sampling, collation, prefetch and the copy to the
card (counterpart of crog_tpu/data/loader.py).

``DataLoader`` draws index batches from ``EpochSampler`` (a
``np.random.RandomState(seed + epoch)`` shuffle reseeded by ``set_epoch``,
each host taking every ``num_hosts``-th index from ``host_id``), loads the
samples on a persistent pool (threads, or with ``num_procs > 0`` processes
started by forkserver), collates them on a producer thread and hands them
over through a bounded queue of ``prefetch`` batches.  A short last batch
is dropped (``drop_last``) or padded to the full size by repeating its
last sample (``pad_last_batch``; it then carries ``n_valid``, the count of
real samples).  With a ``device_put_fn`` (``DevicePut``), a second thread
copies each batch to the card while the next one is collated.  An
exception in a worker, in collate or in the copy is re-raised in the
consumer.

``collate_crog`` stacks CROG samples; SSG passes its own ``collate_fn``
(``data/ocid_grasp.py:collate_ssg``, ``data/ssg_rawwire.py:collate_ssg_raw``).
``device_put_crog`` moves a batch's dense fields to a device.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

_STACK_KEYS = (
    "img", "mask", "qua", "sin", "cos", "wid", "ang", "word", "inverse",
    "ori_size", "img_u8", "planes_u8",
    "raw_img_u8", "lb_img_u8", "raw_mask_bits", "rect_corners", "rect_vals",
)
_LIST_KEYS = ("grasps", "sentence", "sent_id", "scene_id", "target", "bbox")
_COPIED = "copied_event"  # the CUDA event of a batch's copies (DevicePut)


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


def device_put_crog(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    """The dense fields ``keys`` of a batch (those it has) as tensors on
    ``device`` (crog_tpu/data/loader.py:283).  A numpy array bound for a
    card is copied into pinned host memory and from there with
    ``non_blocking=True`` on the current stream; a tensor already on
    ``device`` passes unchanged."""
    device = torch.device(device)
    out = {}
    for k in keys:
        if k not in batch:
            continue
        v = batch[k]
        if torch.is_tensor(v):
            out[k] = v.to(device)
            continue
        t = torch.as_tensor(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def to_host(x) -> np.ndarray:
    """A batch field as numpy, whether the put stage moved it or not."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class DevicePut:
    """The loader's host->device stage: a batch with every numpy field
    copied to ``device`` (ragged fields and ``n_valid`` stay on the host).

    It runs on the put thread, whose current stream orders nothing with
    the consumer's, so on a card the copies go to a side stream of its own
    and an event is recorded after them.  ``ready``, called by the loader
    on the consumer's thread, makes the consumer's current stream wait for
    that event and marks each tensor as used on that stream
    (``record_stream``), so that the caching allocator does not hand its
    memory out while the consumer's work is still queued."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None

    def __call__(self, batch: Dict) -> Dict:
        dense = [k for k, v in batch.items() if isinstance(v, np.ndarray)]
        out = dict(batch)
        if self.device.type != "cuda":
            out.update(device_put_crog(batch, dense, self.device))
            return out
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out.update(device_put_crog(batch, dense, self.device))
            event = torch.cuda.Event()
            event.record(self._stream)
        out[_COPIED] = event
        return out

    def ready(self, batch: Dict) -> Dict:
        event = batch.pop(_COPIED, None)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                if torch.is_tensor(v) and v.is_cuda:
                    v.record_stream(stream)
        return batch


def pad_batch(batch: Dict, batch_size: int, n_valid: int) -> Dict:
    """Pad a short tail batch to ``batch_size`` by repeating the last sample,
    recording ``n_valid``: every batch has one shape and the whole split is
    still scored (consumers slice outputs to ``n_valid``)."""
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


class Subset:
    """The samples of ``dataset`` at ``indices``, in that order."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class EpochSampler:
    """DistributedSampler semantics: seeded shuffle reseeded per epoch
    (``set_epoch``), per-host strides, optional ``drop_last``.  With
    ``drop_last`` the hosts stride over the first ``num_samples -
    num_samples % num_hosts`` indices of the order, so that every host
    takes the same number of steps (the ranks of a train step meet in its
    collectives)."""

    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, batch_size: int = 1, num_hosts: int = 1,
                 host_id: int = 0):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.batch_size = batch_size
        self.num_hosts = num_hosts
        self.host_id = host_id

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def batches(self) -> Iterable[List[int]]:
        idx = np.arange(self.num_samples)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        idx = idx[:self._strided()][self.host_id::self.num_hosts]
        for i in range(0, len(self) * self.batch_size, self.batch_size):
            yield idx[i : i + self.batch_size].tolist()

    def _strided(self) -> int:
        """How many indices of the order the hosts share out."""
        if self.drop_last:
            return self.num_samples - self.num_samples % self.num_hosts
        return self.num_samples

    def __len__(self):
        n = len(range(self.host_id, self._strided(), self.num_hosts))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


class _ProducerError:
    """A producer- or put-thread exception carried through the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_PROC_DS = None  # the dataset of a process-pool worker


def _proc_init(dataset):
    global _PROC_DS
    _PROC_DS = dataset


def _proc_get(i):
    return _PROC_DS[i]


class DataLoader:
    """Batches of ``dataset`` loaded on a persistent worker pool.

    ``num_workers`` threads load the samples, or with ``num_procs > 0`` that
    many processes: the warp and the raster are numpy and hold the
    interpreter lock for part of each sample, so threads scale only as far
    as numpy releases it.  The process pool starts by forkserver, never
    fork: by loader time this process has CUDA and threads running.  The
    dataset reaches each worker by pickle (a ``SampleCache`` arrives
    empty).  ``close`` shuts the pool down.

    ``wait_seconds`` and ``batch_count`` count, over the last iteration, the
    time the consumer spent waiting for a batch and the batches it got."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 collate_fn: Callable = collate_crog,
                 device_put_fn: Optional[Callable] = None, prefetch: int = 2,
                 num_hosts: int = 1, host_id: int = 0, pad_last_batch: bool = False,
                 num_procs: int = 0):
        self.dataset = dataset
        self.sampler = EpochSampler(len(dataset), shuffle, seed, drop_last, batch_size,
                                    num_hosts, host_id)
        self.collate_fn = collate_fn
        self.device_put_fn = device_put_fn
        self.num_workers = max(1, int(num_workers))
        self.num_procs = int(num_procs)
        self.prefetch = prefetch
        self.batch_size = batch_size
        self.pad_last_batch = pad_last_batch
        self.wait_seconds = 0.0
        self.batch_count = 0
        self._workers = None

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def _pool(self):
        if self._workers is None:
            if self.num_procs > 0:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor

                self._workers = ProcessPoolExecutor(
                    max_workers=self.num_procs,
                    mp_context=multiprocessing.get_context("forkserver"),
                    initializer=_proc_init, initargs=(self.dataset,))
                self._getter = _proc_get
            else:
                self._workers = ThreadPoolExecutor(max_workers=self.num_workers)
                self._getter = self.dataset.__getitem__
        return self._workers

    def close(self):
        """Shut the worker pool down (it is started again on the next
        iteration)."""
        if self._workers is not None:
            self._workers.shutdown(wait=True, cancel_futures=True)
            self._workers = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _bounded_put(q: queue.Queue, item, stop: threading.Event):
        """A put that gives up once the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _produce(self, q: queue.Queue, stop: threading.Event):
        # an exception is queued and re-raised in the consumer: ending the
        # thread on it would make a failed epoch look like a short one
        sentinel = None
        try:
            pool = self._pool()
            for idx in self.sampler.batches():
                if stop.is_set():
                    break
                batch = self.collate_fn(list(pool.map(self._getter, idx)))
                if self.pad_last_batch and len(idx) < self.batch_size:
                    batch = pad_batch(batch, self.batch_size, len(idx))
                self._bounded_put(q, batch, stop)
        except BaseException as exc:  # noqa: BLE001 -- re-raised in the consumer
            sentinel = _ProducerError(exc)
        finally:
            self._bounded_put(q, sentinel, stop)

    def _put_stage(self, qin: queue.Queue, qout: queue.Queue, stop: threading.Event):
        """The host->device copies on a thread of their own, so that they
        overlap the collation of the next batch."""
        sentinel = None
        try:
            while not stop.is_set():
                try:
                    item = qin.get(timeout=0.5)
                except queue.Empty:
                    continue
                if item is None:
                    break
                if isinstance(item, _ProducerError):
                    sentinel = item
                    break
                self._bounded_put(qout, self.device_put_fn(item), stop)
        except BaseException as exc:  # noqa: BLE001 -- re-raised in the consumer
            sentinel = _ProducerError(exc)
        finally:
            self._bounded_put(qout, sentinel, stop)

    def __iter__(self) -> Iterator[Dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        threads = [threading.Thread(target=self._produce, args=(q, stop), daemon=True)]
        ready = None
        if self.device_put_fn is not None:
            q2: queue.Queue = queue.Queue(maxsize=self.prefetch)
            threads.append(threading.Thread(target=self._put_stage, args=(q, q2, stop),
                                            daemon=True))
            q = q2
            ready = getattr(self.device_put_fn, "ready", None)
        for t in threads:
            t.start()
        self.wait_seconds, self.batch_count = 0.0, 0
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                self.batch_count += 1
                yield ready(item) if ready is not None else item
        finally:
            # also when the consumer abandons the iterator
            stop.set()
