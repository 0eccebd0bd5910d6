"""Profiling hooks (counterpart of crog_tpu/utils/profiling.py): a
torch.profiler trace around a region, and a step timer that waits for the
device before it reads the clock (PyTorch returns before the card
finishes)."""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the region with torch.profiler (the host, and the card's
    kernels where a card exists) into ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``, for TensorBoard or chrome://tracing); yields the
    profiler, or None and does nothing without a directory."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def _first_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    items = x.values() if isinstance(x, dict) else x
    for item in items:
        try:
            return _first_tensor(item)
        except TypeError:
            continue
    raise TypeError(f"no tensor in {type(x).__name__}")


def force_sync(x) -> float:
    """Wait for the device of the first tensor in ``x`` (a tensor, or a
    dict, list or tuple holding one), then read its first element."""
    t = _first_tensor(x)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


class StepTimer:
    """Median step time, each step ending when its result is on hand."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            force_sync(result)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def median_ms(self) -> float:
        return 1000.0 * float(np.median(self.times)) if self.times else 0.0
