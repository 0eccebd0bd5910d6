"""Experiment tracking (counterpart of crog_tpu/utils/tracking.py).

An append-only JSONL log, ``<output_dir>/metrics.jsonl``, that always works,
and a wandb passthrough when the package is importable and the user opts in
through ``WANDB_MODE`` (the reference forced wandb offline with a hardcoded
key, which is not replicated).  The train CLIs create it on rank 0 only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsTracker:
    """Append-only JSONL metrics log, wandb-API-shaped (init/log/finish)."""

    def __init__(self, output_dir: str, project: str = "crog_tpu",
                 name: Optional[str] = None, config: Optional[Dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._start = time.time()
        self._wandb = None
        if os.environ.get("WANDB_MODE", "") not in ("", "disabled"):
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(project=project, name=name,
                                         config=dict(config) if config else None)
        header = {"event": "init", "project": project, "name": name, "time": time.time()}
        if config:
            header["config"] = {k: v for k, v in dict(config).items()
                                if isinstance(v, (int, float, str, bool, list, type(None)))}
        self._write(header)

    def _write(self, record: Dict):
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {"event": "log", "step": step, "elapsed": time.time() - self._start}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        self._write(rec)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        self._write({"event": "finish", "elapsed": time.time() - self._start})
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


def _to_py(v):
    """A metric as a JSON value: numpy and torch scalars as Python numbers."""
    if isinstance(v, (np.generic, np.ndarray)):
        return v.item() if v.size == 1 else v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v
