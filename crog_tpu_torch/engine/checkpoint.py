"""Checkpoint / resume with ``torch.save``.

Counterpart of crog_tpu/engine/checkpoint.py (``save_checkpoint`` 44,
``restore_checkpoint`` 71, ``copy_best`` 113, ``_opt_fingerprint`` 29): each
epoch writes ``last_model`` holding the model state_dict (parameters and
BatchNorm statistics, reference key schema), the optimizer state, the
update count and the best-metric scalars; improvements are copied to
``best_iou_model`` / ``best_jindex_model``.  Resume restores all of it and
raises on an optimizer whose structure differs from the saved one.  The
``state_dict`` key is what the eval CLI loads.  Orbax checkpoints of the JAX
package are not read.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Dict, Optional

import torch

LAST = "last_model"
BEST_IOU = "best_iou_model"
BEST_J = "best_jindex_model"


def opt_fingerprint(optimizer: torch.optim.Optimizer) -> int:
    """Fingerprint of the optimizer's STRUCTURE: its class, and each
    group's hyperparameter keys and parameter shapes, so restoring into a
    differently configured optimizer is a loud error."""
    desc = [type(optimizer).__name__]
    for g in optimizer.param_groups:
        keys = ",".join(sorted(k for k in g if k != "params"))
        desc.append(keys + ":" + ";".join(str(tuple(p.shape)) for p in g["params"]))
    return int(hashlib.sha1("|".join(desc).encode()).hexdigest()[:15], 16)


def save_checkpoint(output_dir: str, model, optimizer, step: int, epoch: int,
                    best_iou: float = 0.0, best_jindex: float = 0.0,
                    prec: Optional[Dict[str, float]] = None, name: str = LAST) -> str:
    payload = {
        "state_dict": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "step": int(step),
        "meta": {
            "epoch": int(epoch),
            "best_iou": float(best_iou),
            "best_jindex": float(best_jindex),
            "opt_fingerprint": opt_fingerprint(optimizer),
            **{k: float(v) for k, v in (prec or {}).items()},
        },
    }
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore_checkpoint(path: str, model=None, optimizer=None) -> Dict:
    """Load ``path``.  With ``model`` (and ``optimizer``) given, their
    states are replaced in place (resume); the payload is returned."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if optimizer is not None:
        saved = payload["meta"].get("opt_fingerprint")
        current = opt_fingerprint(optimizer)
        if saved != current:
            raise ValueError(
                f"optimizer-state structure mismatch: checkpoint {path!r} was saved "
                f"with a different optimizer configuration (fingerprint {saved} != "
                f"current {current}). Rebuild the optimizer to match, or restore "
                "without it and load the model only."
            )
    if model is not None:
        model.load_state_dict(payload["state_dict"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return payload


def copy_best(output_dir: str, src: str, dst: str) -> None:
    """Record an improved checkpoint under a best-model name."""
    shutil.copyfile(os.path.join(output_dir, src), os.path.join(output_dir, dst))
