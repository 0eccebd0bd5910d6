"""Data parallelism over processes (counterpart of crog_tpu/parallel/mesh.py).

The JAX package runs one program over a mesh of every device, the global
batch split along its ``data`` axis, and XLA inserts the gradient
all-reduce, the global BatchNorm statistics and the metric reductions.  The
port runs one process per card under ``torchrun`` and makes each of them
explicit:

- the gradient all-reduce: ``wrap_model`` (DistributedDataParallel);
- global BatchNorm statistics and SSG's global positive count:
  ``all_reduce_sum``, differentiable (``models/clip.py``,
  ``models/ssg_loss.py``);
- the train log's metrics: ``mean_over_ranks``;
- eval metrics: ``gather_metrics``, host arrays concatenated rank-major.

``init_from_env`` reads torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``; without ``WORLD_SIZE`` it creates no process group, and
every function here is then the identity of one process.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# the gloo group that host (numpy) data travels on, so that under NCCL it
# never has to go to the card: set by init_from_env
_HOST_GROUP = None


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu to "
            "run the plain PyTorch path)"
        )
    return device


def init_from_env(device_name: str = "cuda", backend: Optional[str] = None) -> torch.device:
    """The process's device, and under torchrun (``WORLD_SIZE`` set) its
    process group: ``cuda:LOCAL_RANK`` on the card (``nccl`` unless
    ``backend`` says otherwise), the CPU when ``device_name`` asks for it
    (``gloo``).  A group that already exists is kept, and so is its gloo
    side group for host data."""
    global _HOST_GROUP
    device = resolve_device(device_name)
    if "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://",
            world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
        _HOST_GROUP = None  # a side group of an earlier, destroyed group
    if _HOST_GROUP is None:
        _HOST_GROUP = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    return device


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead() -> bool:
    """Rank 0: the process that logs and writes files."""
    return rank() == 0


def barrier() -> None:
    if world() > 1:
        dist.barrier(group=_HOST_GROUP)


def per_rank(batch_size: int) -> int:
    """Each rank's share of a global train batch; it must split evenly."""
    if batch_size % world():
        raise ValueError(f"batch_size {batch_size} does not split over {world()} ranks")
    return batch_size // world()


def rank_seed(seed: int, rank: int) -> int:
    """A seed below 2^31 of rank ``rank``'s own, from the run's ``seed``
    (the counterpart of ``jax.random.fold_in(key, rank)``)."""
    digest = hashlib.sha256(f"{int(seed)}:{int(rank)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (identity at world 1)."""
    return _AllReduceSum.apply(x) if world() > 1 else x


class _ReplayedSum(torch.autograd.Function):
    """``total`` as the forward value, with ``_AllReduceSum``'s gradient to
    ``x``; saves no tensor, as ``_AllReduceSum`` saves none."""

    @staticmethod
    def forward(ctx, x, total):
        return total.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad, None


def replayed_sum(x: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum(x)`` without the collective, where ``total`` is what
    an earlier pass's ``all_reduce_sum`` of the same ``x`` returned: the
    recompute of a checkpointed block reads its forward's sums, so the
    ranks issue no second forward all-reduce and get the same bits."""
    return _ReplayedSum.apply(x, total)


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar metric averaged over the ranks (with equal per-rank
    batches, the global batch's mean), on the device: no host sync under
    NCCL."""
    if world() == 1:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    return dict(zip(keys, (stacked / world()).unbind()))


def gather_metrics(values) -> np.ndarray:
    """Every rank's host array, concatenated rank-major along the first
    axis; the lengths may differ (the reference's concat_all_gather).  One
    process: the array itself."""
    values = np.asarray(values)
    if world() == 1:
        return values
    parts = [None] * world()
    dist.all_gather_object(parts, values, group=_HOST_GROUP)
    return np.concatenate(parts)


def ddp(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``model`` under DistributedDataParallel.  BatchNorm statistics are
    global already (``models/clip.py``), so the buffers are not broadcast
    from rank 0 on every forward; every parameter that takes a gradient
    reaches the loss in every step, so DDP looks for no unused ones."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def wrap_model(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``ddp(model)`` at world > 1, else the model itself."""
    return ddp(model, device) if world() > 1 else model


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module a ``wrap_model`` result holds."""
    return getattr(model, "module", model)
