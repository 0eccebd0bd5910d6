"""Optimizer assembly.

Counterpart of crog_tpu/engine/optim.py: Adam (AdamW when ``weight_decay`` >
0, decoupled like optax's ``adamw``) with two param groups -- backbone
parameters except any ``positional_embedding`` at ``lr_multi * base_lr``,
everything else at ``base_lr`` (``param_group_label``, 27) -- a per-step
MultiStepLR whose boundaries are ``milestone * steps_per_epoch`` and apply
from ``count >= boundary`` (``optax.piecewise_constant_schedule``), and
optional global-norm clipping first (``optax.clip_by_global_norm``).
Parameters that take no gradient (``backbone.logit_scale``, which the JAX
package does not have) are in no group.
"""

from __future__ import annotations

from typing import Iterable

import torch


def param_group_label(name: str) -> str:
    """'backbone' for CLIP tower parameters except positional embeddings."""
    if name.startswith("backbone.") and "positional_embedding" not in name:
        return "backbone"
    return "rest"


def multistep_factor(milestones: Iterable[int], gamma: float, steps_per_epoch: int):
    """step -> lr factor: gamma^k after k milestone epochs, by update count."""
    bounds = sorted(int(m) * steps_per_epoch for m in milestones)
    return lambda step: gamma ** sum(step >= b for b in bounds)


def make_optimizer(model: torch.nn.Module, base_lr: float, lr_multi: float,
                   milestones, lr_decay: float, steps_per_epoch: int,
                   weight_decay: float = 0.0):
    """(optimizer, scheduler).  Step the scheduler once after every
    optimizer step."""
    groups = {"backbone": [], "rest": []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[param_group_label(name)].append(p)
    param_groups = [
        {"params": groups["backbone"], "lr": base_lr * lr_multi, "name": "backbone"},
        {"params": groups["rest"], "lr": base_lr, "name": "rest"},
    ]
    if weight_decay > 0:
        opt = torch.optim.AdamW(param_groups, lr=base_lr, weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(param_groups, lr=base_lr)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, multistep_factor(milestones, lr_decay, steps_per_epoch))
    return opt, sched


def set_schedule_step(scheduler, step: int) -> None:
    """Move a ``make_optimizer`` scheduler to ``step`` updates (resume)."""
    scheduler.last_epoch = step
    for group, base, fn in zip(scheduler.optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(step)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * max_norm / ||g|| where the
    global norm is at least ``max_norm``.  No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
