"""LR schedule and optimizer construction.

Torch counterpart of ``ssdx/train/schedule.py``.  Same math: linear warmup
0 -> base_lr over ``warmup_steps``, then cosine decay base_lr -> min_lr over
the remaining steps, stepped once per optimizer step.  The optimizer is
``torch.optim.SGD`` with Nesterov momentum and weight decay added to the
gradient before momentum, which is the JAX package's
``optax.chain(add_decayed_weights, sgd(nesterov=True))``: decay applies to
every parameter (BN scales and biases included) and the first step's
momentum buffer is the gradient itself.

The plateau variant keeps the LR constant in the optimizer's
``param_groups``; a :class:`ReduceOnPlateau` controller, stepped once per
epoch with the validation loss, changes it through
:func:`set_learning_rate`.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

__all__ = [
    "warmup_cosine_schedule",
    "build_optimizer",
    "ReduceOnPlateau",
    "set_learning_rate",
    "get_learning_rate",
]


def warmup_cosine_schedule(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_lr: float = 0.0,
) -> Callable[[int], float]:
    """step -> LR, computed in float32 operation by operation as the JAX
    package's schedule is, so the two agree at every step."""
    if warmup_steps < 0:
        raise ValueError("warmup_steps must be >= 0")
    if total_steps <= 0:
        raise ValueError("total_steps must be > 0")
    if warmup_steps > total_steps:
        raise ValueError("warmup_steps cannot exceed total_steps")
    if min_lr > base_lr:
        raise ValueError("min_lr cannot be larger than base_lr")
    f = np.float32
    min_ratio = f(min_lr / base_lr if base_lr > 0 else 0.0)

    def schedule(step: int) -> float:
        s = f(step)
        if step < warmup_steps and warmup_steps > 0:
            factor = s / f(max(1.0, warmup_steps))
        else:
            progress = (s - f(warmup_steps)) / f(max(1.0, total_steps - warmup_steps))
            progress = np.clip(progress, f(0.0), f(1.0))
            cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * progress))
            factor = min_ratio + (f(1.0) - min_ratio) * cos
        return float(f(base_lr) * f(factor))

    return schedule


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    steps_per_epoch: int,
    max_epochs: int = 150,
    warmup_epochs: int = 5,
    base_lr: float = 3e-3,
    min_lr: float = 1e-6,
    momentum: float = 0.9,
    weight_decay: float = 5e-3,
    scheduler: str = "cosine",
    plateau_factor: float = 0.1,
    plateau_patience: int = 10,
    plateau_threshold: float = 1e-4,
    plateau_cooldown: int = 0,
):
    """SGD(momentum, nesterov) over ``params`` plus its LR control, sized from
    ``steps_per_epoch`` like the JAX package.  Returns ``(optimizer, sched)``.

    ``scheduler="cosine"``: ``sched`` is a ``LambdaLR`` of the warmup-cosine
    schedule; step it once after every optimizer step.
    ``scheduler="plateau"``: constant ``base_lr``; ``sched`` is a
    :class:`ReduceOnPlateau` controller for ``fit(lr_controller=...)``.
    """
    if scheduler not in ("cosine", "plateau"):
        raise ValueError(f"unknown scheduler {scheduler!r}")
    # lr=1.0 with LambdaLR: the group's LR is then the schedule's value itself
    lr = base_lr if scheduler == "plateau" else 1.0
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=True,
                          weight_decay=weight_decay)
    if scheduler == "plateau":
        return opt, ReduceOnPlateau(base_lr=base_lr, factor=plateau_factor,
                                    patience=plateau_patience, threshold=plateau_threshold,
                                    cooldown=plateau_cooldown, min_lr=min_lr)
    schedule = warmup_cosine_schedule(
        base_lr=base_lr,
        warmup_steps=warmup_epochs * steps_per_epoch,
        total_steps=max_epochs * steps_per_epoch,
        min_lr=min_lr,
    )
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


class ReduceOnPlateau:
    """Host-side reduce-LR-on-plateau controller (mode="min").

    An epoch *improves* when ``metric < best * (1 - threshold)``; after
    ``patience`` consecutive non-improving epochs the LR is multiplied by
    ``factor`` (floored at ``min_lr``) and a ``cooldown`` of epochs is
    ignored.
    """

    def __init__(
        self,
        base_lr: float,
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        cooldown: int = 0,
        min_lr: float = 0.0,
    ):
        if not 0.0 < factor < 1.0:
            raise ValueError("factor must be in (0, 1)")
        self.lr = float(base_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best: float | None = None
        self.num_bad = 0
        self.cooldown_left = 0

    def step(self, metric: float) -> float:
        """Record one epoch's validation metric; returns the current LR."""
        metric = float(metric)
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_left = self.cooldown
            self.num_bad = 0
        return self.lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the LR of every parameter group (plateau optimizers)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The LR of the first parameter group."""
    return float(optimizer.param_groups[0]["lr"])
