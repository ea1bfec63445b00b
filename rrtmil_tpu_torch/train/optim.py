"""Optimizers and LR schedules (counterpart of
`rrtmil_tpu/train/optim.py:22-59,191-243`; reference main.py:229-243 and the
survival scheduler zoo, Survival/utils/scheduler.py:4-17).

The JAX package rebuilds torch's Adam by hand (`scale_by_torch_adam`); here
torch's own optimizers are the same semantics: 'adam' is `torch.optim.Adam`
with L2 weight decay (added to the gradient before the moments), 'adamw'
`torch.optim.AdamW` (decoupled decay).  The engine sets each step's learning
rate on the param groups from `lr_at`, the schedule index (epoch or global
iteration) living in host code as torch's `scheduler.step()` does.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   lr: float, weight_decay: float = 1e-5
                   ) -> torch.optim.Optimizer:
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"optimizer {name!r} is not ported yet (the reference's "
                     f"RAdam, Lookahead and SGD are later slices): see "
                     f"ROADMAP.md queue 1")


def cosine_lr(base_lr: float, t: int, t_max: int, eta_min: float = 0.0) -> float:
    """torch CosineAnnealingLR(optimizer, T_max, eta_min) closed form."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2


def step_lr(base_lr: float, t: int, step_size: float, gamma: float = 0.2) -> float:
    """torch StepLR (reference main.py:241 uses step=num_epoch/2, gamma=0.2)."""
    return base_lr * gamma ** int(t // step_size)


def lr_at(schedule: str, base_lr: float, t: int, t_max: int,
          step_gamma: float = 0.2) -> float:
    """Closed-form LR at schedule index t (epoch or iteration)."""
    if schedule == "cosine":
        return cosine_lr(base_lr, min(t, t_max), t_max)
    if schedule == "step":
        return step_lr(base_lr, t, t_max / 2, step_gamma)
    if schedule == "exp":
        return base_lr * (0.1 ** t)           # ExponentialLR(0.1)
    if schedule in ("const", "None", "none"):
        return base_lr
    raise ValueError(f"unknown schedule {schedule!r}")


class PlateauLR:
    """torch ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
    patience=5) as the survival scheduler zoo uses it (scheduler.py:10):
    `step(metric)` after each epoch's validation returns the next lr."""

    def __init__(self, base_lr: float, factor: float = 0.2,
                 patience: int = 5, threshold: float = 0.01):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = math.inf
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr
