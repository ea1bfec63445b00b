"""Optimizers and LR schedules (counterpart of
`rrtmil_tpu/train/optim.py:20-59,134-188,191-310`; reference main.py:229-243,
the survival optimizers, Survival/utils/optimizer.py, and the survival
scheduler zoo, Survival/utils/scheduler.py:4-17).

The JAX package rebuilds torch's Adam by hand (`scale_by_torch_adam`); here
torch's own optimizers are the same semantics: 'adam' is `torch.optim.Adam`
with L2 weight decay (added to the gradient before the moments), 'adamw'
`torch.optim.AdamW` (decoupled decay), 'sgd' `torch.optim.SGD` with momentum
0.9 (JAX's `add_decayed_weights` + `trace(0.9)`: L2 decay, the buffer starts
as the first gradient).  'radam' / 'plainradam' are the reference's own RAdam
(`RAdam` below, not `torch.optim.RAdam`) and 'lookahead' its Lookahead over
Adam (`Lookahead`).  The engine sets each step's learning rate on the param
groups from `lr_at`, the schedule index (epoch or global iteration) living
in host code as torch's `scheduler.step()` does.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   lr: float, weight_decay: float = 1e-5):
    """A torch optimizer, or `Lookahead` (which exposes its inner Adam's
    `param_groups`, so the engines set the lr the same way)."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    if name in ("radam", "plainradam"):
        # one update rule in the reference (RAdam only caches the step size)
        return RAdam(params, lr=lr, weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, dampening=0.0,
                               weight_decay=weight_decay)
    if name == "lookahead":
        # define_optimizer: Lookahead(Adam(lr, wd)), alpha 0.5, k 6
        return Lookahead(torch.optim.Adam(params, lr=lr,
                                          weight_decay=weight_decay))
    raise ValueError(f"unknown optimizer {name!r}")


def fill_unreached_grads(model: torch.nn.Module) -> None:
    """A zero gradient for every trainable parameter the step's graph did
    not reach: JAX differentiates every leaf, so such a parameter still
    takes its optimizer step (weight decay, moments, step count), e.g.
    DSMIL's instance classifier under a loss on its bag logits alone, which
    reach it only through the critical instance's argmax.  CLAM's instance
    classifiers outside the bag's branch keep `grad=None`, so torch's
    optimizers skip them as the reference's do (clam.py:196-198; JAX's
    `_maybe_absent`)."""
    for name, p in model.named_parameters():
        if p.grad is None and p.requires_grad and \
                "instance_classifier" not in name:
            p.grad = torch.zeros_like(p)


class RAdam(torch.optim.Optimizer):
    """The reference's RAdam (Survival/utils/optimizer.py:26-170) as the JAX
    package computes it (`scale_by_ref_radam`), which differs from
    `torch.optim.RAdam`: eps is added to sqrt(v) before the 1/sqrt(1 - b2^t)
    bias correction, the step count is per parameter, below N_sma < 5 the
    step is momentum alone, and the weight decay is decoupled (p -= wd * lr
    * p) and touches only parameters that have a gradient.

    N_sma and the rectification are formed in float32, as the JAX package
    forms them: N_sma is 1999 less a term near 1990 in the first steps, so
    float32 rounding moves the rectified step by up to 0.6% at steps 6-12
    against the reference's float64 (both stay within the golden
    trajectories' tolerance, tests/test_optim_parity.py)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def rectification(t: int, b1: float, b2: float):
        """(N_sma >= 5, the factor on m / (sqrt(v) + eps) or on m) at step
        `t`, in float32."""
        f = np.float32
        tf = f(t)
        b1t, b2t = f(b1) ** tf, f(b2) ** tf
        n_max = f(2.0 / (1.0 - b2) - 1.0)
        n_sma = n_max - f(2.0) * tf * b2t / (f(1.0) - b2t)
        if n_sma >= 5:
            return True, float(np.sqrt(
                (f(1.0) - b2t) * (n_sma - f(4.0)) / (n_max - f(4.0))
                * (n_sma - f(2.0)) / n_sma * n_max / (n_max - f(2.0)))
                / (f(1.0) - b1t))
        return False, float(f(1.0) / (f(1.0) - b1t))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                state["step"] += 1
                rectified, factor = self.rectification(state["step"], b1, b2)
                if rectified:
                    u = m / v.sqrt().add_(eps) * factor
                else:
                    u = m * factor
                if wd != 0:
                    u.add_(p.float(), alpha=wd)
                p.copy_(p.float() - lr * u)
        return loss


class Lookahead:
    """The reference's Lookahead (Survival/utils/optimizer.py:175-224; JAX
    `lookahead`) around a torch optimizer: every `k` inner steps the slow
    weights move toward the fast ones, slow += alpha * (fast - slow), and
    the fast weights are set to them.  The slow buffer starts lazily: the
    first sync only seeds it with the fast weights and leaves the
    parameters as they are.  Parameters without a gradient at a sync are
    left alone (the reference's `continue`).  `param_groups` are the inner
    optimizer's, where the engines set each epoch's lr."""

    def __init__(self, optimizer: torch.optim.Optimizer, alpha: float = 0.5,
                 k: int = 6):
        self.optimizer = optimizer
        self.alpha = alpha
        self.k = k
        self.count = 0          # inner steps since the last sync
        self.synced = False     # the slow buffer seeded yet
        self.slow = [None] * len(self._params())

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.optimizer.step(closure)
        self.count += 1
        if self.count >= self.k:
            self.count = 0
            for i, p in enumerate(self._params()):
                if p.grad is None:
                    continue
                if self.slow[i] is None:
                    self.slow[i] = p.detach().clone()
                    continue
                self.slow[i].add_(p - self.slow[i], alpha=self.alpha)
                p.copy_(self.slow[i])
            self.synced = True
        return loss

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(), "slow": self.slow,
                "count": self.count, "synced": self.synced,
                "alpha": self.alpha, "k": self.k}

    def load_state_dict(self, state) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        params = self._params()
        self.slow = [None if s is None else s.to(p.device).clone()
                     for s, p in zip(state["slow"], params)]
        self.count, self.synced = int(state["count"]), bool(state["synced"])
        self.alpha, self.k = float(state["alpha"]), int(state["k"])


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
