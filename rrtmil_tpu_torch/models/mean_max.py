"""Mean / Max MIL baselines.

Counterpart of `rrtmil_tpu/models/mean_max.py` (reference
modules/mean_max.py:25-79): the `FeatureHead` stem, a per-instance
classifier, then a masked mean or a masked max over the instances (padded
rows take finfo.min before the max).  As in the JAX package, MaxMIL honours
`input_dim` (the reference hard-codes 1024).  Parameter names follow the
flax tree (`head.fc`, `classifier`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import RRTEncoderConfig
from .abmil import FeatureHead


class _InstanceMIL(nn.Module):
    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 act: str = "relu", dropout: float = 0.25,
                 rrt: Optional[RRTEncoderConfig] = None):
        super().__init__()
        self.head = FeatureHead(input_dim, act, dropout, rrt)
        self.classifier = nn.Linear(512, n_classes)

    def instance_logits(self, x, mask, length, generator):
        if x.dim() == 2:
            x = x[None]
        return self.classifier(self.head(x, mask, length, generator))


class MeanMIL(_InstanceMIL):
    """Per-instance logits averaged over the bag's true instances."""

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        h = self.instance_logits(x, mask, length, generator)
        if mask is None:
            return h.mean(dim=1)
        m = mask[..., None].to(h.dtype)
        return (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class MaxMIL(_InstanceMIL):
    """The largest per-instance logit of each class over the bag."""

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        h = self.instance_logits(x, mask, length, generator)
        if mask is not None:
            h = h.masked_fill(~mask[..., None].bool(),
                              torch.finfo(h.dtype).min)
        return h.max(dim=1).values
