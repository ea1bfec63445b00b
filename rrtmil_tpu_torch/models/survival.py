"""Survival head: hazards = sigmoid(logits), S = cumprod(1 - hazards).

Counterpart of `rrtmil_tpu/models/survival.py`: one wrapper applies the
discrete-hazard tail (reference Survival/models/RRTMIL/network.py:791-794)
to a logits-producing backbone.  The submodule is named `backbone`, as in
the flax tree, so `convert.flax_to_torch` maps the JAX parameters as they
are.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class SurvivalHead(nn.Module):
    """Wraps a logits-producing backbone into (hazards, S)."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        out = self.backbone(x, mask=mask, length=length, generator=generator)
        logits = out[0] if isinstance(out, tuple) else out
        hazards = torch.sigmoid(logits.float())
        return hazards, torch.cumprod(1.0 - hazards, dim=-1)


def risk_score(survival: torch.Tensor) -> torch.Tensor:
    """risk = -sum(S) (reference Survival/models/RRTMIL/engine.py:79)."""
    return -torch.sum(survival, dim=-1)
