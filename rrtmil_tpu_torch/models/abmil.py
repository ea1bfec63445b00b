"""The AB-MIL family's shared stem.

Counterpart of `rrtmil_tpu/models/abmil.py:23-51` (reference
modules/attmil.py): `FeatureHead`, Linear(input_dim -> 512), the activation
(relu, exact-erf gelu or tanh), dropout, the bag mask and an optional
injected `RRTEncoder` (reference main.py:138-155, `--only_rrt_enc`).  Only
the stem is ported; ABMIL itself comes with the zoo (ROADMAP.md queue 1
item 8).  Submodule names follow the flax tree (`fc`, `rrt`), so
`convert.flax_to_torch` maps the JAX parameters as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RRTEncoderConfig
from .rrt import RRTEncoder, dropout


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    name = name.lower()
    if name == "gelu":
        return F.gelu(x, approximate="none")
    if name == "tanh":
        return torch.tanh(x)
    return F.relu(x)


class FeatureHead(nn.Module):
    """Linear(input_dim -> 512) + act + dropout [+ RRT].  The bag is read in
    float32 (a bf16 `--amp` bag promoted against the float32 weights, as
    flax's Dense promotes it)."""

    def __init__(self, input_dim: int = 1024, act: str = "relu",
                 dropout: float = 0.25,
                 rrt: Optional[RRTEncoderConfig] = None):
        super().__init__()
        self.act = act
        self.p = dropout
        self.fc = nn.Linear(input_dim, 512)
        self.rrt = RRTEncoder(rrt) if rrt is not None else None

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        x = activation(self.act, self.fc(x.float()))
        x = dropout(x, self.p, generator, self.training)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        if self.rrt is not None:
            x = self.rrt(x, mask=mask, length=length, generator=generator)
        return x
