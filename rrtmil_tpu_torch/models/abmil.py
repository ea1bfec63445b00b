"""AB-MIL baselines and the zoo's shared stem.

Counterpart of `rrtmil_tpu/models/abmil.py` (reference modules/attmil.py):
`FeatureHead`, Linear(input_dim -> 512), the activation (relu, exact-erf
gelu or tanh), dropout, the bag mask and an optional injected `RRTEncoder`
(reference main.py:138-155, `--only_rrt_enc`); `ABMIL` (tanh attention
with biases) and `GatedABMIL` (gated attention without biases, whose stem
keeps relu and dropout 0.25 whatever `act` / `dropout` say, attmil.py:
55-110).  Every zoo model takes (x, mask, length, generator) and returns
logits (B, C); submodule names follow the flax tree (`feature.fc`,
`feature.rrt`, `attn_fc1`, ...), so `convert.flax_to_torch` maps the JAX
parameters as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RRTEncoderConfig
from .pool import masked_softmax
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


def _bag(x):
    return x[None] if x.dim() == 2 else x


class ABMIL(nn.Module):
    """attmil.DAttention (attmil.py:112-158): stem -> tanh attention (with
    biases) -> masked softmax pooling -> classifier; `return_pooled=True`
    also returns the pooled bag embedding (B, 512), which IBMIL's
    confounder pipeline clusters (data/confounders.py)."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 act: str = "relu", dropout: float = 0.25,
                 rrt: Optional[RRTEncoderConfig] = None):
        super().__init__()
        self.feature = FeatureHead(input_dim, act, dropout, rrt)
        self.attn_fc1 = nn.Linear(512, 128)
        self.attn_fc2 = nn.Linear(128, 1)
        self.classifier = nn.Linear(512, n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                return_pooled: bool = False):
        feat = self.feature(_bag(x), mask, length, generator).float()
        a = self.attn_fc2(torch.tanh(self.attn_fc1(feat))).transpose(-1, -2)
        a = masked_softmax(a, None if mask is None else mask[:, None, :])
        m = (a @ feat)[:, 0]
        logits = self.classifier(m)
        return (logits, m) if return_pooled else logits


class GatedABMIL(nn.Module):
    """attmil.AttentionGated (attmil.py:55-110): relu stem at dropout 0.25,
    gated attention without biases (act on the first branch, scorer
    dropout 0.25 when `dropout` is set), classifier."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 act: str = "relu", dropout: float = 0.25,
                 rrt: Optional[RRTEncoderConfig] = None):
        super().__init__()
        self.act = act
        self.scorer_dropout = bool(dropout)
        self.feature = FeatureHead(input_dim, "relu", 0.25, rrt)
        self.attention_a = nn.Linear(512, 128, bias=False)
        self.attention_b = nn.Linear(512, 128, bias=False)
        self.attention_c = nn.Linear(128, 1, bias=False)
        self.classifier = nn.Linear(512, n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        feat = self.feature(_bag(x), mask, length, generator).float()
        p = 0.25 if self.scorer_dropout else 0.0
        a = dropout(activation(self.act, self.attention_a(feat)), p,
                    generator, self.training)
        b = dropout(torch.sigmoid(self.attention_b(feat)), p, generator,
                    self.training)
        g = self.attention_c(a * b).transpose(-1, -2)
        g = masked_softmax(g, None if mask is None else mask[:, None, :])
        return self.classifier((g @ feat)[:, 0])
