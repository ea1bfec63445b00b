"""MIL aggregation heads: AB-MIL attention pooling and masked mean.

Counterpart of `rrtmil_tpu/models/pool.py` (reference modules/datten.py:5-101)
for the ungated head.  Bags arrive padded to a bucket length, so the softmax
over instances takes the boolean mask of true tokens; masked places are
filled with finfo(float32).min, not -inf (pool.py:26-30).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="none"),
         "tanh": torch.tanh}


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=dim)


class Attention(nn.Module):
    """2-layer attention scorer L=512 -> D=128 -> K=1 (datten.py:5-38)."""

    def __init__(self, input_dim: int = 512, act: str = "relu",
                 bias: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, 128, bias=bias)
        self.fc2 = nn.Linear(128, 1, bias=bias)
        self.act = _ACTS[act]

    def forward(self, x, mask=None):
        a = self.fc2(self.act(self.fc1(x))).transpose(-1, -2)   # (B, 1, N)
        a = masked_softmax(a, None if mask is None else mask[:, None, :])
        return a @ x                                             # (B, 1, C)


class DAttention(nn.Module):
    """Dispatch wrapper (datten.py:85-101): returns pooled (B, C).  The
    scorer's dropout (PoolConfig.dropout, off in every canonical config) is
    not ported: train mode with it on raises."""

    def __init__(self, input_dim: int = 512, act: str = "relu",
                 gated: bool = False, bias: bool = False,
                 dropout: bool = False):
        super().__init__()
        if gated:
            raise NotImplementedError(
                "gated attention pooling is not ported yet (ROADMAP.md "
                "queue 1)")
        self.dropout = dropout
        self.attention = Attention(input_dim, act, bias)

    def forward(self, x, mask=None):
        if self.training and self.dropout:
            raise NotImplementedError("the pooling scorer's dropout is not "
                                      "ported yet (ROADMAP.md queue 1)")
        return self.attention(x, mask).squeeze(1)


class MeanPool(nn.Module):
    """Masked mean over instances (reference modules/rrt.py:221)."""

    def forward(self, x, mask=None, **_):
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        m = mask[..., None].to(x.dtype)
        return (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
