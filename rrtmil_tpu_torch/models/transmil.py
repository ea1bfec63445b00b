"""TransMIL baseline (reference modules/transmil.py).

Counterpart of `rrtmil_tpu/models/transmil.py`: fc1 -> act -> dropout 0.25
-> wrap-pad to the ceil-sqrt square with the bag's leading real tokens ->
cls token -> Nystrom layer -> PPEG -> Nystrom layer -> LayerNorm -> fc2 on
the cls row.  The JAX package computes it in plain XLA, outside any
Pallas kernel, so the port runs it as torch ops on either device: no
kernel of the port is launched.

The wrap-padding copies real tokens, so the model runs on exact-length
bags (`requires_exact`: the engine's exact mode, one bag a batch padded
to its true length); `length` selects the leading rows when the input
arrives longer (the survival engine passes its bucket's `repr_length`, as
the JAX package does).  The Nystrom layers' output dropout is fixed at
0.1 and fc1's at 0.25 whenever `dropout` is set, as in the JAX module.
The bag is read in float32 (flax's Dense promotes a bf16 `--amp` bag
against its float32 kernels), so `--amp` changes only the transfer.

Its own PPEG (`pos_layer`: `proj_weight` 7 x 7, `proj1_weight` 5 x 5,
`proj2_weight` 3 x 3 with biases, the image added once) is not
models/posemb.PPEG, which serves the RRT encoder's `--pos ppeg`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config import NystromConfig
from .abmil import activation
from .nystrom import NystromAttention
from .pool import dropout
from .posemb import DepthwiseConvs
from .rrt import LayerNorm


class _TransLayer(nn.Module):
    """x + NystromAttention(LN(x)) (transmil.py:26-44)."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.attn = NystromAttention(NystromConfig(
            dim=dim, head_dim=dim // 8, num_heads=8, num_landmarks=dim // 2,
            pinv_iterations=6, residual=True, dropout=0.1))

    def forward(self, x, generator=None):
        return x + self.attn(self.norm(x), generator)


class _PPEG(DepthwiseConvs):
    """Conv position encoding on the spatial tokens, the cls token passed
    through (transmil.py:47-61)."""

    def __init__(self, dim: int = 512):
        super().__init__(dim, (("proj_", 7), ("proj1_", 5), ("proj2_", 3)),
                         True, False)

    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        cls_tok, feat = x[:, :1], x[:, 1:]
        img = feat.transpose(1, 2).reshape(b, c, h, w)
        out = img
        for name, _, _ in self.taps:
            out = out + self.conv(name, img)
        out = out.reshape(b, c, h * w).transpose(1, 2)
        return torch.cat([cls_tok, out], dim=1)


class TransMIL(nn.Module):
    requires_exact = True     # the wrap-padding needs true-length bags

    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 act: str = "relu", dropout: float = 0.25,
                 cls_token_std: float = 1.0):
        super().__init__()
        self.act = act
        self.p = 0.25 if dropout else 0.0
        # std 1.0 in classification (transmil.py:80); the survival factory
        # passes 1e-6 (Survival/models/TransMIL/network.py:75-76)
        self.cls_token_std = cls_token_std
        self.fc1 = nn.Linear(input_dim, 512)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, 512))
        self.layer1 = _TransLayer()
        self.pos_layer = _PPEG()
        self.layer2 = _TransLayer()
        self.norm = LayerNorm(512)
        self.fc2 = nn.Linear(512, n_classes)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(0.0, self.cls_token_std, generator=generator)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        if x.dim() == 2:
            x = x[None]
        n = x.shape[1] if length is None else length
        h = activation(self.act, self.fc1(x[:, :n].float()))
        h = dropout(h, self.p, generator, self.training)

        side = int(math.ceil(math.sqrt(n)))
        add = side * side - n
        if add > 0:
            h = torch.cat([h, h[:, :add]], dim=1)
        h = torch.cat([self.cls_token.expand(h.shape[0], 1, 512), h], dim=1)

        h = self.layer1(h, generator)
        h = self.pos_layer(h, side, side)
        h = self.layer2(h, generator)
        return self.fc2(self.norm(h)[:, 0])
