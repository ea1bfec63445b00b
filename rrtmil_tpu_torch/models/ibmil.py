"""IBMIL: interventional AB-MIL with confounder deconfounding (reference
modules/attmil_ibmil.py:44-102).

Counterpart of `rrtmil_tpu/models/ibmil.py`: the shared stem
(`embedding`, a `FeatureHead` with the optional injected RRT encoder,
`--only_rrt_enc`), tanh attention pooling over the bag's true tokens, and,
with confounders, a cross-attention of the bag embedding against the fixed
(P, 512) k-means prototypes (data/confounders.py): W_q and W_k into a
128-wide joint space, a softmax over the prototypes scaled by sqrt(128),
the attended prototype summary concatenated before `head`.  The
prototypes are a non-persistent buffer: the state_dict holds the flax
tree's parameters alone, and the harness loads the prototypes from their
file for every fold.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import RRTEncoderConfig
from .abmil import FeatureHead
from .pool import masked_softmax


class IBMIL(nn.Module):
    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 act: str = "relu", dropout: float = 0.25,
                 rrt: Optional[RRTEncoderConfig] = None,
                 confounders=None, joint_dim: int = 128):
        super().__init__()
        self.embedding = FeatureHead(input_dim, act, dropout, rrt)
        self.attn_fc1 = nn.Linear(512, 128)
        self.attn_fc2 = nn.Linear(128, 1)
        self.joint_dim = joint_dim
        if confounders is not None:
            conf = torch.from_numpy(np.asarray(confounders, np.float32))
            self.register_buffer("confounders", conf, persistent=False)
            self.W_q = nn.Linear(512, joint_dim)
            self.W_k = nn.Linear(conf.shape[1], joint_dim)
            head_in = 512 + conf.shape[1]
        else:
            self.confounders = None
            head_in = 512
        self.head = nn.Linear(head_in, n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        if x.dim() == 2:
            x = x[None]
        feat = self.embedding(x, mask, length, generator).float()
        a = self.attn_fc2(torch.tanh(self.attn_fc1(feat))).transpose(-1, -2)
        a = masked_softmax(a, None if mask is None else mask[:, None, :])
        m = (a @ feat)[:, 0]                                  # (B, 512)
        if self.confounders is not None:
            conf = self.confounders
            bag_q = self.W_q(m)                               # (B, J)
            conf_k = self.W_k(conf)                           # (P, J)
            # softmax over the prototypes (attmil_ibmil.py:96-97)
            da = torch.softmax((conf_k @ bag_q.t())
                               / math.sqrt(self.joint_dim), dim=0)
            m = torch.cat([m, da.t() @ conf], dim=1)
        return self.head(m)
