"""DSMIL: dual-stream MIL (reference modules/dsmil.py:59-135).

Counterpart of `rrtmil_tpu/models/dsmil.py`, at batch 1.  The instance
stream classifies every patch; the bag stream attends from each patch's
query to the queries of each class's critical instance (the masked argmax
of the instance logits) and mixes the class embeddings with a
Conv1d(C, C, kernel=512) head, kept as the raw (C, C, 512) parameter
`fcc_kernel` (with `fcc_bias`), U(+-1/sqrt(C 512)) as torch's Conv1d
default init draws it, so `convert.py` carries it unchanged.  With an
injected encoder only the instance classifier reads its output: the bag
stream reads the stem's (dsmil.py:88-99).  The forward returns (bag
logits, max-pooled instance logits, ps); the engine applies the criterion
to the second (the reference's `max_loss`, main.py:445-457).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import RRTEncoderConfig
from .abmil import activation
from .pool import masked_softmax
from .rrt import RRTEncoder, dropout


def _masked(c, mask):
    if mask is None:
        return c
    return torch.where(mask[:, None], c, torch.finfo(c.dtype).min)


class BClassifier(nn.Module):
    """Bag stream (dsmil.py:59-94)."""

    def __init__(self, n_classes: int = 2):
        super().__init__()
        self.n_classes = n_classes
        self.q = nn.Linear(512, 128)
        self.fcc_kernel = nn.Parameter(torch.empty(n_classes, n_classes, 512))
        self.fcc_bias = nn.Parameter(torch.empty(n_classes))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.n_classes * 512)
        with torch.no_grad():
            self.fcc_kernel.uniform_(-bound, bound, generator=generator)
            self.fcc_bias.uniform_(-bound, bound, generator=generator)

    def forward(self, feats, c, mask=None):
        """feats (N, 512), c (N, C) instance logits -> (1, C)."""
        q = self.q(feats)                                       # (N, 128)
        crit = torch.argmax(_masked(c, mask), dim=0)            # (C,)
        q_max = self.q(feats[crit])                             # (C, 128)
        a = (q @ q_max.T) / math.sqrt(q.shape[1])               # (N, C)
        a = masked_softmax(a, None if mask is None else mask[:, None], dim=0)
        b = a.T @ feats                                         # (C, 512)
        logits = torch.einsum("cv,ocv->o", b, self.fcc_kernel) + self.fcc_bias
        return logits[None]


class DSMIL(nn.Module):
    """MILNet (dsmil.py:96-135): (bag logits (1, C), max-instance logits
    (1, C), ps)."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 act: str = "relu", dropout: float = 0.25,
                 rrt: Optional[RRTEncoderConfig] = None):
        super().__init__()
        self.act, self.p = act, dropout
        self.patch_to_emb = nn.Linear(input_dim, 512)
        self.rrt = RRTEncoder(rrt) if rrt is not None else None
        self.i_classifier = nn.Linear(512, n_classes)
        self.b_classifier = BClassifier(n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        if x.dim() == 3:
            x, mask = x[0], (None if mask is None else mask[0])
        ps = x.shape[0]
        h = activation(self.act, self.patch_to_emb(x.float()))
        h = dropout(h, self.p, generator, self.training)
        if mask is not None:
            h = h * mask[:, None].to(h.dtype)
        hr = h
        if self.rrt is not None:
            hr = self.rrt(h[None], mask=None if mask is None else mask[None],
                          length=length, generator=generator)[0].float()
        classes = self.i_classifier(hr)                         # (N, C)
        bag = self.b_classifier(h, classes, mask)
        return bag, _masked(classes, mask).max(dim=0).values[None], ps


def load_warm_start(model: DSMIL, path: str) -> None:
    """The reference's dsmil_init warm start (main.py:215-218), non-strict:
    of a torch `.pth` state_dict or an `.npz` of the same keys, only
    `b_classifier.q.weight` / `.bias` are read (the checkpoint's
    `b_classifier.v.*` keys belong to the passing_v model and are dropped).
    Both files hold torch's (out, in) weight layout."""
    if path.endswith(".npz"):
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
              np.load(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    q = model.b_classifier.q
    with torch.no_grad():
        for key, p in (("b_classifier.q.weight", q.weight),
                       ("b_classifier.q.bias", q.bias)):
            if key in sd:
                p.copy_(torch.as_tensor(sd[key]).to(p.dtype))
