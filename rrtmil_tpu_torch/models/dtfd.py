"""DTFD: double-tier feature distillation MIL.

Counterpart of `rrtmil_tpu/models/dtfd.py` (reference Survival/models/DTFD/
network.py:146-280 and the standalone DTFD/main.py:419-551).  Tier 1 splits
the bag into `group` pseudo-bags (`np.array_split` chunks over the
`length` rows the caller passes: the engines pass the bucket's
`repr_length`, zero rows included, as the JAX engines do), runs
dimReduction -> gated attention -> pooled classifier per pseudo-bag and
distills MaxMinS / MaxS / AFS instance features, ranked by the tier-1
classifier's last-class probability (`instance_per_group` each way).
Tier 2 classifies the distilled features with an attention classifier.

`train=True` gives the train path: (pseudo-bag logits (G, C), bag logits
(1, C)), or with `survival` (pseudo hazards, pseudo S, hazards, S).  The
eval path is not the train path with dropout off: the raw attention is
scored over the whole bag, the (optionally permuted, `eval_perm`) chunks
each take their own softmax, and the tier-1 classifier never runs
(network.py:226-271); it gives the bag logits, or (hazards, S).

The JAX package computes DTFD in plain XLA, outside any Pallas kernel, so
the port runs it as torch ops on either device.  dimReduction and the
attention scorer are row-wise, so both paths score the whole bag in one
product and then slice it; the JAX train path applies them chunk by chunk,
the same function.  As there:

* masked scores take finfo.min, not -inf: a pseudo-bag of bucket zero rows
  alone gets uniform weights on zero features, not NaN;
* the distillation's top-k takes ties by the lower index (`jax.lax.top_k`),
  through `losses.topk_stable`;
* the three dropouts are fixed at 0.25 (`p`), drawn from the caller's
  `torch.Generator` in train mode;
* the bag is read in float32 (flax's Dense promotes a bf16 `--amp` bag
  against its float32 kernels).

Parameter names follow the flax tree: `dim_fc1` (no bias), `attention` and
`u_attention` (`attention_V`, `attention_U`, `attention_weights`), the raw
`classifier_kernel` (inner_dim, n_classes) and `classifier_bias`, and
`u_classifier_fc`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.losses import topk_stable
from ..utils.inits import xavier_normal_
from .pool import dropout, masked_softmax

DISTILL_MODES = ("MaxMinS", "MaxS", "AFS")


def pseudo_bag_slices(length: int, group: int) -> List[Tuple[int, int]]:
    """np.array_split boundaries over range(length) (network.py:165-168)."""
    sizes = np.full(group, length // group)
    sizes[: length % group] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(group)]


class GatedAttention(nn.Module):
    """V/U gated attention scorer (network.py:108-143): raw scores (N,)."""

    def __init__(self, dim: int = 512, d: int = 128):
        super().__init__()
        self.attention_V = nn.Linear(dim, d)
        self.attention_U = nn.Linear(dim, d)
        self.attention_weights = nn.Linear(d, 1)

    def forward(self, x):
        a = torch.tanh(self.attention_V(x)) * torch.sigmoid(
            self.attention_U(x))
        return self.attention_weights(a)[:, 0]


class DTFD(nn.Module):
    p = 0.25          # the three dropouts' fixed rate

    def __init__(self, input_dim: int = 1024, inner_dim: int = 512,
                 n_classes: int = 4, group: int = 8,
                 distill: str = "MaxMinS", survival: bool = True,
                 instance_per_group: int = 1):
        super().__init__()
        if distill not in DISTILL_MODES:
            raise ValueError(f"distill {distill!r} is not one of "
                             f"{DISTILL_MODES}")
        self.inner_dim, self.n_classes = inner_dim, n_classes
        self.group, self.distill = group, distill
        self.survival = survival
        self.instance_per_group = instance_per_group
        self.dim_fc1 = nn.Linear(input_dim, inner_dim, bias=False)
        self.attention = GatedAttention(inner_dim)
        self.classifier_kernel = nn.Parameter(torch.zeros(inner_dim,
                                                          n_classes))
        self.classifier_bias = nn.Parameter(torch.zeros(n_classes))
        self.u_attention = GatedAttention(inner_dim)
        self.u_classifier_fc = nn.Linear(inner_dim, n_classes)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        xavier_normal_(self.classifier_kernel, self.inner_dim,
                       self.n_classes, generator)
        with torch.no_grad():
            self.classifier_bias.zero_()

    def _drop(self, x, generator):
        return dropout(x, self.p, generator, self.training)

    def _u_classify(self, feats, generator):
        a = torch.softmax(self.u_attention(feats), dim=0)
        pooled = self._drop(a[None, :] @ feats, generator)
        return self.u_classifier_fc(pooled)

    def _distill(self, att_feats, mid, pooled, sub_mask):
        """MaxMinS / MaxS rows of `mid` ranked by the tier-1 classifier's
        last-class probability (network.py:192-210), or AFS's pooled row."""
        if self.distill == "AFS":
            return pooled
        kq = self.instance_per_group
        p_last = torch.softmax(att_feats @ self.classifier_kernel,
                               dim=1)[:, -1]
        p_max = torch.where(sub_mask, p_last, float("-inf"))
        rows = [mid[topk_stable(p_max, kq)[1]]]
        if self.distill == "MaxMinS":
            p_min = torch.where(sub_mask, p_last, float("inf"))
            rows.append(mid[topk_stable(-p_min, kq)[1]])
        return torch.cat(rows, dim=0)

    def _pseudo_bag(self, mid, raw, sub_mask):
        a = masked_softmax(raw, sub_mask, dim=0)
        att_feats = mid * a[:, None]
        return att_feats, att_feats.sum(dim=0, keepdim=True)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                eval_perm: Optional[torch.Tensor] = None):
        """x (1, N, D) or (N, D); `length` rows are read (the bag's N by
        default); `eval_perm`, a permutation of range(length), orders the
        eval path's instances before chunking (identity when None)."""
        if x.dim() == 3:
            x, mask = x[0], (None if mask is None else mask[0])
        n = x.shape[0] if length is None else length
        x = x[:n].float()
        mask = torch.ones(n, dtype=torch.bool, device=x.device) \
            if mask is None else mask[:n]
        mid = self._drop(F.relu(self.dim_fc1(x)), generator)
        raw = self.attention(mid)
        chunks = pseudo_bag_slices(n, self.group)

        if train:
            pseudo_logits, distilled = [], []
            for lo, hi in chunks:
                att_feats, pooled = self._pseudo_bag(mid[lo:hi], raw[lo:hi],
                                                     mask[lo:hi])
                pseudo_logits.append(
                    self._drop(pooled, generator) @ self.classifier_kernel
                    + self.classifier_bias)
                distilled.append(self._distill(att_feats, mid[lo:hi], pooled,
                                               mask[lo:hi]))
            pseudo_logits = torch.cat(pseudo_logits, dim=0)
            logits = self._u_classify(torch.cat(distilled, dim=0), generator)
            if not self.survival:
                return pseudo_logits, logits
            pseudo_hazards = torch.sigmoid(pseudo_logits)
            hazards = torch.sigmoid(logits)
            return (pseudo_hazards, torch.cumprod(1 - pseudo_hazards, dim=1),
                    hazards, torch.cumprod(1 - hazards, dim=1))

        if eval_perm is not None:
            eval_perm = eval_perm.to(x.device)
            mid, raw, mask = mid[eval_perm], raw[eval_perm], mask[eval_perm]
        distilled = []
        for lo, hi in chunks:
            att_feats, pooled = self._pseudo_bag(mid[lo:hi], raw[lo:hi],
                                                 mask[lo:hi])
            distilled.append(self._distill(att_feats, mid[lo:hi], pooled,
                                           mask[lo:hi]))
        logits = self._u_classify(torch.cat(distilled, dim=0), generator)
        if not self.survival:
            return logits
        hazards = torch.sigmoid(logits)
        return hazards, torch.cumprod(1 - hazards, dim=1)
