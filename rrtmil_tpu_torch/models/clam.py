"""CLAM_SB / CLAM_MB (reference modules/clam.py, vendored from
mahmoodlab/CLAM): gated attention, a bag classifier, and per-class instance
classifiers trained on the top-k / bottom-k attended patches with the
smooth top-1 SVM.

Counterpart of `rrtmil_tpu/models/clam.py:29-194`, at batch 1 (the engines
train these models one bag at a time).  The stem's names follow the flax
tree (`fc`, `rrt`, `attn_net`, `classifiers` / `classifier_{c}`,
`instance_classifier_{i}`), so `convert.flax_to_torch` maps the JAX
parameters as they are.

Two differences of form, none of value:

* The JAX package computes every class's instance branch and keeps one
  with `jnp.where` on the label; its optimizer then treats an all-zero
  gradient on an instance classifier as absent (no moment update, no decay,
  no step count).  Here the branch is taken on the host label the engine
  passes (`label=`, an int), as the reference does (clam.py:184-198), so a
  classifier outside the branch never enters the graph and keeps
  `grad=None`, which torch's optimizers skip.  Under subtyping every class's
  classifier trains (in class on its top and bottom k, out of class on its
  top k).
* The instance classifiers exist from `__init__` (the JAX package creates
  them on its labelled path at init); a forward without a label (eval,
  survival) leaves them out.

Bucket-pad rows are left out of the attention softmax and of the top /
bottom-k selection (they score finfo.min there); a bag with fewer than
k_sample real rows selects pad rows, ties taken by the lower index as
`jax.lax.top_k` takes them (`losses.topk_stable`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import RRTEncoderConfig
from ..train.losses import smooth_top1_svm, topk_stable
from .abmil import activation
from .pool import masked_softmax
from .rrt import RRTEncoder, dropout

SCORER_DROPOUT = 0.25


class AttnNet(nn.Module):
    """Ungated attention scorer L -> D -> n (clam.py:25-41)."""

    def __init__(self, d: int = 256, n_out: int = 1, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(512, d)
        self.fc2 = nn.Linear(d, n_out)

    def forward(self, x, generator=None):
        a = torch.tanh(self.fc1(x))
        a = dropout(a, SCORER_DROPOUT if self.dropout else 0.0, generator,
                    self.training)
        return self.fc2(a)


class AttnNetGated(nn.Module):
    """Gated attention scorer (clam.py:51-74)."""

    def __init__(self, d: int = 256, n_out: int = 1, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attention_a = nn.Linear(512, d)
        self.attention_b = nn.Linear(512, d)
        self.attention_c = nn.Linear(d, n_out)

    def forward(self, x, generator=None):
        p = SCORER_DROPOUT if self.dropout else 0.0
        a = dropout(torch.tanh(self.attention_a(x)), p, generator,
                    self.training)
        b = dropout(torch.sigmoid(self.attention_b(x)), p, generator,
                    self.training)
        return self.attention_c(a * b)


def topk_rows(h, scores, mask, k: int, largest: bool = True):
    """Rows of h (N, C) of the k most (or least) attended real instances."""
    s = scores if largest else -scores
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    return h[topk_stable(s, k)[1]]


class _CLAMBase(nn.Module):
    def __init__(self, input_dim: int = 1024, n_classes: int = 2,
                 gate: bool = True, k_sample: int = 8, dropout: float = 0.0,
                 act: str = "relu", subtyping: bool = False,
                 rrt: Optional[RRTEncoderConfig] = None,
                 d_hidden: int = 256):
        super().__init__()
        self.n_classes, self.k_sample = n_classes, k_sample
        self.act, self.p, self.subtyping = act, dropout, subtyping
        self.fc = nn.Linear(input_dim, 512)
        self.rrt = RRTEncoder(rrt) if rrt is not None else None
        attn_cls = AttnNetGated if gate else AttnNet
        self.attn_net = attn_cls(d_hidden, self._n_attn(), dropout)
        self._heads()
        for i in range(n_classes):
            self.add_module(f"instance_classifier_{i}", nn.Linear(512, 2))

    def _stem(self, x, mask, length, generator):
        """(h (N, 512) float32, ps, the bag's mask row) of one bag."""
        if x.dim() == 3:
            x, mask = x[0], (None if mask is None else mask[0])
        ps = x.shape[0]
        h = activation(self.act, self.fc(x.float()))
        h = dropout(h, self.p, generator, self.training)
        if mask is not None:
            h = h * mask[:, None].to(h.dtype)
        if self.rrt is not None:
            h = self.rrt(h[None], mask=None if mask is None else mask[None],
                         length=length, generator=generator)[0].float()
        return h, ps, mask

    def _attention(self, h, mask, generator):
        a = self.attn_net(h, generator).transpose(0, 1)      # (n_attn, N)
        return masked_softmax(a, None if mask is None else mask[None])

    def instance_loss(self, attn_rows, h, mask, label: int):
        """Per-class instance losses (clam.py:179-201) for a bag of class
        `label`: in class, the classifier's top and bottom k against 1 / 0;
        out of class (subtyping only), its top k against 0."""
        k = self.k_sample
        total = h.new_zeros(())
        ones = torch.ones(k, dtype=torch.long, device=h.device)
        zeros = torch.zeros(k, dtype=torch.long, device=h.device)
        for i in range(self.n_classes):
            if i != label and not self.subtyping:
                continue
            clf = getattr(self, f"instance_classifier_{i}")
            a = attn_rows[min(i, attn_rows.shape[0] - 1)]
            top_p = topk_rows(h, a, mask, k, largest=True)
            if i == label:
                top_n = topk_rows(h, a, mask, k, largest=False)
                total = total + smooth_top1_svm(
                    clf(torch.cat([top_p, top_n])), torch.cat([ones, zeros]))
            else:
                total = total + smooth_top1_svm(clf(top_p), zeros)
        if self.subtyping:
            total = total / self.n_classes
        return total


class CLAM_SB(_CLAMBase):
    """Single-branch CLAM (clam.py:88-218): logits (1, C) without a label;
    (logits, instance loss, ps) with one."""

    def _n_attn(self):
        return 1

    def _heads(self):
        self.classifiers = nn.Linear(512, self.n_classes)

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                label: Optional[int] = None):
        h, ps, mask = self._stem(x, mask, length, generator)
        a = self._attention(h, mask, generator)                 # (1, N)
        logits = self.classifiers(a @ h)                        # (1, C)
        if label is None:
            return logits
        return logits, self.instance_loss(a, h, mask, int(label)), ps


class CLAM_MB(_CLAMBase):
    """Multi-branch CLAM (clam.py:220-311): an attention branch and a
    one-logit bag classifier per class."""

    def _n_attn(self):
        return self.n_classes

    def _heads(self):
        for c in range(self.n_classes):
            self.add_module(f"classifier_{c}", nn.Linear(512, 1))

    def forward(self, x, mask=None, length: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                label: Optional[int] = None):
        h, ps, mask = self._stem(x, mask, length, generator)
        a = self._attention(h, mask, generator)                 # (C, N)
        m = a @ h                                               # (C, 512)
        logits = torch.cat([getattr(self, f"classifier_{c}")(m[c][None])
                            for c in range(self.n_classes)], dim=1)
        if label is None:
            return logits
        return logits, self.instance_loss(a, h, mask, int(label)), ps
