"""Losses (counterpart of `rrtmil_tpu/train/losses.py:15-76`).

Classification: CE / BCE-with-logits (reference main.py:224-227,452-455).
Survival: the NLL and CE discrete-hazard losses (reference
Survival/utils/loss.py:25-62), quirks included.  The top-k SVM losses are a
later slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE with integer labels (torch nn.CrossEntropyLoss)."""
    return F.cross_entropy(logits.float(), labels)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    n_classes: int = 2) -> torch.Tensor:
    """BCEWithLogitsLoss against one-hot labels, averaged over every
    element."""
    logits = logits.float()
    onehot = F.one_hot(labels, n_classes).to(logits.dtype)
    return -torch.mean(onehot * F.logsigmoid(logits)
                       + (1.0 - onehot) * F.logsigmoid(-logits))


def _surv_terms(hazards, survival, label, censorship):
    """(c, S(Y-1), h(Y), S padded with S(-1) = 1), label (B,) int."""
    label = label.long()[:, None]
    c = censorship.to(hazards.dtype)[:, None]
    s_padded = torch.cat([torch.ones_like(c), survival], dim=1)
    return (c, label, s_padded, torch.gather(s_padded, 1, label),
            torch.gather(hazards, 1, label))


def nll_surv_loss(hazards: torch.Tensor, survival: torch.Tensor,
                  label: torch.Tensor, censorship: torch.Tensor,
                  alpha: float = 0.4, eps: float = 1e-7) -> torch.Tensor:
    """Discrete-hazard negative log likelihood (loss.py `nll_loss`).
    hazards, survival (B, K); label (B,) bin; censorship (B,), 1 = censored."""
    c, label, s_padded, s_prev, h_this = _surv_terms(hazards, survival, label,
                                                     censorship)
    s_this = torch.gather(s_padded, 1, label + 1)
    uncensored = -(1.0 - c) * (torch.log(torch.clamp(s_prev, min=eps))
                               + torch.log(torch.clamp(h_this, min=eps)))
    censored = -c * torch.log(torch.clamp(s_this, min=eps))
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return torch.mean(loss)


def ce_surv_loss(hazards: torch.Tensor, survival: torch.Tensor,
                 label: torch.Tensor, censorship: torch.Tensor,
                 alpha: float = 0.4, eps: float = 1e-7) -> torch.Tensor:
    """CE variant (loss.py `ce_loss`) with its quirks: `+ eps` (not a
    clamp) on the padded-survival log, and `log(1 - clamp(S[Y]))` without an
    outer clamp."""
    c, label, s_padded, s_prev, h_this = _surv_terms(hazards, survival, label,
                                                     censorship)
    s_y = torch.gather(survival, 1, label)
    reg = -(1.0 - c) * (torch.log(s_prev + eps)
                        + torch.log(torch.clamp(h_this, min=eps)))
    ce_l = (-c * torch.log(torch.clamp(s_y, min=eps))
            - (1.0 - c) * torch.log(1.0 - torch.clamp(s_y, min=eps)))
    return torch.mean((1.0 - alpha) * ce_l + alpha * reg)
