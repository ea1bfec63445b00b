"""Classification losses (counterpart of `rrtmil_tpu/train/losses.py:15-28`;
reference main.py:224-227,452-455).  The survival and top-k SVM losses are
later slices (ROADMAP.md queue 1)."""
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
