"""Losses (counterpart of `rrtmil_tpu/train/losses.py`).

Classification: CE / BCE-with-logits (reference main.py:224-227,452-455).
Survival: the NLL and CE discrete-hazard losses (reference
Survival/utils/loss.py:25-62), quirks included.  CLAM's instance loss and
the top-k SVM family (reference modules/topk/svm.py): the smooth top-1 SVM
with its per-sample hard / smooth switch, and the top-k losses over the
JAX package's log-space DP for the elementary symmetric polynomials
(`log_esp`), which autograd differentiates as JAX does, with no custom
backward.
"""
from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# the top-k SVM family (reference modules/topk/svm.py:30-136)
# ---------------------------------------------------------------------------

_NEG = -1e30      # log-space "zero" (finite: -inf poisons logaddexp grads)


def topk_stable(x: torch.Tensor, k: int, largest: bool = True):
    """(values, indices) of the k largest (or smallest) entries along the
    last axis, ties taken by the lower index as `jax.lax.top_k` takes them
    (`torch.topk` promises no order among ties)."""
    idx = torch.sort(x, dim=-1, descending=largest, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def _truth(scores, labels):
    return torch.gather(scores, 1, labels.long()[:, None])[:, 0]


def _delta(scores, labels, alpha):
    return alpha * (1.0 - F.one_hot(labels.long(), scores.shape[1])
                    .to(scores.dtype))


def smooth_top1_svm(scores: torch.Tensor, labels: torch.Tensor,
                    alpha: float = 1.0, tau: float = 1.0,
                    thresh: float = 1e3) -> torch.Tensor:
    """Smooth top-1 SVM (svm.py:30-116): tau * logsumexp((s + alpha [j !=
    y]) / tau) - s_y, or the hard max-hinge for a sample whose top-1 raw
    score leads the runner-up by >= tau log(thresh) (`detect_large`,
    topk/utils.py:36-42)."""
    aug = scores + _delta(scores, labels, alpha)
    truth = _truth(scores, labels)
    smooth = tau * torch.logsumexp(aug / tau, dim=1) - truth
    hard = aug.max(dim=1).values - truth
    top2 = topk_stable(scores, 2)[0]
    is_hard = (top2[:, 0] - top2[:, 1]) >= tau * math.log(thresh)
    return torch.mean(torch.where(is_hard, hard, smooth))


def log_esp(x: torch.Tensor, kmax: int) -> torch.Tensor:
    """log sigma_j of exp(x) for j = 0..kmax, x (n, m) log-space terms: the
    DP sigma_j <- sigma_j + exp(x_i) sigma_{j-1} in log space."""
    n, m = x.shape
    out = torch.full((n, kmax + 1), _NEG, dtype=x.dtype, device=x.device)
    out[:, 0] = 0.0
    neg = torch.full((n, 1), _NEG, dtype=x.dtype, device=x.device)
    for i in range(m):
        shifted = torch.cat([neg, out[:, :-1]], dim=1)
        out = torch.logaddexp(out, shifted + x[:, i:i + 1])
    return out


def _split_mask(scores, labels):
    """x1: the scores with the ground truth's slot at the log-space zero
    (it drops out of every ESP term), x2: the ground truth's score."""
    onehot = F.one_hot(labels.long(), scores.shape[1]).bool()
    return (torch.where(onehot, torch.full_like(scores, _NEG), scores),
            _truth(scores, labels))


def max_top1_svm(scores: torch.Tensor, labels: torch.Tensor,
                 alpha: float = 1.0) -> torch.Tensor:
    """MaxTop1SVM: hard top-1 hinge (svm.py:49-60)."""
    return torch.mean((scores + _delta(scores, labels, alpha)).max(dim=1)
                      .values - _truth(scores, labels))


def _topk_hard(scores, labels, k: int, alpha: float):
    """Topk_Hard_SVM per sample (functional.py:20-32)."""
    x1, x2 = _split_mask(scores, labels)
    top_k = topk_stable(x1, k)[0]
    max_1 = torch.mean(top_k + alpha, dim=1)
    max_2 = (torch.sum(top_k[:, :k - 1], dim=1) + x2) / k
    return torch.clamp(max_1 - max_2, min=0.0)


def max_topk_svm(scores: torch.Tensor, labels: torch.Tensor, k: int,
                 alpha: float = 1.0) -> torch.Tensor:
    """MaxTopkSVM (svm.py:63-76)."""
    return torch.mean(_topk_hard(scores, labels, k, alpha))


def _topk_smooth(scores, labels, k: int, alpha: float, tau: float):
    """Topk_Smooth_SVM per sample (functional.py:35-71): tau softplus(log
    sigma_k - log sigma_{k-1} + alpha / tau - x2 / (k tau)) over
    exp(x1 / (k tau))."""
    x1, x2 = _split_mask(scores, labels)
    esp = log_esp(x1 / (k * tau), k)
    z = esp[:, k] - esp[:, k - 1] + alpha / tau - x2 / (k * tau)
    return tau * torch.logaddexp(z, torch.zeros_like(z))


def smooth_topk_svm(scores: torch.Tensor, labels: torch.Tensor, k: int,
                    alpha: float = 1.0, tau: float = 1.0,
                    thresh: float = 1e3) -> torch.Tensor:
    """SmoothTopkSVM (svm.py:108-136): a sample goes hard when its k-th
    largest raw score leads the (k+1)-th by >= k tau log(thresh)."""
    smooth = _topk_smooth(scores, labels, k, alpha, tau)
    hard = _topk_hard(scores, labels, k, alpha)
    top = topk_stable(scores, k + 1)[0]
    is_hard = (top[:, k - 1] - top[:, k]) >= k * tau * math.log(thresh)
    return torch.mean(torch.where(is_hard, hard, smooth))
