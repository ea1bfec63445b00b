"""Evaluation metrics, dependency-free (numpy only).

Mirrors reference utils.py:73-103 (`optimal_thresh`, `five_scores`) and the
survival c-index (reference Survival/models/RRTMIL/engine.py:90 via sksurv).
A copy of `rrtmil_tpu/train/metrics.py`; sklearn/sksurv are not imported
here; tests/test_metrics.py cross-checks against sklearn when it is
available.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """ROC points (fpr, tpr, thresholds), thresholds descending.

    Equivalent to sklearn.metrics.roc_curve(..., drop_intermediate=False)
    modulo the collinear interior points, which do not affect AUC or the
    optimal-threshold argmin used by `five_scores`."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    labels, scores = labels[order], scores[order]

    distinct = np.where(np.diff(scores))[0]
    cut = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[cut].astype(np.float64)
    fps = (cut + 1) - tps

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, scores[cut]]

    p = max(tps[-1], 1.0)
    n = max(fps[-1], 1.0)
    return fps / n, tps / p, thresholds


def roc_auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(np.trapezoid(tpr, fpr))


def optimal_thresh(fpr, tpr, thresholds, p: float = 0.0):
    """Youden-like optimal threshold (reference utils.py:73-76)."""
    loss = (fpr - tpr) - p * tpr / (fpr + tpr + 1)
    idx = int(np.argmin(loss))
    return fpr[idx], tpr[idx], thresholds[idx]


def _prf(labels, preds, positive):
    tp = float(np.sum((preds == positive) & (labels == positive)))
    fp = float(np.sum((preds == positive) & (labels != positive)))
    fn = float(np.sum((preds != positive) & (labels == positive)))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return precision, recall, f1


def precision_recall_fscore(labels, preds, average: str = "binary"):
    """binary: scores of the positive class (=1); macro: unweighted mean over
    the classes present in labels (sklearn semantics for average='macro')."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    if average == "binary":
        return _prf(labels, preds, 1)
    classes = np.unique(labels)
    scores = np.array([_prf(labels, preds, c) for c in classes])
    return tuple(scores.mean(axis=0))


def five_scores(bag_labels: Sequence, bag_predictions: Sequence,
                sub_typing: bool = False) -> Tuple[float, float, float, float, float]:
    """accuracy, auc, precision, recall, fscore at the ROC-optimal threshold
    (reference utils.py:91-103)."""
    labels = np.asarray(bag_labels)
    scores = np.asarray(bag_predictions, dtype=np.float64)
    fpr, tpr, thresholds = roc_curve(labels, scores)
    _, _, thr = optimal_thresh(fpr, tpr, thresholds)
    auc = roc_auc_score(labels, scores)
    preds = (scores >= thr).astype(np.int64)
    avg = "macro" if sub_typing else "binary"
    precision, recall, fscore = precision_recall_fscore(labels, preds, avg)
    accuracy = float(np.mean(preds == labels))
    return accuracy, auc, precision, recall, fscore


def concordance_index_censored(event_indicator: np.ndarray,
                               event_time: np.ndarray,
                               risk: np.ndarray) -> float:
    """Harrell's censored c-index (sksurv.metrics.concordance_index_censored
    semantics with tied_tol=1e-8): permissible pairs are (i, j) with
    event_i = 1 and t_i < t_j; tied risks count 0.5."""
    event = np.asarray(event_indicator).astype(bool)
    time = np.asarray(event_time, dtype=np.float64)
    risk = np.asarray(risk, dtype=np.float64)

    concordant = 0.0
    permissible = 0
    for i in np.where(event)[0]:
        mask = time > time[i]
        permissible += int(mask.sum())
        diff = risk[i] - risk[mask]
        concordant += float(np.sum(diff > 1e-8)) + 0.5 * float(
            np.sum(np.abs(diff) <= 1e-8))
    if permissible == 0:
        return 0.5
    return concordant / permissible
