"""Classification metrics: the port's copy of ``vct.train.metrics``.

Confusion counts accumulate on the device (predictions never leave the card
during eval; only the (C, C) or (C, 4) count matrix comes back), and the
host turns them into ``precision_recall_fscore_support(zero_division=0)``
metrics; ``macro_auc`` is the rank-based one-vs-rest AUC.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vct_torch.core.metrics_contract import RunMetrics

__all__ = [
    "multiclass_confusion",
    "multilabel_counts",
    "multiclass_metrics",
    "multilabel_metrics",
    "macro_auc",
]


def _midranks(values: np.ndarray) -> np.ndarray:
    """Tie-averaged (mid) ranks, 1-based — scipy.stats.rankdata semantics."""
    order = np.argsort(values, kind="mergesort")
    ranks = np.empty(len(values), np.float64)
    sorted_vals = values[order]
    i = 0
    while i < len(values):
        j = i
        while j + 1 < len(values) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def macro_auc(probs: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    """Macro one-vs-rest ROC AUC (the videomamba eval's extra metric,
    ``lrcn/videomamba.py:493-564``). Rank-based (Mann-Whitney), no sklearn
    dependency; classes absent from ``labels`` are skipped."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    aucs = []
    for c in range(num_classes):
        pos = probs[labels == c, c]
        neg = probs[labels != c, c]
        if len(pos) == 0 or len(neg) == 0:
            continue
        ranks = _midranks(np.concatenate([pos, neg]))  # tie-averaged
        auc = (ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2) / (
            len(pos) * len(neg)
        )
        aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.0


def multiclass_confusion(logits, labels, num_classes: int, mask=None):
    """(C, C) confusion matrix on the logits' device: rows = true, cols =
    predicted; masked rows add nothing."""
    preds = torch.argmax(logits, dim=-1)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    idx = labels.to(torch.int64) * num_classes + preds
    flat = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=logits.device)
    return flat.index_add_(0, idx, mask.to(torch.float32)).reshape(num_classes, num_classes)


def multilabel_counts(logits, labels, mask=None):
    """Per-class (tp, fp, fn, tn) counts plus the all-correct row count.

    Thresholding matches the reference: sigmoid(x) > 0.5 (train_eval.py:70).
    Returns ((C, 4) counts, exact-match count).
    """
    preds = (torch.sigmoid(logits) > 0.5).to(torch.float32)
    labels = labels.to(torch.float32)
    if mask is None:
        mask = torch.ones(labels.shape[0], dtype=torch.float32, device=logits.device)
    m = mask[:, None]
    tp = torch.sum(preds * labels * m, dim=0)
    fp = torch.sum(preds * (1 - labels) * m, dim=0)
    fn = torch.sum((1 - preds) * labels * m, dim=0)
    tn = torch.sum((1 - preds) * (1 - labels) * m, dim=0)
    exact = torch.sum(torch.all(preds == labels, dim=-1).to(torch.float32) * mask)
    return torch.stack([tp, fp, fn, tn], dim=-1), exact


def _prf(tp, fp, fn):
    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    return precision, recall, f1


def multiclass_metrics(confusion: np.ndarray, class_names: List[str]) -> RunMetrics:
    confusion = np.asarray(confusion, np.float64)
    tp = np.diag(confusion)
    fp = confusion.sum(axis=0) - tp
    fn = confusion.sum(axis=1) - tp
    precision, recall, f1 = _prf(tp, fp, fn)
    total = confusion.sum()
    acc = float(tp.sum() / total) if total else 0.0
    per_class = {
        name: {"precision": float(precision[i]), "recall": float(recall[i]),
               "f1": float(f1[i])}
        for i, name in enumerate(class_names)
    }
    # Macro averages over classes PRESENT in labels-or-predictions, matching
    # sklearn's default (and therefore the reference's
    # precision_recall_fscore_support(average="macro") with no labels=,
    # train_eval.py:112-113) — averaging zeros for absent classes would
    # deflate the scraped Overall F1 on eval splits missing classes.
    present = (confusion.sum(axis=0) + confusion.sum(axis=1)) > 0
    if not present.any():
        present = np.ones_like(present)
    return RunMetrics(
        accuracy=acc,
        precision=float(precision[present].mean()),
        recall=float(recall[present].mean()),
        f1=float(f1[present].mean()),
        per_class=per_class,
    )


def multilabel_metrics(
    counts: np.ndarray, exact: float, total: float, class_names: List[str]
) -> RunMetrics:
    counts = np.asarray(counts, np.float64)
    tp, fp, fn, tn = counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3]
    precision, recall, f1 = _prf(tp, fp, fn)
    per_cls_acc = (tp + tn) / np.maximum(tp + fp + fn + tn, 1)
    per_class = {
        name: {"precision": float(precision[i]), "recall": float(recall[i]),
               "f1": float(f1[i]), "accuracy": float(per_cls_acc[i])}
        for i, name in enumerate(class_names)
    }
    return RunMetrics(
        accuracy=float(exact / total) if total else 0.0,
        precision=float(precision.mean()),
        recall=float(recall.mean()),
        f1=float(f1.mean()),
        per_class=per_class,
    )
