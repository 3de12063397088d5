"""Detection-quality metrics (a numpy copy of the JAX package's
`utils/metrics.py`). AVG-F (Chen & Saad, TKDE'12) is the mean, over TRUE
dominant clusters, of the best F1 achieved by any detected cluster."""

from __future__ import annotations

import numpy as np


def f1_contingency(true_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    inter = float(np.sum(true_mask & pred_mask))
    if inter == 0.0:
        return 0.0
    prec = inter / float(np.sum(pred_mask))
    rec = inter / float(np.sum(true_mask))
    return 2 * prec * rec / (prec + rec)


def avg_f1_score(true_labels: np.ndarray, pred_labels: np.ndarray) -> float:
    """AVG-F over true clusters (noise = label -1 on both sides).

    Computed from one contingency table of (true, predicted) label pairs,
    which gives the same F1 values as comparing the masks pair by pair."""
    true_labels = np.asarray(true_labels)
    pred_labels = np.asarray(pred_labels)
    true_ids = np.unique(true_labels[true_labels >= 0])
    if true_ids.size == 0:
        return 0.0
    pred_ids = np.unique(pred_labels[pred_labels >= 0])
    if pred_ids.size == 0:
        return 0.0
    both = (true_labels >= 0) & (pred_labels >= 0)
    ti = np.searchsorted(true_ids, true_labels[both])
    pj = np.searchsorted(pred_ids, pred_labels[both])
    inter = np.zeros((true_ids.size, pred_ids.size), np.float64)
    np.add.at(inter, (ti, pj), 1.0)
    t_size = np.array([(true_labels == t).sum() for t in true_ids], float)
    p_size = np.bincount(np.searchsorted(pred_ids,
                                         pred_labels[pred_labels >= 0]),
                         minlength=pred_ids.size).astype(float)
    prec = inter / np.maximum(p_size[None, :], 1.0)
    rec = inter / t_size[:, None]
    with np.errstate(invalid="ignore", divide="ignore"):
        f1 = np.where(inter > 0, 2 * prec * rec / (prec + rec), 0.0)
    return float(np.mean(f1.max(axis=1)))


def canonical_labels(labels: np.ndarray) -> np.ndarray:
    """Renumber cluster ids by first occurrence (noise -1 kept), so two
    clusterings compare exactly regardless of label permutation."""
    labels = np.asarray(labels)
    out = np.full_like(labels, -1)
    pos = labels >= 0
    ids, first = np.unique(labels[pos], return_index=True)
    rank = np.empty(ids.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(ids.size)
    out[pos] = rank[np.searchsorted(ids, labels[pos])]
    return out
