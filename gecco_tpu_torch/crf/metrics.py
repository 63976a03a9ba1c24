"""Binary ranking metrics (AUROC, average precision) from scratch.

The reference uses sklearn's implementations in ``gecco cv``
(``gecco/cli/commands/cv.py:205-217``); these are
self-contained equivalents (cross-checked against sklearn in tests).
"""

from typing import Sequence

import numpy

__all__ = ["roc_auc_score", "average_precision_score"]


def roc_auc_score(labels: Sequence[bool], scores: Sequence[float]) -> float:
    """Area under the ROC curve via the rank-sum (Mann–Whitney) statistic."""
    y = numpy.asarray(labels, dtype=bool)
    s = numpy.asarray(scores, dtype=numpy.float64)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score needs both positive and negative samples")
    order = numpy.argsort(s, kind="mergesort")
    ranks = numpy.empty(len(s), dtype=numpy.float64)
    sorted_scores = s[order]
    # average ranks for ties
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    rank_sum = ranks[y].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision_score(labels: Sequence[bool], scores: Sequence[float]) -> float:
    """AP = Σ (R_n − R_{n−1}) · P_n over the descending-score threshold sweep."""
    y = numpy.asarray(labels, dtype=bool)
    s = numpy.asarray(scores, dtype=numpy.float64)
    n_pos = int(y.sum())
    if n_pos == 0:
        raise ValueError("average_precision_score needs at least one positive sample")
    order = numpy.argsort(-s, kind="mergesort")
    y_sorted = y[order]
    s_sorted = s[order]
    tp = numpy.cumsum(y_sorted)
    n = numpy.arange(1, len(y) + 1)
    # evaluate at distinct thresholds only (last index of each tie group)
    distinct = numpy.nonzero(numpy.diff(s_sorted, append=numpy.nan))[0]
    precision = tp[distinct] / n[distinct]
    recall = tp[distinct] / n_pos
    recall_prev = numpy.concatenate([[0.0], recall[:-1]])
    return float(numpy.sum((recall - recall_prev) * precision))
