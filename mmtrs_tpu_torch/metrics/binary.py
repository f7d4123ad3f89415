"""Binary-classification metrics (the port's copy of ``roc_auc`` in
mmtrs_tpu/metrics/binary.py; host numpy, as there)."""

from __future__ import annotations

import numpy as np


def _as1d(x) -> np.ndarray:
    return np.asarray(x).reshape(-1)


def roc_auc(y_true, y_score) -> float:
    """Tie-aware ROC AUC via the rank statistic (== sklearn.roc_auc_score)."""
    y = _as1d(y_true).astype(np.int64)
    s = _as1d(y_score).astype(np.float64)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(s.size, dtype=np.float64)
    sorted_s = s[order]
    # average ranks for ties
    i = 0
    while i < s.size:
        j = i
        while j + 1 < s.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    r_pos = ranks[y == 1].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
