"""Binary-classification metrics (the port's copy of
mmtrs_tpu/metrics/binary.py: ``roc_auc``, ``average_precision``, ``brier``,
``log_loss``, ``confusion``, ``binary_report``, ``evaluate`` and
``summary_payload``; host numpy, as there, with sklearn's semantics)."""

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


def average_precision(y_true, y_score) -> float:
    """Step-wise AP (== sklearn.average_precision_score)."""
    y = _as1d(y_true).astype(np.float64)
    s = _as1d(y_score).astype(np.float64)
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    s = s[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1.0 - y)
    # evaluate at the last index of each distinct score block
    distinct = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tp_d, fp_d = tp[distinct], fp[distinct]
    precision = tp_d / np.maximum(tp_d + fp_d, 1e-12)
    total_pos = tp[-1]
    if total_pos == 0:
        return float("nan")
    recall = tp_d / total_pos
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def brier(y_true, y_prob) -> float:
    y = _as1d(y_true).astype(np.float64)
    p = _as1d(y_prob).astype(np.float64)
    return float(np.mean((p - y) ** 2))


def log_loss(y_true, y_prob, eps: float = 1e-15) -> float:
    y = _as1d(y_true).astype(np.float64)
    p = np.clip(_as1d(y_prob).astype(np.float64), eps, 1.0 - eps)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


def confusion(y_true, y_pred) -> dict[str, int]:
    y = _as1d(y_true).astype(np.int64)
    yh = _as1d(y_pred).astype(np.int64)
    return {
        "tn": int(np.sum((y == 0) & (yh == 0))),
        "fp": int(np.sum((y == 0) & (yh == 1))),
        "fn": int(np.sum((y == 1) & (yh == 0))),
        "tp": int(np.sum((y == 1) & (yh == 1))),
    }


def binary_report(y_true, y_prob, threshold: float = 0.5) -> dict[str, float]:
    """acc/prec/rec/f1/bal_acc at a threshold + threshold-free auc/pr_auc/brier."""
    y = _as1d(y_true).astype(np.int64)
    p = _as1d(y_prob).astype(np.float64)
    yh = (p >= threshold).astype(np.int64)
    c = confusion(y, yh)
    tp, fp, fn, tn = c["tp"], c["fp"], c["fn"], c["tn"]
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    spec = tn / (tn + fp) if (tn + fp) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return {
        "acc": float((tp + tn) / max(y.size, 1)),
        "bal_acc": float(0.5 * (rec + spec)),
        "prec": float(prec),
        "rec": float(rec),
        "f1": float(f1),
        "auc": roc_auc(y, p),
        "pr_auc": average_precision(y, p),
        "brier": brier(y, p),
        "thr": float(threshold),
        **c,
    }


def evaluate(y_true, y_prob, threshold: float = 0.5) -> dict[str, float]:
    """Reference-shaped metric payload (src/fusion/metrics.py:9-32)."""
    r = binary_report(y_true, y_prob, threshold)
    return {
        "acc": r["acc"],
        "prec": r["prec"],
        "rec": r["rec"],
        "f1": r["f1"],
        "brier": r["brier"],
        "roc_auc": r["auc"],
        "pr_auc": r["pr_auc"],
        "confusion": {k: r[k] for k in ("tn", "fp", "fn", "tp")},
        "thr": r["thr"],
    }


def summary_payload(y_true, y_prob, threshold: float) -> dict[str, float]:
    """The 5-number payload written to summary.json by the final stack
    (stack_blend.py:266-283): auc/acc/prec/rec/f1 rounded to 4 decimals."""
    r = binary_report(y_true, y_prob, threshold)
    return {
        "auc": round(r["auc"], 4),
        "acc": round(r["acc"], 4),
        "prec": round(r["prec"], 4),
        "rec": round(r["rec"], 4),
        "f1": round(r["f1"], 4),
    }
