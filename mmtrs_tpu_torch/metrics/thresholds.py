"""Threshold selection over the whole grid at once (the port's copy of
``threshold_grid``, ``sweep_thresholds``, ``choose_threshold`` and
``tune_threshold`` in mmtrs_tpu/metrics/thresholds.py; host numpy, as there).

stack_blend.py:50-85 parity: grid ``linspace(0.01, 0.99, 199)``; modes
max_f1 / max_acc / youden (over the distinct scores, descending, like
sklearn.roc_curve) / target_prec (first t with prec ≥ target) /
target_rec (last t with rec ≥ target); the lowest best threshold wins.
Counts at every threshold come from two ``searchsorted`` calls on the
sorted positive and negative scores.
"""

from __future__ import annotations

import numpy as np

from mmtrs_tpu_torch.metrics.binary import average_precision


def threshold_grid(kind: str = "stack") -> np.ndarray:
    if kind == "stack":  # stack_blend.py:51
        return np.linspace(0.01, 0.99, 199)
    if kind == "fusion":  # src/fusion/metrics.py:33, xgboost_model.py:87
        return np.linspace(0.05, 0.95, 181)
    if kind == "mm":  # train_mm_joint_dualtask.py:290-295
        return np.linspace(0.2, 0.8, 61)
    raise ValueError(f"unknown grid kind: {kind}")


def sweep_thresholds(y_true, y_prob, thresholds) -> dict[str, np.ndarray]:
    """Confusion-derived metrics at every threshold (prediction ``p >= t``):
    arrays of shape [T] for acc, bal_acc, prec, rec, f1, youden_j."""
    y = np.asarray(y_true).reshape(-1).astype(np.int64)
    p = np.asarray(y_prob).reshape(-1).astype(np.float64)
    t = np.asarray(thresholds, dtype=np.float64).reshape(-1)

    pos = np.sort(p[y == 1])
    neg = np.sort(p[y == 0])
    n_pos, n_neg = pos.size, neg.size
    # count of scores >= t  ==  n - first index where score >= t
    tp = n_pos - np.searchsorted(pos, t, side="left")
    fp = n_neg - np.searchsorted(neg, t, side="left")
    fn = n_pos - tp
    tn = n_neg - fp

    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        rec = np.where(n_pos > 0, tp / max(n_pos, 1), 0.0)
        spec = np.where(n_neg > 0, tn / max(n_neg, 1), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-300), 0.0)
    acc = (tp + tn) / max(n_pos + n_neg, 1)
    return {
        "thresholds": t,
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "acc": acc,
        "bal_acc": 0.5 * (rec + spec),
        "prec": prec,
        "rec": rec,
        "f1": f1,
        "youden_j": rec - (1.0 - spec),
    }


def choose_threshold(y, p, mode: str = "max_f1", target: float = 0.80) -> float:
    """stack_blend.py:50-85 parity; ``argmax`` takes the first (lowest)
    best threshold, as the reference's strict-improvement loops do."""
    ts = threshold_grid("stack")
    s = sweep_thresholds(y, p, ts)
    if mode == "max_f1":
        return float(ts[int(np.argmax(s["f1"]))])
    if mode == "max_acc":
        return float(ts[int(np.argmax(s["acc"]))])
    if mode == "youden":
        scores = np.unique(np.asarray(p, dtype=np.float64))[::-1]
        ss = sweep_thresholds(y, p, scores)
        return float(scores[int(np.argmax(ss["youden_j"]))])
    if mode == "target_prec":
        ok = np.nonzero(s["prec"] >= target)[0]
        return float(ts[ok[0]]) if ok.size else 0.5
    if mode == "target_rec":
        ok = np.nonzero(s["rec"] >= target)[0]
        return float(ts[ok[-1]]) if ok.size else 0.5
    return 0.5


def tune_threshold(y, p, metric: str = "f1") -> tuple[float, float]:
    """src/fusion/metrics.py:27-45 + xgboost_model.py:86-101 parity over
    the fusion grid: f1, accuracy, balanced_accuracy; youden and pr_auc are
    threshold-free in the reference, whose loop then returns the first grid
    point (kept)."""
    ts = threshold_grid("fusion")
    if metric in ("youden", "pr_auc"):
        if metric == "pr_auc":
            return float(ts[0]), float(average_precision(y, p))
        s = sweep_thresholds(y, p, np.unique(np.asarray(p))[::-1])
        return float(ts[0]), float(np.max(s["youden_j"]))
    s = sweep_thresholds(y, p, ts)
    key = {"f1": "f1", "accuracy": "acc", "balanced_accuracy": "bal_acc"}[metric]
    i = int(np.argmax(s[key]))
    return float(ts[i]), float(s[key][i])
