"""Non-negative simplex weight search for late fusion (the port's copy of
mmtrs_tpu/fusion/weight_search.py; host numpy, as there).

Parity: src/fusion/weight_search.py:6-26 — enumerate non-negative weights
summing to 1 on a step grid, tune a threshold per candidate, keep the best
F1 (or pr_auc). The candidate evaluation here is vectorized: all simplex
points are stacked into one matrix, blended probabilities for every
candidate are computed in a single matmul, and the per-candidate F1 sweep
reuses the searchsorted-based threshold machinery.
"""

from __future__ import annotations

from itertools import product

import numpy as np

from mmtrs_tpu_torch.metrics.binary import average_precision
from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds, threshold_grid


def grid_simplex(num_models: int, step: float = 0.05) -> np.ndarray:
    """[K, num_models] matrix of non-negative weight rows summing to 1."""
    vals = np.arange(0, 1 + 1e-9, step)
    rows = [
        w
        for w in product(vals, repeat=num_models)
        if abs(sum(w) - 1.0) < 1e-9
    ]
    return np.asarray(rows, dtype=float)


def blended_prob(weights, P) -> np.ndarray:
    w = np.asarray(weights).reshape(1, -1)
    return np.clip((np.asarray(P) * w).sum(axis=1), 0, 1)


def search_weights(
    P_val: np.ndarray,
    y_val: np.ndarray,
    metric: str = "f1",
    step: float = 0.1,
    threshold_mode: str = "tune",
) -> dict:
    """Best simplex blend by val F1 with per-candidate threshold tuning."""
    P = np.asarray(P_val, dtype=float)
    y = np.asarray(y_val).astype(int)
    W = grid_simplex(P.shape[1], step=step)
    blends = np.clip(P @ W.T, 0, 1)  # [n, K]
    ts = threshold_grid("fusion")

    best = {"weights": None, "threshold": 0.5, "score": -1.0}
    for k in range(W.shape[0]):
        p = blends[:, k]
        if metric == "pr_auc":
            t, score = 0.5, average_precision(y, p)
        else:
            if threshold_mode == "fixed":
                t = 0.5
                s = sweep_thresholds(y, p, np.array([0.5]))
                score = float(s["f1"][0])
            else:
                s = sweep_thresholds(y, p, ts)
                i = int(np.argmax(s["f1"]))
                t, score = float(ts[i]), float(s["f1"][i])
        if score > best["score"]:
            best.update(
                {"weights": W[k].tolist(), "threshold": float(t), "score": float(score)}
            )
    return best
