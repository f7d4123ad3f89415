"""Threshold-sweep evaluator (port of mmtrs_tpu/eval/threshold_sweep.py; the
reference's experiments/vision_v2/eval_threshold_sweep.py): per-fold logits
→ temperature scaling on val (:116-133) → a 1001-step threshold sweep with
the objectives max_acc / max_f1 / recall-constrained (:160-201) → metric and
ROC plots (:205-236) → the mean ± std (population, ddof 0) over folds as
JSON and CSV (:374-430).

The temperature is the port's Newton fit (``models.linear.TemperatureScaler``,
host float64), not the JAX package's 50-step LBFGS; they agree within 1e-4
relative. Host work only. matplotlib is imported inside the plot functions:
without it ``make_plots=True`` raises ImportError, as the JAX package does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.metrics.binary import binary_report, roc_auc
from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds
from mmtrs_tpu_torch.models.linear import TemperatureScaler
from mmtrs_tpu_torch.utils.io import save_json
from mmtrs_tpu_torch.utils.table import Table, to_csv


def pick_threshold(y: np.ndarray, p: np.ndarray, objective: str = "max_acc", min_recall: float = 0.90,
                   n_steps: int = 1001) -> tuple[float, dict]:
    ts = np.linspace(0.0, 1.0, n_steps)
    s = sweep_thresholds(y, p, ts)
    if objective == "max_acc":
        i = int(np.argmax(s["acc"]))
    elif objective == "max_f1":
        i = int(np.argmax(s["f1"]))
    elif objective == "recall_constrained":
        vals = np.where(s["rec"] >= min_recall, s["f1"], -np.inf)
        i = int(np.argmax(s["f1"] if np.all(np.isneginf(vals)) else vals))
    else:
        raise ValueError(objective)
    return float(ts[i]), {k: float(s[k][i]) for k in ("acc", "f1", "prec", "rec")}


def fit_temperature(logits: np.ndarray, y: np.ndarray) -> float:
    return TemperatureScaler().fit(logits, y).temperature


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metrics(y, p, out_path: str | Path, title: str = "") -> Path:
    plt = _pyplot()
    ts = np.linspace(0, 1, 201)
    s = sweep_thresholds(y, p, ts)
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in ("acc", "f1", "prec", "rec"):
        ax.plot(ts, s[k], label=k)
    ax.set_xlabel("threshold")
    ax.set_title(title or "metrics vs threshold")
    ax.legend()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_roc(y, p, out_path: str | Path, title: str = "") -> Path:
    plt = _pyplot()
    order = np.argsort(-np.asarray(p))
    ys = np.asarray(y).astype(int)[order]
    tpr = np.cumsum(ys) / max(ys.sum(), 1)
    fpr = np.cumsum(1 - ys) / max((1 - ys).sum(), 1)
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    ax.plot(np.r_[0, fpr], np.r_[0, tpr])
    ax.plot([0, 1], [0, 1], "--", lw=0.8)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.set_title(title or f"ROC (AUC {roc_auc(y, p):.4f})")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def run_threshold_sweep(
    fold_logits_val: list[np.ndarray],
    fold_y_val: list[np.ndarray],
    fold_logits_test: list[np.ndarray],
    y_test: np.ndarray,
    objective: str = "max_acc",
    min_recall: float = 0.90,
    outdir: str | Path | None = None,
    make_plots: bool = True,
) -> dict:
    """Per fold: the temperature and the threshold fitted on val, applied
    to test; the aggregate mean ± std (ddof 0) over folds of every column;
    ``outdir``: threshold_sweep.csv and .json (and plots/ with
    ``make_plots``)."""
    rows = []
    for k, (lv, yv, lt) in enumerate(zip(fold_logits_val, fold_y_val, fold_logits_test)):
        T = fit_temperature(lv, yv)
        pv = 1 / (1 + np.exp(-lv / T))
        pt = 1 / (1 + np.exp(-lt / T))
        thr, val_at = pick_threshold(yv, pv, objective, min_recall)
        rep = binary_report(y_test, pt, thr)
        rows.append(
            {"fold": k, "T": T, "thr": thr, "val_acc": val_at["acc"], "val_f1": val_at["f1"],
             **{f"test_{m}": rep[m] for m in ("auc", "acc", "prec", "rec", "f1")}}
        )
        if outdir is not None and make_plots:
            plot_metrics(y_test, pt, Path(outdir) / f"plots/metrics_fold{k}.png", f"fold {k}")
            plot_roc(y_test, pt, Path(outdir) / f"plots/roc_fold{k}.png", f"fold {k}")

    cols = [c for c in rows[0] if c != "fold"] if rows else []
    agg = {}
    for c in cols:
        v = np.array([r[c] for r in rows], np.float64)
        agg[c] = {"mean": float(v.mean()), "std": float(v.std(ddof=0))}
    result = {"objective": objective, "min_recall": min_recall, "folds": rows, "aggregate": agg}
    if outdir is not None:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        to_csv(Table({c: np.array([r[c] for r in rows]) for c in (rows[0] if rows else [])}),
               outdir / "threshold_sweep.csv")
        save_json(result, outdir / "threshold_sweep.json")
    return result
