"""Tabular trainers on the port's GBDT (port of mmtrs_tpu/train/tabular.py),
on the port's :class:`~mmtrs_tpu_torch.utils.table.Table` (no pandas, no
sklearn):

- :func:`train_xgb_like` (models/xgboost_model.py:103-199): the train split,
  an optional min-consensus row drop, consensus^0.7 × balanced class
  weights, a stratified 80/20 val split, the binary forest with early
  stopping, sigmoid/isotonic calibration on val, the accuracy-tuned
  threshold; metrics_xgb.json, xgb_threshold.json and
  xgb_test_predictions.csv;
- :func:`train_lgbm_like` (models/lightgbm_model.py:59-126): regression on
  p_indirect clipped to (1e-3, 1 − 1e-3), consensus^0.5 weights, early stop
  on L2, probabilities clipped to [0, 1];
- :func:`train_tab_kfold`: k-fold forests on the 16 features, saved as
  ``tab_fold{k}``, which :func:`load_tab_ensemble` and the service's
  ``TabEnsemble`` read;
- :func:`predict_tab_ensemble`: the fold forests' mean probability.

The forests grow on ``device`` (None: the card); the rest is host numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.config import GBDTConfig
from mmtrs_tpu_torch.data.features import (
    DEFAULT_MONOTONE,
    LABEL_HARD,
    LABEL_SOFT,
    SAMPLE_WEIGHT,
    features_to_array,
)
from mmtrs_tpu_torch.data.splits import group_kfold, stratified_shuffle_split
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.binary import binary_report
from mmtrs_tpu_torch.metrics.thresholds import tune_threshold
from mmtrs_tpu_torch.models.gbdt import Forest, consensus_sample_weights, predict_proba, train_gbdt
from mmtrs_tpu_torch.models.linear import make_calibrator
from mmtrs_tpu_torch.utils.io import save_json
from mmtrs_tpu_torch.utils.table import Table, to_csv


def split_is(table: Table, *names: str) -> np.ndarray:
    """Rows whose ``split`` (as lower-case text) is one of ``names``."""
    return np.isin(np.array([str(s).lower() for s in table["split"]], dtype=object), names)


def _proba(forest: Forest, X: np.ndarray) -> np.ndarray:
    return predict_proba(forest, X).double().cpu().numpy()


def _write_test_predictions(path: Path, yte: np.ndarray, p_te: np.ndarray, thr: float) -> None:
    to_csv(Table({"y_true": yte, "score_prob_indirect": p_te, "y_pred": (p_te >= thr).astype(np.int64)}), path)


def _metrics_payload(rep: dict) -> dict:
    return {k: rep[k] for k in ("auc", "acc", "prec", "rec", "f1", "brier")}


def train_xgb_like(
    table: Table,
    outdir: str | Path | None = None,
    cfg: GBDTConfig | None = None,
    min_weight: float = 0.0,
    calibration: str = "sigmoid",
    thr_metric: str = "accuracy",
    monotone: bool = False,
    seed: int = 42,
    device: str | torch.device | None = None,
) -> dict:
    dev = resolve_device(device)
    cfg = cfg or GBDTConfig(monotone_constraints=DEFAULT_MONOTONE + (0,) * 7 if monotone else None)
    tr = table.take(split_is(table, "train"))
    if min_weight > 0:  # drop low-consensus rows (:121-125)
        tr = tr.take(np.asarray(tr[SAMPLE_WEIGHT]) >= min_weight)
    X = features_to_array(tr)
    y = tr[LABEL_HARD].astype(int)
    w = consensus_sample_weights(tr[SAMPLE_WEIGHT], y, cfg.consensus_power, cfg.class_balanced)
    tr_i, va_i = stratified_shuffle_split(y, 0.2, seed)  # stratified 80/20 val (:138-140)
    forest = train_gbdt(X[tr_i], y[tr_i], cfg, sample_weight=w[tr_i], X_val=X[va_i], y_val=y[va_i],
                        device=dev)
    p_va_raw = _proba(forest, X[va_i])
    cal = make_calibrator(calibration, p_va_raw, y[va_i], device=dev)
    p_val = np.clip(cal.transform(p_va_raw), 0, 1)
    thr, _ = tune_threshold(y[va_i], p_val, thr_metric)

    result = {"forest": forest, "calibrator": cal, "thr": thr}
    te = table.take(split_is(table, "test"))
    if len(te):
        yte = te[LABEL_HARD].astype(int)
        p_te = np.clip(cal.transform(_proba(forest, features_to_array(te))), 0, 1)
        rep = binary_report(yte, p_te, thr)
        result["test_metrics"] = rep
        if outdir is not None:
            outdir = Path(outdir)
            outdir.mkdir(parents=True, exist_ok=True)
            forest.save(outdir / "xgb_forest")
            save_json({"threshold": thr, "metric": thr_metric}, outdir / "xgb_threshold.json")
            save_json(_metrics_payload(rep), outdir / "metrics_xgb.json")
            _write_test_predictions(outdir / "xgb_test_predictions.csv", yte, p_te, thr)
    return result


def train_lgbm_like(
    table: Table,
    outdir: str | Path | None = None,
    cfg: GBDTConfig | None = None,
    seed: int = 42,
    device: str | torch.device | None = None,
) -> dict:
    dev = resolve_device(device)
    cfg = cfg or GBDTConfig.lgbm_like()
    tr = table.take(split_is(table, "train"))
    X = features_to_array(tr)
    y = tr[LABEL_HARD].astype(int)
    p = np.clip(np.asarray(tr[LABEL_SOFT], dtype=np.float32), 1e-3, 1 - 1e-3)  # (:79-80)
    w = consensus_sample_weights(tr[SAMPLE_WEIGHT], y, cfg.consensus_power, cfg.class_balanced)
    tr_i, va_i = stratified_shuffle_split(y, 0.2, seed)
    forest = train_gbdt(X[tr_i], p[tr_i], cfg, sample_weight=w[tr_i], X_val=X[va_i], y_val=p[va_i],
                        device=dev)
    result = {"forest": forest}
    te = table.take(split_is(table, "test"))
    if len(te):
        yte = te[LABEL_HARD].astype(int)
        p_te = _proba(forest, features_to_array(te))  # clipped to [0, 1] (LGBMProbWrapper)
        rep = binary_report(yte, p_te, 0.5)
        result["test_metrics"] = rep
        if outdir is not None:
            outdir = Path(outdir)
            outdir.mkdir(parents=True, exist_ok=True)
            forest.save(outdir / "lgbm_forest")
            save_json(_metrics_payload(rep), outdir / "metrics_lgbm.json")
            _write_test_predictions(outdir / "lgbm_test_predictions.csv", yte, p_te, 0.5)
    return result


def train_tab_kfold(
    table: Table,
    outdir: str | Path | None = None,
    n_folds: int = 5,
    cfg: GBDTConfig | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """k-fold GBDT classifiers on the 16 features, grouped by origin_id
    (each row its own group when the table has none); per-fold forests
    saved as ``tab_fold{k}``; serving averages their probabilities
    (tab_model.py:90-122)."""
    dev = resolve_device(device)
    cfg = cfg or GBDTConfig.stack_tab_like()
    tv = table.take(split_is(table, "train", "val"))
    X = features_to_array(tv)
    y = tv[LABEL_HARD].astype(int)
    groups = tv["origin_id"] if "origin_id" in tv else np.arange(len(tv))
    forests = []
    for fold, (tr, va) in enumerate(group_kfold(groups, n_folds)):
        f = train_gbdt(X[tr], y[tr], cfg, X_val=X[va], y_val=y[va], device=dev)
        forests.append(f)
        if outdir is not None:
            Path(outdir).mkdir(parents=True, exist_ok=True)
            f.save(Path(outdir) / f"tab_fold{fold}")
    return {"forests": forests}


def predict_tab_ensemble(forests: list[Forest], table: Table) -> np.ndarray:
    """The forests' mean probability on ``table``'s 16 features (float64)."""
    X = features_to_array(table)
    return np.mean([_proba(f, X) for f in forests], axis=0)


def load_tab_ensemble(folder: str | Path, device: str | torch.device | None = None) -> list[Forest]:
    """Every ``tab_fold*`` forest of ``folder``, in name order, on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    return [Forest.load(p.with_suffix(""), dev) for p in sorted(Path(folder).glob("tab_fold*.npz"))]
