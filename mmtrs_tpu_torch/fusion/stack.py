"""Late-fusion stacking, the headline system (port of
mmtrs_tpu/fusion/stack.py on the port's Table; no pandas, no sklearn).

- :func:`fit_tab_oof` (stack_blend.py:94-191): per-fold tabular GBDT OOF on
  2 continuous + 7 categorical raw features (continuous gaps filled with
  the column median, categorical ones with −1, constant features dropped),
  GroupKFold on origin_id (else image_id, else each row alone);
- :func:`run_final_stack` (stack_blend.py:195-288): inner joins of the tab
  OOF with the MM (and MIL) prediction tables on (image_name, y), in pandas
  ``merge``'s order (each left row in turn, with its matches in the right
  table's order; the key columns are the left table's), the L2 logistic
  meta on the stream probabilities, the OOF threshold, and the
  stack_oof.csv / stack_test.csv / summary.json trio;
- :func:`run_tabular_stack` (models/stack_blend.py:149-210): StratifiedKFold
  OOF of the XGB-like and LGBM-like forests, the balanced logistic meta,
  the OOF threshold and fold-averaged test predictions.

Forests and logistic fits run on ``device`` (None: the card). ``draws_for``
(rows, features) → :class:`~mmtrs_tpu_torch.models.gbdt.GBDTDraws` gives a
fold's subsampling; by default each fold draws from ``cfg.seed``, as each
JAX fold takes the same key.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from mmtrs_tpu_torch.config import FusionConfig, GBDTConfig
from mmtrs_tpu_torch.data.features import features_to_array, to_numeric
from mmtrs_tpu_torch.data.splits import group_kfold, stratified_kfold
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.binary import summary_payload
from mmtrs_tpu_torch.metrics.thresholds import choose_threshold, sweep_thresholds, threshold_grid
from mmtrs_tpu_torch.models.gbdt import GBDTDraws, consensus_sample_weights, predict_proba, train_gbdt
from mmtrs_tpu_torch.models.linear import LogisticRegression
from mmtrs_tpu_torch.utils.io import save_json
from mmtrs_tpu_torch.utils.table import Table, join_key, to_csv

# stack_blend.py:88-92: the raw-feature view of the final tab stream
CONT_ALL = ["depth", "width"]
CAT_ALL = [
    "enamel_cracks",
    "occlusal_load",
    "carious_lesion",
    "opposing_type",
    "adjacent_teeth",
    "age_range",
    "cervical_lesion",
]

DrawsFor = Callable[[int, int], GBDTDraws]


def _draws(draws_for: DrawsFor | None, n: int, n_feat: int) -> GBDTDraws | None:
    return None if draws_for is None else draws_for(n, n_feat)


def _proba(forest, X: np.ndarray) -> np.ndarray:
    return predict_proba(forest, X).double().cpu().numpy()


def merge_inner(left: Table, right: Table, on=("image_name", "y")) -> Table:
    """pandas ``left.merge(right, on=on, how="inner")``: each left row in
    turn with each of its matches in right's order; the key columns are
    left's, numbers compared as floats (1 matches 1.0)."""
    key = lambda t, i: tuple(join_key(t[c][i]) for c in on)
    matches: dict = {}
    for j in range(len(right)):
        matches.setdefault(key(right, j), []).append(j)
    li, ri = [], []
    for i in range(len(left)):
        for j in matches.get(key(left, i), []):
            li.append(i)
            ri.append(j)
    out = left.take(np.asarray(li, dtype=np.int64))
    r = right.take(np.asarray(ri, dtype=np.int64))
    for c in right.columns:
        if c not in on:
            out[c] = r[c]
    return out


def _renamed(table: Table, old: str, new: str) -> Table:
    return Table({(new if c == old else c): table[c] for c in table.columns})


def fit_tab_oof(
    df_tab: Table,
    folds: int = 5,
    cfg: GBDTConfig | None = None,
    device: str | torch.device | None = None,
    draws_for: DrawsFor | None = None,
) -> tuple[Table, Table]:
    """GroupKFold OOF and fold-averaged test predictions of the tabular
    stream → (oof, test), each with columns image_name, y, prob."""
    dev = resolve_device(device)
    cfg = cfg or GBDTConfig.stack_tab_like()
    assert "split" in df_tab and "y_majority" in df_tab
    df = df_tab.copy()
    for c in CONT_ALL:
        col = to_numeric(df[c]) if c in df else np.full(len(df), np.nan)
        med = np.nanmedian(col) if np.isfinite(col).any() else np.nan
        df[c] = np.where(np.isnan(col), med, col)
    for c in CAT_ALL:
        col = to_numeric(df[c]) if c in df else np.full(len(df), np.nan)
        df[c] = np.where(np.isnan(col), -1.0, col).astype(np.int64)

    # drop constant features (stack_blend.py:111-117); NaN is not a value
    def n_unique(col):
        col = np.asarray(col, dtype=np.float64)
        return len(np.unique(col[~np.isnan(col)]))

    feats = [c for c in CONT_ALL + CAT_ALL if n_unique(df[c]) > 1]

    split = df["split"]
    df_tv = df.take(np.isin(split, ["train", "val"]))
    df_te = df.take(split == "test")
    if "origin_id" in df_tv:
        groups = df_tv["origin_id"]
    elif "image_id" in df_tv:
        groups = df_tv["image_id"]
    else:
        groups = np.arange(len(df_tv))

    X_tv = np.stack([df_tv[c] for c in feats], axis=1).astype(np.float32)
    y_tv = df_tv["y_majority"].astype(int)
    X_te = np.stack([df_te[c] for c in feats], axis=1).astype(np.float32)

    oof = np.zeros(len(df_tv))
    test_pred = np.zeros(len(df_te))
    for tr, va in group_kfold(groups, folds):
        sw = consensus_sample_weights(np.ones(len(tr)), y_tv[tr], consensus_power=0.0,
                                      class_balanced=cfg.class_balanced)
        f = train_gbdt(X_tv[tr], y_tv[tr], cfg, sample_weight=sw, X_val=X_tv[va], y_val=y_tv[va],
                       draws=_draws(draws_for, len(tr), len(feats)), device=dev)
        oof[va] = _proba(f, X_tv[va])
        if len(df_te):
            test_pred += _proba(f, X_te) / folds

    oof_t = Table({"image_name": df_tv["image_name"], "y": df_tv["y_majority"], "prob": oof})
    te_t = Table({"image_name": df_te["image_name"], "y": df_te["y_majority"], "prob": test_pred})
    return oof_t, te_t


def run_final_stack(
    df_tab: Table,
    oof_mm: Table,
    pred_mm: Table,
    oof_mil: Table | None = None,
    pred_mil: Table | None = None,
    outdir: str | Path | None = None,
    cfg: FusionConfig = FusionConfig(),
    tab_cfg: GBDTConfig | None = None,
    device: str | torch.device | None = None,
    draws_for: DrawsFor | None = None,
) -> dict:
    """The headline pipeline (stack_blend.py:195-288) → the summary dict;
    writes stack_oof.csv, stack_test.csv and summary.json to ``outdir``."""
    dev = resolve_device(device)
    tab_oof, tab_test = fit_tab_oof(df_tab, folds=cfg.n_folds, cfg=tab_cfg, device=dev, draws_for=draws_for)
    oof = merge_inner(_renamed(tab_oof, "prob", "prob_tab"), _renamed(oof_mm, "prob", "prob_mm"))
    test = merge_inner(_renamed(tab_test, "prob", "prob_tab"), _renamed(pred_mm, "prob", "prob_mm"))
    use_mil = oof_mil is not None and pred_mil is not None
    if use_mil:
        oof = merge_inner(oof, _renamed(oof_mil, "prob", "prob_mil"))
        test = merge_inner(test, _renamed(pred_mil, "prob", "prob_mil"))

    feat_cols = ["prob_tab", "prob_mm"] + (["prob_mil"] if use_mil else [])
    X_oof = np.stack([oof[c] for c in feat_cols], axis=1).astype(float)
    y_oof = oof["y"].astype(int)
    meta = LogisticRegression(penalty="l2", C=1.0, max_iter=cfg.meta_max_iter).fit(X_oof, y_oof, device=dev)
    p_oof = meta.predict_proba(X_oof)[:, 1]
    thr = choose_threshold(y_oof, p_oof, mode=cfg.thr_mode, target=cfg.thr_target)
    X_te = np.stack([test[c] for c in feat_cols], axis=1).astype(float).reshape(len(test), len(feat_cols))
    p_te = meta.predict_proba(X_te)[:, 1]
    y_te = test["y"].astype(int)

    summary = {
        "oof": summary_payload(y_oof, p_oof, thr),
        "test": summary_payload(y_te, p_te, thr),
        "thr": float(np.round(thr, 4)),
        "thr_mode": cfg.thr_mode,
        "thr_target": cfg.thr_target,
        "features": feat_cols,
        "meta_coef": meta.coef_.tolist(),
        "meta_intercept": meta.intercept_,
    }
    if outdir is not None:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        to_csv(Table({"image_name": oof["image_name"], "y": oof["y"], "prob": p_oof}), outdir / "stack_oof.csv")
        to_csv(Table({"image_name": test["image_name"], "y": test["y"], "prob": p_te}), outdir / "stack_test.csv")
        save_json(summary, outdir / "summary.json")
    return summary


def run_tabular_stack(
    df: Table,
    outdir: str | Path | None = None,
    n_folds: int = 5,
    seed: int = 42,
    thr_metric: str = "accuracy",
    device: str | torch.device | None = None,
    draws_for: tuple[DrawsFor, DrawsFor] | None = None,
) -> dict:
    """Tabular-only stack (models/stack_blend.py:149-210): StratifiedKFold
    OOF of the XGB-like and LGBM-like forests → balanced logistic meta →
    OOF threshold over the fusion grid → fold-averaged test predictions.
    ``draws_for``: the XGB-like and the LGBM-like forests' subsampling."""
    dev = resolve_device(device)
    X = features_to_array(df)
    y = df["y_majority"].astype(int)
    p_soft = np.clip(np.asarray(df["p_indirect"], dtype=np.float32), 1e-3, 1 - 1e-3)
    w = np.asarray(df["weight"], dtype=np.float32)
    is_tr = df["split"] == "train"

    Xtr, ytr, ptr, wtr = X[is_tr], y[is_tr], p_soft[is_tr], w[is_tr]
    Xte, yte = X[~is_tr], y[~is_tr]
    xgb_cfg, lgb_cfg = GBDTConfig(), GBDTConfig.lgbm_like()
    dx, dl = draws_for if draws_for is not None else (None, None)

    oof = np.zeros((len(Xtr), 2))
    test_pred = np.zeros((len(Xte), 2))
    for tr, va in stratified_kfold(ytr, n_folds, seed):
        sw_x = consensus_sample_weights(wtr[tr], ytr[tr], xgb_cfg.consensus_power, True)
        fx = train_gbdt(Xtr[tr], ytr[tr], xgb_cfg, sample_weight=sw_x, X_val=Xtr[va], y_val=ytr[va],
                        draws=_draws(dx, len(tr), X.shape[1]), device=dev)
        sw_l = consensus_sample_weights(wtr[tr], ytr[tr], lgb_cfg.consensus_power, False)
        fl = train_gbdt(Xtr[tr], ptr[tr], lgb_cfg, sample_weight=sw_l, X_val=Xtr[va], y_val=ptr[va],
                        draws=_draws(dl, len(tr), X.shape[1]), device=dev)
        oof[va, 0] = _proba(fx, Xtr[va])
        oof[va, 1] = _proba(fl, Xtr[va])
        test_pred[:, 0] += _proba(fx, Xte) / n_folds
        test_pred[:, 1] += _proba(fl, Xte) / n_folds

    meta = LogisticRegression(penalty="l2", class_weight="balanced", max_iter=1000).fit(oof, ytr, device=dev)
    p_oof = meta.predict_proba(oof)[:, 1]
    ts = threshold_grid("fusion")
    s = sweep_thresholds(ytr, p_oof, ts)
    key = {"f1": "f1", "accuracy": "acc", "balanced_accuracy": "bal_acc"}[thr_metric]
    thr = float(ts[int(np.argmax(s[key]))])

    p_te = meta.predict_proba(test_pred)[:, 1]
    summary = {
        "oof": summary_payload(ytr, p_oof, thr),
        "test": summary_payload(yte, p_te, thr),
        "thr": round(thr, 4),
        "streams": ["xgb", "lgbm"],
        "meta_coef": meta.coef_.tolist(),
    }
    if outdir is not None:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        to_csv(Table({"y_true": yte, "score_prob_indirect": p_te, "y_pred": (p_te >= thr).astype(np.int64)}),
               outdir / "stack_test_predictions.csv")
        save_json({"threshold": thr}, outdir / "stack_params.json")
        save_json(summary, outdir / "metrics_stack.json")
    return summary
