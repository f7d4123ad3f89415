"""Generic multi-stream fusion trainer (port of mmtrs_tpu/fusion/fuse.py;
src/fusion/fuse_train.py:30-132 parity).

Streams (any subset of v_hard / v_soft / xgb / lgbm, or any named streams)
are calibrated one by one on VAL; then an L1 MetaStacker and a
non-negative simplex weight blend are fitted, and the one with the higher
val F1 wins (the blend on a tie). Writes fusion_summary.json, P_val.npy and
P_test.npy. The Platt and L1 fits run on ``device`` (None: the card).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.fusion.meta import MetaStacker
from mmtrs_tpu_torch.fusion.weight_search import search_weights
from mmtrs_tpu_torch.metrics.binary import evaluate
from mmtrs_tpu_torch.metrics.thresholds import tune_threshold
from mmtrs_tpu_torch.models.linear import make_calibrator
from mmtrs_tpu_torch.utils.io import save_json


def fit_fusion(
    streams_val: dict[str, np.ndarray],
    y_val: np.ndarray,
    streams_test: dict[str, np.ndarray],
    y_test: np.ndarray,
    out_dir: str | Path | None = None,
    calibrator_kind: str = "isotonic",
    threshold_metric: str = "f1",
    device: str | torch.device | None = None,
) -> dict:
    dev = resolve_device(device)
    used = [k for k, v in streams_val.items() if v is not None and streams_test.get(k) is not None]
    if not used:
        raise RuntimeError("No base predictions available for fusion.")

    P_val = np.stack([np.asarray(streams_val[k], dtype=float).reshape(-1) for k in used], axis=1)
    P_test = np.stack([np.asarray(streams_test[k], dtype=float).reshape(-1) for k in used], axis=1)
    y_val = np.asarray(y_val).astype(int)
    y_test = np.asarray(y_test).astype(int)

    # per-stream calibration on val (fuse_train.py:87-90)
    for i in range(P_val.shape[1]):
        cal = make_calibrator(calibrator_kind, P_val[:, i], y_val, device=dev)
        P_val[:, i] = np.clip(cal.transform(P_val[:, i]), 0, 1)
        P_test[:, i] = np.clip(cal.transform(P_test[:, i]), 0, 1)

    stacker = MetaStacker(C=1.0, device=dev).fit(P_val, y_val)
    p_val_stacked = stacker.predict_proba(P_val)
    t_stacked, _ = tune_threshold(y_val, p_val_stacked, threshold_metric)
    val_stacked = evaluate(y_val, p_val_stacked, t_stacked)

    blend = search_weights(P_val, y_val, metric="f1", step=0.1, threshold_mode="tune")
    p_val_blend = (P_val * np.asarray(blend["weights"]).reshape(1, -1)).sum(axis=1)
    val_blend = evaluate(y_val, p_val_blend, blend["threshold"])

    use_blend = val_blend["f1"] >= val_stacked["f1"]
    choice = "blend" if use_blend else "stack"
    if use_blend:
        p_test = (P_test * np.asarray(blend["weights"]).reshape(1, -1)).sum(axis=1)
        t = blend["threshold"]
    else:
        p_test = stacker.predict_proba(P_test)
        t = t_stacked

    meta = {
        "choice": choice,
        "streams_used": used,
        "calibrator": calibrator_kind,
        "stack": {"weights": stacker.weights_, "threshold": t_stacked, "val_metrics": val_stacked},
        "blend": {"weights": blend["weights"], "threshold": blend["threshold"], "val_metrics": val_blend},
        "test_metrics": evaluate(y_test, p_test, t),
        "threshold": t,
    }
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        save_json(meta, out_dir / "fusion_summary.json")
        np.save(out_dir / "P_val.npy", P_val)
        np.save(out_dir / "P_test.npy", P_test)
    return meta
