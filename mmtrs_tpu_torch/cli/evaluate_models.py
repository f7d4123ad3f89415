"""Tabular evaluation CLI on the card (the twin of scripts/evaluate_models.py).

Usage:
  python -m mmtrs_tpu_torch.cli.evaluate_models --data data_processed.csv \\
      --xgb models/outputs/xgb_forest --lgbm models/outputs/lgbm_forest \\
      [--which xgb|lgbm|both|blend] [--outdir models/outputs] [--device cuda]

Evaluates saved forests (``Forest.load``) on the table's test split at 0.5;
``--which blend`` tunes α·xgb + (1 − α)·lgbm over α in 0, 0.05, …, 1 and the
threshold on the fusion grid for accuracy on the TRAIN split, as the JAX
script does, then reports the blend on test. With ``--outdir`` it writes
evaluation.json, and for the blend blend_params.json and metrics_blend.json.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate saved forests on the card")
    p.add_argument("--data", required=True)
    p.add_argument("--xgb", default=None, help="path prefix of saved xgb Forest")
    p.add_argument("--lgbm", default=None, help="path prefix of saved lgbm Forest")
    p.add_argument("--which", default="both", choices=["xgb", "lgbm", "both", "blend"])
    p.add_argument("--outdir", default=None)
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mmtrs_tpu_torch.data.features import features_to_array
    from mmtrs_tpu_torch.metrics.binary import binary_report
    from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds, threshold_grid
    from mmtrs_tpu_torch.models.gbdt import Forest, predict_proba
    from mmtrs_tpu_torch.utils.io import read_table, save_json

    dev = resolve_device(args.device)
    df = read_table(args.data)
    split = np.array([str(s).lower() for s in df["split"].tolist()], dtype=object)
    te, tr = df.take(split == "test"), df.take(split == "train")
    X_te, X_tr = features_to_array(te), features_to_array(tr)
    y_te = np.asarray(te["y_majority"]).astype(int)
    y_tr = np.asarray(tr["y_majority"]).astype(int)

    def proba(forest, X):
        return predict_proba(forest, X).cpu().numpy()

    preds = {}
    for name, path in (("xgb", args.xgb), ("lgbm", args.lgbm)):
        if path and args.which in (name, "both", "blend"):
            f = Forest.load(path, device=dev)
            preds[name] = (proba(f, X_te), proba(f, X_tr))

    results = {}
    for name, (p_te, _) in preds.items():
        rep = binary_report(y_te, p_te, 0.5)
        results[name] = {k: round(rep[k], 4) for k in ("auc", "acc", "prec", "rec", "f1")}
        print(f"[{name}] {results[name]}")

    if args.which == "blend" and len(preds) == 2:
        ts = threshold_grid("fusion")
        best = {"score": -1.0}
        # the blend in f32, as the JAX script's (x64 off) arithmetic on its f32 forests' p
        blend = lambda a, i: np.float32(a) * preds["xgb"][i] + np.float32(1 - a) * preds["lgbm"][i]
        for alpha in np.linspace(0, 1, 21):  # α tuned on train
            p_tr = blend(alpha, 1)
            s = sweep_thresholds(y_tr, p_tr, ts)
            i = int(np.argmax(s["acc"]))
            if s["acc"][i] > best["score"]:
                best = {"score": float(s["acc"][i]), "alpha": float(alpha), "thr": float(ts[i])}
        p_te = blend(best["alpha"], 0)
        rep = binary_report(y_te, p_te, best["thr"])
        results["blend"] = {"alpha": best["alpha"], "thr": round(best["thr"], 4),
                            **{k: round(rep[k], 4) for k in ("auc", "acc", "prec", "rec", "f1")}}
        print(f"[blend] {results['blend']}")
        if args.outdir:
            save_json({"alpha": best["alpha"], "threshold": best["thr"]}, Path(args.outdir) / "blend_params.json")
            save_json(results["blend"], Path(args.outdir) / "metrics_blend.json")

    if args.outdir:
        save_json(results, Path(args.outdir) / "evaluation.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
