"""Fusion CLI on the card (the twin of run_fusion.py).

Usage:
  python -m mmtrs_tpu_torch.cli.run_fusion train --data preds.csv [--out_dir weights/fusion]
      [--calibrator isotonic|platt|none] [--threshold-metric f1] [--val-ratio 0.2]
      [--seed 42] [--device cuda]
  python -m mmtrs_tpu_torch.cli.run_fusion info --fusion_dir weights/fusion
  python -m mmtrs_tpu_torch.cli.run_fusion infer-one --streams '{"prob_mm": 0.8}'
  python -m mmtrs_tpu_torch.cli.run_fusion infer-batch --data preds.csv [--split test]
      [--out_dir .] [--threshold T]

``train`` fits the generic fusion (``fusion.fuse.fit_fusion``) from a CSV
with y_majority, split and one column per stream (any of v_hard, v_soft,
xgb, lgbm, prob_tab, prob_mm, prob_mil): the val rows, or a stratified
``--val-ratio`` share of the train rows when there are none, against the
test rows. It writes what the JAX CLI writes: fusion_summary.json,
P_val.npy and P_test.npy. ``infer-batch`` writes
``<out_dir>/hybrid_<split>_predictions.csv``. The calibration and the L1
meta fit run on ``--device`` (default: the card).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.data.splits import stratified_shuffle_split
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.fusion.fuse import fit_fusion
from mmtrs_tpu_torch.fusion.infer import fuse_streams, load_recipe
from mmtrs_tpu_torch.utils.io import read_table
from mmtrs_tpu_torch.utils.table import Table, to_csv

KNOWN_STREAMS = ["v_hard", "v_soft", "xgb", "lgbm", "prob_tab", "prob_mm", "prob_mil"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Late-fusion train/info/infer on the card")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--data", required=True, help="CSV with y_majority, split, stream cols")
    t.add_argument("--out_dir", default="weights/fusion")
    t.add_argument("--calibrator", default="isotonic", choices=["isotonic", "platt", "none"])
    t.add_argument("--threshold-metric", default="f1")
    t.add_argument("--val-ratio", type=float, default=0.2)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--device", default=None, help="torch device (default: the card)")

    i = sub.add_parser("info")
    i.add_argument("--fusion_dir", default="weights/fusion")

    o = sub.add_parser("infer-one")
    o.add_argument("--fusion_dir", default="weights/fusion")
    o.add_argument("--streams", required=True, help='JSON, e.g. \'{"v_hard": 0.8, "xgb": 0.6}\'')
    o.add_argument("--threshold", type=float, default=None)

    b = sub.add_parser("infer-batch")
    b.add_argument("--fusion_dir", default="weights/fusion")
    b.add_argument("--data", required=True)
    b.add_argument("--split", default="test")
    b.add_argument("--out_dir", default=".")
    b.add_argument("--threshold", type=float, default=None)
    return p


def _lower_split(table: Table) -> np.ndarray:
    return np.array([str(s).lower() for s in table["split"]], dtype=object)


def cmd_train(args) -> int:
    dev = resolve_device(args.device)
    df = read_table(args.data)
    df["split"] = _lower_split(df)
    cols = [c for c in KNOWN_STREAMS if c in df]
    if not cols:
        print(f"[error] no stream columns found (looked for {KNOWN_STREAMS})")
        return 1
    if not (df["split"] == "test").any():
        print("[error] no test split rows")
        return 1
    if (df["split"] == "val").any():
        dval = df.take(df["split"] == "val")
    else:  # a stratified val from train (fuse_train.py:40-53)
        dtr = df.take(df["split"] == "train")
        _, vi = stratified_shuffle_split(dtr["y_majority"].astype(int), args.val_ratio, args.seed)
        dval = dtr.take(vi)
        print(f"[INFO] auto-created VAL from TRAIN: {len(dval)} rows")
    dte = df.take(df["split"] == "test")

    meta = fit_fusion(
        {c: dval[c] for c in cols}, dval["y_majority"].astype(int),
        {c: dte[c] for c in cols}, dte["y_majority"].astype(int),
        out_dir=args.out_dir, calibrator_kind=args.calibrator,
        threshold_metric=args.threshold_metric, device=dev,
    )
    print("== Fusion selection ==", meta["choice"])
    print("TEST:", {k: round(v, 4) for k, v in meta["test_metrics"].items() if isinstance(v, float)})
    return 0


def cmd_info(args) -> int:
    print(json.dumps(load_recipe(args.fusion_dir), indent=2))
    return 0


def cmd_infer_one(args) -> int:
    out = fuse_streams(load_recipe(args.fusion_dir), json.loads(args.streams), override_threshold=args.threshold)
    print(json.dumps(out, indent=2))
    return 0


def cmd_infer_batch(args) -> int:
    rec = load_recipe(args.fusion_dir)
    df = read_table(args.data)
    if "split" in df:
        df = df.take(_lower_split(df) == args.split)
    cols = [c for c in rec["streams_used"] if c in df]
    names = df["image_name"] if "image_name" in df else [""] * len(df)
    rows = []
    for i in range(len(df)):
        out = fuse_streams(rec, {c: float(df[c][i]) for c in cols}, override_threshold=args.threshold)
        rows.append((names[i], out["p_indirect"], out["label"], out["threshold"]))
    out_path = Path(args.out_dir) / f"hybrid_{args.split}_predictions.csv"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if rows:
        cols_out = ("image_name", "p_indirect", "label", "threshold")
        to_csv(Table({c: [r[k] for r in rows] for k, c in enumerate(cols_out)}), out_path)
    else:  # what pandas writes for a frame with no columns
        out_path.write_text("\n")
    print(f"wrote {out_path} ({len(rows)} rows)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "info": cmd_info,
            "infer-one": cmd_infer_one, "infer-batch": cmd_infer_batch}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
