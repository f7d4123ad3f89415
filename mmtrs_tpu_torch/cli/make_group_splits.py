"""K-fold split exporter (the twin of scripts/make_group_splits.py).

Usage:
  python -m mmtrs_tpu_torch.cli.make_group_splits --csv data_dl_augmented.csv \\
      --outdir data/splits [--folds 5] [--test-prop 0.2] [--seed 42]

A grouped test holdout, then stratified grouped k-fold ids on the rest
(``data.splits.make_group_fold_table``); writes folds_group.csv, each fold's
train_fold{k}.csv and val_fold{k}.csv, and test.csv when there is a holdout.
It fails hard if any group spans splits. Host numpy only: ``--device`` is
accepted for the entry points' common flag and checked.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.data.splits import assert_no_group_leakage, make_group_fold_table
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.utils.io import read_table
from mmtrs_tpu_torch.utils.table import to_csv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Grouped test holdout and stratified grouped k-fold ids")
    p.add_argument("--csv", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--test-prop", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--label-col", default="y_majority")
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    df = read_table(args.csv)
    out = make_group_fold_table(df, n_folds=args.folds, test_prop=args.test_prop, seed=args.seed,
                                label_col=args.label_col)
    assert_no_group_leakage(out)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    to_csv(out, outdir / "folds_group.csv")
    print(f"Saved {outdir / 'folds_group.csv'}")
    fold, test = np.asarray(out["fold"]), np.asarray(out["split"]) == "test"
    for k in range(args.folds):
        to_csv(out.take((fold != k) & ~test), outdir / f"train_fold{k}.csv")
        to_csv(out.take((fold == k) & ~test), outdir / f"val_fold{k}.csv")
    if test.any():
        to_csv(out.take(test), outdir / "test.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
