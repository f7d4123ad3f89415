"""Balanced 3-way split CLI (the twin of scripts/make_balanced_splits.py).

Usage:
  python -m mmtrs_tpu_torch.cli.make_balanced_splits --table data_dl_augmented.csv \\
      --out data_dl_augmented_split [--train 0.7 --val 0.15 --test 0.15] [--seed 42] [--trials 400]

Applies the 400-trial balanced grouped split to the base rows (``aug_idx ==
0`` when the table has that column; a table without the group column gets
one group a base row, joined to every row on ``image_name``), propagates the
split to the augmented rows, fails hard if any group spans splits, writes
``<out>.csv`` (CSV only) and prints the audit report. Host numpy only:
``--device`` is accepted for the entry points' common flag and checked.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.data.splits import (
    ThreeWaySplitConfig,
    assert_no_group_leakage,
    audit_report,
    balanced_grouped_split,
    propagate_split_to_augmented,
)
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.utils.io import read_table, write_table
from mmtrs_tpu_torch.utils.table import merge_left


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Balanced grouped train/val/test split")
    p.add_argument("--table", required=True)
    p.add_argument("--out", required=True, help="output path stem")
    p.add_argument("--train", type=float, default=0.70)
    p.add_argument("--val", type=float, default=0.15)
    p.add_argument("--test", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--trials", type=int, default=400)
    p.add_argument("--label-col", default="y_majority")
    p.add_argument("--group-col", default="origin_id")
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    df = read_table(args.table)

    # base rows: aug_idx == 0 when present (make_balanced_splits.py:123-171)
    base = df.take(np.asarray(df["aug_idx"]) == 0) if "aug_idx" in df else df.copy()
    if args.group_col not in base:
        base[args.group_col] = np.arange(len(base))
        if args.group_col not in df:
            df = merge_left(df, base.select(["image_name", args.group_col]), "image_name")

    cfg = ThreeWaySplitConfig(
        train_frac=args.train, val_frac=args.val, test_frac=args.test,
        seed=args.seed, group_col=args.group_col, label_col=args.label_col,
        max_trials=args.trials,
    )
    tr, va, te = balanced_grouped_split(base, cfg)
    split = np.array(["train"] * len(base), dtype=object)
    split[va] = "val"
    split[te] = "test"
    base["split"] = split

    out = propagate_split_to_augmented(df, base, group_col=args.group_col)
    assert_no_group_leakage(out, args.group_col)  # hard fail (:193-209)

    written = write_table(out, Path(args.out))
    print(f"wrote {written}")
    print("audit:", audit_report(out, args.label_col))
    return 0


if __name__ == "__main__":
    sys.exit(main())
