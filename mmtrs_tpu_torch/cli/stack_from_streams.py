"""Replay a rehearsal's final stack from its stream artifacts (the twin of
scripts/stack_from_streams.py).

Usage:
  python -m mmtrs_tpu_torch.cli.stack_from_streams [--dir results/rehearsal_h100]
      [--n 422] [--n_aug 10] [--folds 5] [--device cuda]

The stream runners write ``oof_val.csv``, ``pred_test.csv`` and
``summary.json`` as soon as their stage ends, so what follows them is
deterministic: this rebuilds the cohort and the lineage table with the
rehearsal's seeds (cohort 2026, augmentation 42), reads ``mm/`` and ``mil/``,
checks that the table describes the rows they scored, reruns the final
stack into ``<dir>/stack`` and writes ``<dir>/summary.json`` with the same
strict ``stack_beats_streams``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from mmtrs_tpu_torch.cli.rehearsal import best_stream_auc, platform_name, rehearsal_table, run_stack
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.utils.io import read_table, save_json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Rebuild a rehearsal's final stack from its stream CSVs")
    ap.add_argument("--dir", default="results/rehearsal_h100")
    ap.add_argument("--n", type=int, default=422)
    ap.add_argument("--raw_size", type=int, default=512)
    ap.add_argument("--n_aug", type=int, default=10)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--device", default=None, help="compute device (default: the card)")
    return ap


def _stream(d: Path) -> dict:
    return {"oof": read_table(d / "oof_val.csv"), "test": read_table(d / "pred_test.csv"),
            "summary": json.loads((d / "summary.json").read_text())}


def main(argv=None, log=print) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out = Path(args.dir)
    mm, mil = _stream(out / "mm"), _stream(out / "mil")

    platform = platform_name(dev)
    log(f"[salvage] platform={platform}; regenerating table (seeds 2026/42)")
    table, aug = rehearsal_table(args.n, args.raw_size, args.n_aug, dev)
    del aug
    # the regenerated table must describe the rows the stream artifacts scored
    n_tv = int((table["split"] != "test").sum())
    if len(mm["oof"]) != n_tv:
        raise ValueError(f"{out / 'mm' / 'oof_val.csv'} has {len(mm['oof'])} rows; the rebuilt table has {n_tv} "
                         f"train+val rows (check --n, --n_aug, --raw_size)")

    t0 = time.perf_counter()
    summary = run_stack(table, mm, mil, out / "stack", args.folds, dev)
    best_stream = best_stream_auc(mm, mil)
    rec = {
        "platform": platform,
        "n_cases": args.n,
        "n_rows_augmented": int(len(table)),
        "salvaged": True,
        "streams": {"mm": mm["summary"], "mil": mil["summary"]},
        "stack": {"oof": summary["oof"], "test": summary["test"], "thr": summary["thr"]},
        "best_stream_test_auc": best_stream,
        "stack_beats_streams": bool(summary["test"]["auc"] >= best_stream),
        "stack_s": round(time.perf_counter() - t0, 2),
    }
    save_json(rec, out / "summary.json")
    log(json.dumps(rec["stack"], indent=2, default=float))
    log(f"[salvage] → {out}/summary.json (stack_beats_streams={rec['stack_beats_streams']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
