"""Vision evaluation CLI on the card (the twin of scripts/eval_vision.py).

Usage:
  python -m mmtrs_tpu_torch.cli.eval_vision --ckpt weights/vision_hard_best \\
      --data data_dl_augmented.csv --image_dir processed/ [--split test]
      [--no_tta] [--tune_on val] [--outdir results/] [--device cuda]

Reads a hard or soft vision checkpoint (``<ckpt>.npz`` and its recipe, as
``cli.run_train_images`` and scripts/export_npz_checkpoints.py write them)
into an f32 model, predicts the rows of ``--split`` whose image is found
(``load_vision_dataset``: Pillow's BILINEAR arithmetic to the recipe's
size) with the hflip TTA (the mean of the two views' probabilities, as
``VisionTrainer.predict_proba`` takes it) unless ``--no_tta``, takes the
recipe's threshold or one tuned for F1 on ``--tune_on``, and prints the
report; with ``--outdir`` it writes
``vision_<task>_<split>_predictions.csv`` and ``metrics_vision_<task>.json``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a vision checkpoint on the card")
    p.add_argument("--ckpt", required=True, help="checkpoint path prefix")
    p.add_argument("--data", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--no_tta", action="store_true")
    p.add_argument("--tune_on", default=None, help="split to tune the F1 threshold on (e.g. val)")
    p.add_argument("--outdir", default=None)
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mmtrs_tpu_torch.cli.run_train_images import load_vision_dataset
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.metrics.binary import binary_report
    from mmtrs_tpu_torch.models.convert import vision_from_flax
    from mmtrs_tpu_torch.train.vision import VisionTrainer
    from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint
    from mmtrs_tpu_torch.utils.io import read_table, save_json
    from mmtrs_tpu_torch.utils.table import Table, to_csv

    dev = resolve_device(args.device)
    tree, recipe = load_npz_checkpoint(Path(args.ckpt))
    if recipe is None:
        print("[error] checkpoint has no recipe sidecar")
        return 1
    cfg = VisionTrainConfig(model_name=recipe["model_name"], img_size=int(recipe["img_size"]),
                            task=recipe.get("task", "hard"), bf16=False)
    trainer = VisionTrainer(cfg, device=dev, init=vision_from_flax(tree, cfg.model_name))

    df = read_table(args.data)
    split = np.array([str(s).lower() for s in df["split"].tolist()], dtype=object)
    df["split"] = split
    data, sub = load_vision_dataset(df.take(split == args.split), args.image_dir, cfg.img_size, dev)
    thr = float(recipe.get("thr", 0.5))
    if args.tune_on:
        val_data, _ = load_vision_dataset(df.take(split == args.tune_on), args.image_dir, cfg.img_size, dev)
        thr = trainer.tune_threshold_f1(None, val_data)

    probs = trainer.predict_proba(None, data, tta=not args.no_tta)
    rep = binary_report(data.y, probs, thr)
    print({k: round(rep[k], 4) for k in ("auc", "acc", "prec", "rec", "f1")}, f"thr={thr:.3f}")
    if args.outdir:
        outdir = Path(args.outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        to_csv(Table({"image_name": sub["image_name"], "y": data.y, "prob": probs}),
               outdir / f"vision_{cfg.task}_{args.split}_predictions.csv")
        save_json({k: rep[k] for k in ("auc", "acc", "prec", "rec", "f1", "brier")},
                  outdir / f"metrics_vision_{cfg.task}.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
