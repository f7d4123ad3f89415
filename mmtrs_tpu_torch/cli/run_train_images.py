"""Vision trainer dispatcher on the card (the twin of run_train_images.py).

Usage:
  python -m mmtrs_tpu_torch.cli.run_train_images --task hard --model efficientnet_b3 \\
      --img_size 512 --data data/dl_augmented.csv --image_dir data/processed/images \\
      --epochs 30 --batch_size 16 --out weights/vision_hard [--aug legacy] [--device cuda]

The JAX CLI's flags, plus ``--device`` (default: the card). Reads the
metadata table (CSV: the port reads no XLSX) and the image of each
non-test row (``<image_dir>/<image_name>``; rows whose file is missing are
dropped), decoded on the device and resized with Pillow's BILINEAR
arithmetic (``resize_bilinear_u8``) where it is not ``img_size`` square;
splits the rows group-exclusively on ``origin_id`` into train and val
(``grouped_train_test_split``); trains ``VisionTrainer`` (hard: 2-class CE;
soft: BCE on p_indirect weighted by ``weight``) with the ``--aug`` preset on
train batches; tunes the F1 threshold on val; and writes
``<out>/vision_{task}_best.npz`` with its recipe (model_name, img_size,
task, thr), which ``fusion.streams`` reads, and ``<out>/{task}_summary.json``
(history and thr).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a vision stream on the card")
    p.add_argument("--task", choices=["hard", "soft"], default="hard")
    p.add_argument("--model", default=None, help="default: efficientnet_b3 (hard) / convnext_tiny (soft)")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--data", required=True, help="metadata CSV")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val_frac", type=float, default=0.15)
    p.add_argument("--aug", default="none", choices=["none", "legacy", "ten", "simple"])
    p.add_argument("--out", default="weights/vision")
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def load_vision_dataset(table, image_dir, img_size: int, device: torch.device):
    """(VisionData with the images u8 on ``device``, the Table of the rows
    whose image was found)."""
    from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
    from mmtrs_tpu_torch.train.vision import VisionData
    from mmtrs_tpu_torch.utils.images import load_image

    imgs, keep = [], []
    for i, name in enumerate(table["image_name"]):
        p = Path(image_dir) / str(name)
        if not p.exists():
            continue
        a = load_image(p, device)
        if a.shape[0] != img_size or a.shape[1] != img_size:
            a = resize_bilinear_u8(a, (img_size, img_size))
        imgs.append(a)
        keep.append(i)
    sub = table.take(keep)
    col = lambda name, default: np.asarray(sub[name]) if name in sub else default
    return VisionData(
        images=torch.stack(imgs),
        y=np.asarray(sub["y_majority"]).astype(int),
        p=col("p_indirect", np.asarray(sub["y_majority"])).astype(float),
        w=col("weight", np.ones(len(sub), np.float32)).astype(float),
        origin_id=col("origin_id", np.arange(len(sub))),
        aug_idx=col("aug_idx", None),
    ), sub


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.data.splits import grouped_train_test_split
    from mmtrs_tpu_torch.device import resolve_device
    from mmtrs_tpu_torch.models.convert import vision_to_flax
    from mmtrs_tpu_torch.train.vision import VisionData, VisionTrainer
    from mmtrs_tpu_torch.utils.checkpoint import save_npz_checkpoint
    from mmtrs_tpu_torch.utils.io import read_table, save_json

    dev = resolve_device(args.device)
    model = args.model or ("efficientnet_b3" if args.task == "hard" else "convnext_tiny")
    table = read_table(args.data)
    split = (np.char.lower(np.asarray(table["split"]).astype(str)) if "split" in table
             else np.full(len(table), "train"))
    data_all, sub = load_vision_dataset(table.take(np.nonzero(split != "test")[0]), args.image_dir,
                                        args.img_size, dev)
    # grouped val split on origin_id (_split_train_val, train_hard.py:20-34)
    tr, va = grouped_train_test_split(sub, args.val_frac, args.seed)

    def slice_data(d, idx):
        return VisionData(images=d.images[torch.as_tensor(idx, device=dev)], y=d.y[idx], p=d.p[idx], w=d.w[idx],
                          origin_id=d.origin_id[idx], aug_idx=None if d.aug_idx is None else d.aug_idx[idx])

    train, val = slice_data(data_all, tr), slice_data(data_all, va)
    cfg = VisionTrainConfig(model_name=model, img_size=args.img_size, task=args.task, epochs=args.epochs,
                            batch_size=args.batch_size, lr=args.lr, seed=args.seed)
    trainer = VisionTrainer(cfg, aug_preset=args.aug, device=dev)
    state, history = trainer.fit(train, val)
    thr = trainer.tune_threshold_f1(state, val)

    out = Path(args.out)
    save_npz_checkpoint(
        out / f"vision_{args.task}_best",
        vision_to_flax({k: v.cpu() for k, v in state["model"].items()}),
        recipe={"model_name": model, "img_size": args.img_size, "task": args.task, "thr": thr},
    )
    save_json({"history": history, "thr": thr}, out / f"{args.task}_summary.json")
    print(f"saved {out}/vision_{args.task}_best (thr={thr:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
