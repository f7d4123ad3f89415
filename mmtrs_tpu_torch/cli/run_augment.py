"""Class-balancing augmentation CLI on the card (the twin of run_augment.py).

Usage:
  python -m mmtrs_tpu_torch.cli.run_augment --table data.csv --image_dir imgs \\
      --out_dir out [--target_per_class 200] [--strength medium] [--label_col y_majority]
      [--seed 42] [--img_size 512] [--device cuda]

Expands a labelled table to ``target_per_class`` rows a class. Each class's
originals pass through (their images re-encoded as ``<stem>.jpg``); the
missing rows are drawn with replacement from the class by numpy's
``default_rng(seed)``, each child an augmentation of its source at
``img_size`` (Pillow's BILINEAR arithmetic, ``resize_bilinear_u8``, when the
source is another size) with the strength's preset (light → ``simple``,
medium → ``ten``, strong → ``legacy``), written as ``<stem>_bal{k}.jpg``.
Writes ``out_dir/images/`` and ``out_dir/data_balanced.csv`` (CSV only).

Child k of a source is the lineage (seed, ``stem_id(stem)``, k) with variant
k − 1, fed to the preset as f32 as the JAX CLI feeds it. ``stem_id`` is a
CRC-32 of the stem: the JAX CLI's ``hash(stem)`` changes with each process.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch
from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
from mmtrs_tpu_torch.utils.images import load_image, save_jpeg
from mmtrs_tpu_torch.utils.io import read_table, write_table
from mmtrs_tpu_torch.utils.rng import stem_id

STRENGTH_TO_PRESET = {"light": "simple", "medium": "ten", "strong": "legacy"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Class-balancing augmentation on the card")
    p.add_argument("--table", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--target_per_class", type=int, default=200)
    p.add_argument("--strength", default="medium", choices=list(STRENGTH_TO_PRESET))
    p.add_argument("--label_col", default="y_majority")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def augment_one(img, preset: str, seed: int, origin: int, k: int, img_size: int):
    """Child ``k + 1`` of u8 [H, W, 3] ``img`` (variant k), as f32 through
    the preset → [H, W, 3] on the image's device."""
    H, W = img.shape[:2]
    draws = draw_batch(preset, seed, [origin], [k + 1], H, W, aug_idx=[k], img_size=img_size)
    return augment_batch(img[None].float(), draws, preset, aug_idx=np.array([k]), img_size=img_size)[0]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    df = read_table(args.table)
    image_dir = Path(args.image_dir)
    out_dir = Path(args.out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    preset = STRENGTH_TO_PRESET[args.strength]
    size = (args.img_size, args.img_size)

    labels = df[args.label_col]
    missing = np.array([v is None or (isinstance(v, float) and math.isnan(v)) for v in labels.tolist()])
    rng = np.random.default_rng(args.seed)
    rows, names, aug = [], [], []
    for cls in np.unique(np.asarray(labels)[~missing]):
        sub = np.nonzero((np.asarray(labels) == cls) & ~missing)[0]
        need = max(args.target_per_class - len(sub), 0)
        for i in sub:  # originals pass through
            rows.append(i)
            names.append(df["image_name"][i])
            aug.append(0)
            src = image_dir / str(df["image_name"][i])
            if src.exists():
                save_jpeg(out_dir / "images" / f"{src.stem}.jpg", load_image(src, dev))
        picks = rng.choice(len(sub), size=need, replace=True) if need else []
        for k, j in enumerate(picks):  # the balanced expansion
            i = sub[j]
            src = image_dir / str(df["image_name"][i])
            if not src.exists():
                continue
            a = load_image(src, dev)
            if tuple(a.shape[:2]) != size:
                a = resize_bilinear_u8(a, size)
            out = augment_one(a, preset, args.seed, stem_id(src.stem), k, args.img_size)
            name = f"{src.stem}_bal{k + 1}.jpg"
            save_jpeg(out_dir / "images" / name, out)
            rows.append(i)
            names.append(name)
            aug.append(k + 1)

    out = df.take(np.asarray(rows, dtype=np.int64))
    out["image_name"] = np.array(names, dtype=object)
    out["aug_idx"] = np.asarray(aug, dtype=np.int64)
    write_table(out, out_dir / "data_balanced.csv")
    print(f"wrote {len(rows)} rows to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
