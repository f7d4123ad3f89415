"""Record-keeping augmentation CLI on the card (the twin of
run_augment_records.py).

Usage:
  python -m mmtrs_tpu_torch.cli.run_augment_records --table data/data_processed.csv \\
      --image_dir data/processed/images --out_dir data/augmented \\
      [--n_aug 10] [--preset ten] [--seed 42] [--device cuda]

Reads the metadata table (CSV: the port reads no XLSX), decodes each row's
image (``<image_dir>/<image_name>``, else ``<stem>.jpg``; rows whose file is
missing are dropped), resizes any image that is not ``img_size`` square with
Pillow's BILINEAR arithmetic (``resize_bilinear_u8``), builds N augmented
children per original in device batches (``data.records.build_augmented_table``)
and writes every row's image as ``out_dir/images/<image_name>`` (JPEG,
quality 95) and the lineage table as ``out_dir/data_dl_augmented.csv``, the
CSV alone (the JAX CLI also writes an .xlsx where openpyxl exists).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from mmtrs_tpu_torch.data.records import build_augmented_table
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
from mmtrs_tpu_torch.utils.images import load_image, save_jpeg
from mmtrs_tpu_torch.utils.io import read_table, write_table


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Record-keeping augmentation on the card")
    p.add_argument("--table", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_aug", type=int, default=10)
    p.add_argument("--preset", default="ten", choices=["legacy", "ten", "simple", "none"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--test_frac", type=float, default=0.2)
    p.add_argument("--val_frac", type=float, default=0.0)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    table = read_table(args.table)
    image_dir = Path(args.image_dir)
    out_dir = Path(args.out_dir)
    img_out = out_dir / "images"
    img_out.mkdir(parents=True, exist_ok=True)

    imgs, keep = [], []
    for i, name in enumerate(table["image_name"]):
        p = image_dir / str(name)
        if not p.exists():
            alt = image_dir / (Path(str(name)).stem + ".jpg")
            p = alt if alt.exists() else p
        if not p.exists():
            continue
        a = load_image(p, dev)
        if a.shape[0] != args.img_size or a.shape[1] != args.img_size:
            a = resize_bilinear_u8(a, (args.img_size, args.img_size))
        imgs.append(a)
        keep.append(i)
    table = table.take(keep)
    if not len(table):
        print("[error] no images matched the table")
        return 1

    out, _ = build_augmented_table(
        table,
        torch.stack(imgs),
        n_aug=args.n_aug,
        preset=args.preset,
        seed=args.seed,
        test_frac=args.test_frac,
        val_frac=args.val_frac,
        batch_size=args.batch_size,
        image_writer=lambda name, img: save_jpeg(img_out / name, img),
        device=dev,
    )
    written = write_table(out, out_dir / "data_dl_augmented.csv")
    print(f"wrote {len(out)} rows ({args.n_aug}× aug, preset={args.preset}) → {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
