"""Simple folder augmenter on the card (the twin of run_augment_simple.py).

Usage:
  python -m mmtrs_tpu_torch.cli.run_augment_simple --input_dir imgs --output_dir out \\
      [--n 10] [--seed 42] [--img_size 512] [--copy_originals] [--device cuda]

Every image of ``input_dir`` (JPEG, PNG or uncompressed BMP), resized to
``img_size`` square with Pillow's BILINEAR arithmetic (``resize_bilinear_u8``)
when it is another size, gets N children ``<stem>_<k>.jpg`` through the
``simple`` preset, child k the lineage (seed, ``(stem_id(stem) ^ seed) mod
2³¹``, k) with variant k − 1, fed as f32 as the JAX CLI feeds it.
``stem_id`` is a CRC-32 of the stem, where the JAX CLI's ``hash(stem)``
changes with each process.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch
from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
from mmtrs_tpu_torch.utils.images import list_images, load_image, save_jpeg
from mmtrs_tpu_torch.utils.rng import stem_id


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="N augmented children per image on the card")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--copy_originals", action="store_true")
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    size = (args.img_size, args.img_size)
    n_out = 0
    for src in list_images(args.input_dir):
        a = load_image(src, dev)
        if tuple(a.shape[:2]) != size:
            a = resize_bilinear_u8(a, size)
        if args.copy_originals:
            save_jpeg(out_dir / f"{src.stem}.jpg", a)
        origin = (stem_id(src.stem) ^ args.seed) % (2**31)
        variants = np.arange(args.n)
        draws = draw_batch("simple", args.seed, [origin] * args.n, variants + 1, args.img_size, args.img_size,
                           aug_idx=variants)
        out = augment_batch(a[None].float().expand(args.n, -1, -1, -1).contiguous(), draws, "simple",
                            aug_idx=variants)
        for k in range(args.n):
            save_jpeg(out_dir / f"{src.stem}_{k + 1}.jpg", out[k])
            n_out += 1
    print(f"wrote {n_out} augmented images to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
