"""Preprocessing CLI on the card (the twin of run_pipeline.py).

Usage:
  python -m mmtrs_tpu_torch.cli.run_pipeline --input_dir data/raw/images \\
      --output_dir data/processed/images [--model_path weights/mask_rcnn_molar] \\
      [--no_crop] [--no_rotate] [--batch_size 16] [--log_dir logs] [--device cuda]

Images are decoded on the device (nvJPEG on the card, libjpeg on the CPU;
PNG on the host), resized to each batch's maximum rounded to /8 with
Pillow's BILINEAR arithmetic, padded to ``batch_size`` with the last image,
and pushed through ``preprocess_stream`` (CLAHE → deskew → segment-crop
with centre fallback → 512²); each output is written as ``<stem>.jpg`` at
the config's JPEG quality, encoded on the device, one after another.

Preserves the JAX CLI's contract: the JSON log ``preprocess_<ts>.json``
with the same keys and statuses (``rejected_min_edge``,
``rejected_decode_error``, ``ok``, ``fallback_enhanced``, ``fallback_copy``,
``failed``), the <400 px rejection, and the layered host fallback
(enhanced copy → raw copy) when the pipeline yields nothing, and its
segmenter choice: ``--model_path`` naming a converted Mask R-CNN checkpoint
(``<path>.npz`` with ``<path>.recipe.json``, models/detection's
``load_detector``; the JAX CLI takes the Orbax directory ``<path>`` beside
them) crops with the learned detector on the device, and one that fails to
load prints the JAX CLI's warning and crops with the saliency segmenter.
A CUDA error while the detector moves to the card is not caught.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.config import PreprocessConfig
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.preprocess import preprocess_stream
from mmtrs_tpu_torch.utils.images import iter_batches, list_images, load_image, save_jpeg
from mmtrs_tpu_torch.utils.io import save_json, timestamp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batched preprocessing pipeline on the card")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_path", default=None,
                   help="converted Mask R-CNN checkpoint base (<path>.npz + <path>.recipe.json); "
                        "falls back to the saliency segmenter when absent/unloadable")
    p.add_argument("--no_crop", action="store_true")
    p.add_argument("--no_rotate", action="store_true")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--device", default=None, help="compute device (default: the card)")
    return p


def _fallback(paths: list[Path], out_dir: Path, dev: torch.device, logs: list) -> int:
    """The JAX CLI's layered fallback (reference run_pipeline.py:74-113),
    host arithmetic on each decoded file: a 2–98 % contrast stretch, else
    the decoded image as it is."""
    n_ok = 0
    for p in paths:
        try:
            img = load_image(p, dev).cpu().numpy().astype(np.float32)
            lo, hi = np.percentile(img, [2, 98])
            img = np.clip((img - lo) * 255.0 / max(hi - lo, 1.0), 0, 255)
            save_jpeg(out_dir / f"{p.stem}.jpg", torch.from_numpy(img).to(dev))
            logs.append({"file": p.name, "status": "fallback_enhanced"})
            n_ok += 1
        except Exception:  # the next layer takes over; a file that fails both is logged as failed
            try:
                save_jpeg(out_dir / f"{p.stem}.jpg", load_image(p, dev))
                logs.append({"file": p.name, "status": "fallback_copy"})
                n_ok += 1
            except Exception:
                logs.append({"file": p.name, "status": "failed"})
    return n_ok


def _load_segmenter(path: str, dev: torch.device):
    """The learned segmenter from ``path`` on ``dev``, or None (the saliency
    segmenter) when the checkpoint does not load. It loads on the host
    first, so only a checkpoint's fault is caught, never the card's."""
    from mmtrs_tpu_torch.models.detection import load_detector

    try:
        seg = load_detector(path, device="cpu")
    except Exception as e:  # graceful degradation (pipeline contract)
        print(f"[warn] could not load detector ({e}); using saliency segmenter")
        return None
    seg.to(dev)
    print(f"[info] learned Mask R-CNN segmenter loaded from {path}")
    return seg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    segmenter = None
    if args.model_path and (Path(args.model_path).is_dir() or Path(args.model_path + ".npz").exists()):
        segmenter = _load_segmenter(args.model_path, dev)
    cfg = PreprocessConfig(do_crop=not args.no_crop, do_rotate=not args.no_rotate)
    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = list_images(in_dir)
    if not paths:
        print(f"[warn] no images found in {in_dir}")
        return 1

    logs, n_ok = [], 0
    t0 = time.perf_counter()

    # decode → compute → fetch overlap (preprocess_stream's feeder thread
    # runs this generator one batch ahead). Batches are padded to
    # batch_size with the last image, as the JAX CLI pads them.
    def feed():
        for ok_paths, batch, rejected in iter_batches(paths, args.batch_size, min_edge=cfg.min_edge_px,
                                                      device=dev):
            for r, reason in rejected:
                logs.append({"file": r.name, "status": f"rejected_{reason}"})
            if not len(batch):
                continue
            n_real = len(batch)
            if n_real < args.batch_size:
                batch = torch.cat([batch, batch[-1:].expand(args.batch_size - n_real, -1, -1, -1)])
            yield (ok_paths, n_real), batch

    for (ok_paths, n_real), out, info in preprocess_stream(feed(), cfg, segmenter=segmenter, device=dev):
        out = torch.from_numpy(out).to(dev)  # the encoder reads the device's copy
        for i, p in enumerate(ok_paths[:n_real]):
            dst = out_dir / f"{p.stem}.jpg"
            save_jpeg(dst, out[i], cfg.jpeg_quality)
            logs.append(
                {
                    "file": p.name,
                    "status": "ok",
                    "seg_valid": bool(info["seg_valid"][i]),
                    "deskew_angle": float(info["deskew_angle"][i]),
                    "output": str(dst),
                }
            )
            n_ok += 1
    dt = time.perf_counter() - t0

    if n_ok == 0:
        print("[warn] pipeline produced nothing — falling back to enhanced copies")
        n_ok = _fallback(paths, out_dir, dev, logs)

    log_path = Path(args.log_dir) / f"preprocess_{timestamp()}.json"
    save_json(
        {
            "processed": n_ok,
            "total": len(paths),
            "seconds": dt,
            "imgs_per_sec": n_ok / dt if dt > 0 else 0.0,
            "config": {"do_crop": cfg.do_crop, "do_rotate": cfg.do_rotate},
            "entries": logs,
        },
        log_path,
    )
    print(f"Processed {n_ok}/{len(paths)} images in {dt:.2f}s "
          f"({n_ok / dt if dt > 0 else 0:.1f} imgs/s) on {dev} — log: {log_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
