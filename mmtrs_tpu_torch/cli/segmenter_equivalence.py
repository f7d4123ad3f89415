"""Saliency default vs learned-detector box contract (the twin of
scripts/segmenter_equivalence.py), on the device.

No COCO checkpoint is in the repository, so the learned path cannot be run
with real weights. What can be measured is the part of the ``--model_path``
contract that does not depend on the detector's quality: given the tooth's
true mask, the learned path's crop box is ``mask_bbox(mask > 0.5)``
(models/detection/segmenter.py, the reference's crop from the thresholded
mask, segment.py:57-66). Randomised synthetic scenes with known tooth masks
(the JAX script's, from the same numpy generator) give the IoU distribution
between the SaliencySegmenter box and that oracle box, the IoU of the final
crop windows (margin 15 + pad-to-square), the tooth's coverage by the crop,
and the metal gate's rejections on gray-restoration scenes.

Usage:
  python -m mmtrs_tpu_torch.cli.segmenter_equivalence \\
      [--out reports/segmenter_equivalence_torch.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device

SIZE = 512
N_SCENES = 300
N_METAL = 40
BATCH = 25
SEED = 2026


def make_scene(rng: np.random.Generator, size: int = SIZE):
    """Randomized tooth photo: gum background, one rotated-ellipse tooth
    (position/size/color/occlusal-spot jittered), optional second tooth and
    bright distractor blob. Returns (img f32, primary tooth mask bool)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.empty((size, size, 3), np.float32)
    bg = np.array([60, 35, 40], np.float32) + rng.normal(0, 8, 3)
    img[...] = bg
    img += rng.normal(0, rng.uniform(3, 8), img.shape)

    def ellipse(cx, cy, a, b, th):
        dx, dy = xs - cx, ys - cy
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        return (u / a) ** 2 + (v / b) ** 2 <= 1.0

    # optional second, smaller tooth (the reference picks ONE mask)
    if rng.random() < 0.3:
        m2 = ellipse(
            rng.uniform(0.15, 0.85) * size, rng.uniform(0.15, 0.85) * size,
            rng.uniform(0.08, 0.14) * size, rng.uniform(0.06, 0.10) * size,
            rng.uniform(-0.8, 0.8),
        )
        img[m2] = np.array([200, 185, 150], np.float32) + rng.normal(0, 8, (int(m2.sum()), 3))
    # optional specular/distractor blob (small, bright, low-saturation)
    if rng.random() < 0.3:
        md = ellipse(
            rng.uniform(0.1, 0.9) * size, rng.uniform(0.1, 0.9) * size,
            rng.uniform(0.02, 0.05) * size, rng.uniform(0.02, 0.05) * size,
            0.0,
        )
        img[md] = 235.0 + rng.normal(0, 5, (int(md.sum()), 3))

    # primary tooth
    cx = rng.uniform(0.25, 0.75) * size
    cy = rng.uniform(0.25, 0.75) * size
    a = rng.uniform(0.16, 0.32) * size
    b = rng.uniform(0.12, 0.26) * size
    th = rng.uniform(-0.7, 0.7)
    mask = ellipse(cx, cy, a, b, th)
    tooth = np.array([rng.uniform(210, 240), rng.uniform(190, 220), rng.uniform(140, 175)], np.float32)
    img[mask] = tooth + rng.normal(0, 8, (int(mask.sum()), 3))
    if rng.random() < 0.5:  # occlusal spot
        sp = ellipse(cx + rng.normal(0, a * 0.2), cy + rng.normal(0, b * 0.2), a * 0.3, b * 0.3, th)
        img[sp & mask] *= rng.uniform(0.4, 0.7)
    return np.clip(img, 0, 255).astype(np.float32), mask


def make_metal_scene(rng: np.random.Generator, size: int = SIZE):
    """Gray (low-saturation) restoration filling the ONLY tooth in frame:
    the metal gate (mean sat < 40) must reject it on both paths."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.empty((size, size, 3), np.float32)
    img[...] = np.array([60, 35, 40], np.float32) + rng.normal(0, 8, 3)
    img += rng.normal(0, rng.uniform(3, 8), img.shape)
    cx = rng.uniform(0.3, 0.7) * size
    cy = rng.uniform(0.3, 0.7) * size
    a = rng.uniform(0.16, 0.3) * size
    b = rng.uniform(0.12, 0.24) * size
    th = rng.uniform(-0.7, 0.7)
    dx, dy = xs - cx, ys - cy
    u = dx * np.cos(th) + dy * np.sin(th)
    v = -dx * np.sin(th) + dy * np.cos(th)
    mask = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    gray = rng.uniform(150, 210)
    img[mask] = gray + rng.normal(0, 4, (int(mask.sum()), 3))
    return np.clip(img, 0, 255).astype(np.float32), mask


def iou(a, b) -> float:
    ay0, ax0, ay1, ax1 = a
    by0, bx0, by1, bx1 = b
    yi = max(0.0, min(ay1, by1) - max(ay0, by0))
    xi = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    inter = yi * xi
    ua = (ay1 - ay0) * (ax1 - ax0) + (by1 - by0) * (bx1 - bx0) - inter
    return float(inter / ua) if ua > 0 else 0.0


def crop_window(box, H=SIZE, W=SIZE, margin=15.0):
    """The final crop rect both paths feed to crop_box_resize: box + margin,
    clamped, expanded to a square."""
    y0 = max(0.0, box[0] - margin)
    x0 = max(0.0, box[1] - margin)
    y1 = min(float(H), box[2] + margin)
    x1 = min(float(W), box[3] + margin)
    h, w = y1 - y0, x1 - x0
    d = max(h, w)
    cy, cx = (y0 + y1) / 2.0, (x0 + x1) / 2.0
    return (cy - d / 2, cx - d / 2, cy + d / 2, cx + d / 2)


def report(n_scenes: int = N_SCENES, n_metal: int = N_METAL, size: int = SIZE,
           device: str | torch.device | None = None) -> dict:
    """The JAX script's report, the saliency boxes computed on ``device``."""
    from mmtrs_tpu_torch.models.detection.ops import mask_bbox
    from mmtrs_tpu_torch.models.segmenter import SaliencySegmenter

    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    seg = SaliencySegmenter()
    ious_box, ious_crop, coverage, sal_valid = [], [], [], []
    scenes = [make_scene(rng, size) for _ in range(n_scenes)]
    for i in range(0, n_scenes, BATCH):
        chunk = scenes[i:i + BATCH]
        boxes, valid = seg.propose_boxes(torch.from_numpy(np.stack([s[0] for s in chunk])).to(dev))
        oracle = mask_bbox(torch.from_numpy(np.stack([s[1] for s in chunk])).to(dev)).cpu().numpy()
        for (_, mask), sb, v, ob in zip(chunk, boxes.cpu().numpy(), valid.cpu().numpy(), oracle):
            sal_valid.append(bool(v))
            if not v:
                continue
            ious_box.append(iou(sb, ob))
            ious_crop.append(iou(crop_window(sb, size, size), crop_window(ob, size, size)))
            cy0, cx0, cy1, cx1 = crop_window(sb, size, size)
            ys_m, xs_m = np.nonzero(mask)
            inside = (ys_m >= cy0) & (ys_m < cy1) & (xs_m >= cx0) & (xs_m < cx1)
            coverage.append(float(inside.mean()))

    metal_scenes = [make_metal_scene(rng, size) for _ in range(n_metal)]
    _, valid = seg.propose_boxes(torch.from_numpy(np.stack([s[0] for s in metal_scenes])).to(dev))
    metal_rejected = int((~valid.cpu().numpy()).sum())

    ious_box = np.asarray(ious_box)
    ious_crop = np.asarray(ious_crop)
    q = lambda a, p: float(np.percentile(a, p)) if len(a) else None
    return {
        "n_scenes": n_scenes,
        "img_px": size,
        "saliency_valid_rate": round(float(np.mean(sal_valid)), 4),
        "box_iou": {
            "mean": round(float(ious_box.mean()), 4),
            "median": round(q(ious_box, 50), 4),
            "p10": round(q(ious_box, 10), 4),
            "frac_ge_0.5": round(float((ious_box >= 0.5).mean()), 4),
            "frac_ge_0.7": round(float((ious_box >= 0.7).mean()), 4),
        },
        "crop_window_iou": {
            "mean": round(float(ious_crop.mean()), 4),
            "median": round(q(ious_crop, 50), 4),
            "p10": round(q(ious_crop, 10), 4),
            "frac_ge_0.7": round(float((ious_crop >= 0.7).mean()), 4),
            "frac_ge_0.9": round(float((ious_crop >= 0.9).mean()), 4),
        },
        "tooth_coverage_by_crop": {
            "mean": round(float(np.mean(coverage)), 4),
            "p10": round(q(np.asarray(coverage), 10), 4),
            "frac_full": round(float((np.asarray(coverage) >= 0.999).mean()), 4),
        },
        "metal_gate": {
            "n_scenes": n_metal,
            "rejected_by_saliency_path": metal_rejected,
            "note": "the saturation<40 metal gate is shared code on both "
                    "paths (segment.py:37-39 parity)",
        },
        "method": "oracle learned-path box = mask_bbox(true mask), i.e. the "
                  "box a perfect detector hands the identical downstream "
                  "crop geometry (margin 15 + pad-to-square). Measures the "
                  "saliency default against the learned contract without "
                  "COCO weights (none in the repository).",
        "device": str(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="reports/segmenter_equivalence_torch.json")
    ap.add_argument("--device", default=None, help="compute device (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rep = report(N_SCENES, N_METAL, SIZE, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=2))
    print(json.dumps(rep, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
