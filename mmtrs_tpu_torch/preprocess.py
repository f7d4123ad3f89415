"""The batched preprocessing pipeline (port of mmtrs_tpu/preprocess.py:
``preprocess_batch``, ``preprocess_augment_batch``, ``min_edge_ok``,
``preprocess_numpy``).

Order and toggles as src/preprocessing/pipeline.py ``process_file``
(:84-116): CLAHE on the LAB L channel → optional deskew → segmentation crop
(centre-crop fallback) → ``out_size``² output; the min-edge gate (<400 px)
happens at decode time on the host.

One route on every device: u8 RGB → CUDA kernels K1/K2 (CLAHE-LAB) → u8
deskew through K3 → saliency boxes → crop-resize, or, with augmentation,
the crop∘augment warp (K4) and the ``legacy`` photometrics (K5, K1/K2, K6).
On a CPU tensor each kernel wrapper runs its plain PyTorch version instead.
"""

from __future__ import annotations

import numpy as np
import torch

from mmtrs_tpu_torch.config import PreprocessConfig
from mmtrs_tpu_torch.models.segmenter import SaliencySegmenter
from mmtrs_tpu_torch.ops.augment import LegacyDraws, legacy_photometrics
from mmtrs_tpu_torch.ops.clahe import quantize_u8
from mmtrs_tpu_torch.ops.deskew import deskew_batch
from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused
from mmtrs_tpu_torch.ops.resize import crop_box_resize, crop_warp_fused


@torch.no_grad()
def preprocess_batch(
    imgs: torch.Tensor,
    out_size: int = 512,
    do_crop: bool = True,
    do_rotate: bool = True,
    clahe_clip: float = 3.0,
    tiles: tuple[int, int] = (8, 8),
    crop_margin: float = 15.0,
    segmenter=None,
):
    """imgs: [B, H, W, 3] uint8/float 0..255 on the compute device →
    (out [B, out_size, out_size, 3] f32, info dict with seg_valid /
    deskew_angle / boxes)."""
    # 1. CLAHE on the LAB L channel (normalise.py:10-16), u8 out (cv2's
    # LAB2BGR on u8 returns u8): the K1 → K2 route, which computes what the
    # TPU's fused Pallas route does
    x = clahe_lab_fused(imgs, clip=clahe_clip, tiles=tiles)

    # 2. optional deskew (normalise.py:19-57)
    if do_rotate:
        x, angle = deskew_batch(x)
    else:
        angle = torch.zeros(x.shape[0], device=x.device)

    # 3. segmentation crop with centre fallback (pipeline.py:84-116)
    if do_crop:
        seg = segmenter if segmenter is not None else SaliencySegmenter()
        boxes, valid = seg.propose_boxes(x)
    else:
        B, H, W, _ = x.shape
        side = float(min(H, W))
        cy0, cx0 = (H - side) / 2.0, (W - side) / 2.0
        boxes = torch.tensor(
            [[cy0, cx0, cy0 + side, cx0 + side]], device=x.device
        ).repeat(B, 1)
        valid = torch.zeros(B, dtype=torch.bool, device=x.device)
    out = crop_box_resize(x, boxes, out_size, margin=crop_margin)
    return out, {"seg_valid": valid, "deskew_angle": angle, "boxes": boxes}


@torch.no_grad()
def preprocess_augment_batch(
    imgs: torch.Tensor,
    draws: LegacyDraws,
    out_size: int = 512,
    do_rotate: bool = True,
    clahe_clip: float = 3.0,
    tiles: tuple[int, int] = (8, 8),
    crop_margin: float = 15.0,
    segmenter=None,
):
    """The production chain: CLAHE → deskew → segment-crop → the ``legacy``
    augmentation, with the crop resample and the augmentation's geometric
    warp composed into ONE affine warp (ops/resize.crop_warp_fused, kernel
    K4). ``draws`` (ops/augment.draw_legacy, for out_size² frames) holds the
    augmentation's randomness. Needs square inputs at ``out_size``.

    imgs: u8 [B, S, S, 3] on the compute device → (u8 [B, S, S, 3], info dict
    with seg_valid / deskew_angle / boxes)."""
    B, H, W, _ = imgs.shape
    if H != out_size or W != out_size or draws.batch != B:
        raise ValueError(
            f"preprocess_augment_batch: needs [B, {out_size}, {out_size}, 3] images and "
            f"draws for B images, got {tuple(imgs.shape)} and {draws.batch} draws"
        )
    x = clahe_lab_fused(imgs, clip=clahe_clip, tiles=tiles)
    if do_rotate:
        x, angle = deskew_batch(x)
    else:
        angle = torch.zeros(B, device=x.device)
    seg = segmenter if segmenter is not None else SaliencySegmenter()
    boxes, valid = seg.propose_boxes(x)
    out = crop_warp_fused(x, boxes, draws.mats, out_size, margin=crop_margin)
    out = legacy_photometrics(out, draws, out_size)
    return out, {"seg_valid": valid, "deskew_angle": angle, "boxes": boxes}


def min_edge_ok(shape_hw: tuple[int, int], cfg: PreprocessConfig = PreprocessConfig()) -> bool:
    """Host-side decode gate (pipeline.py:80): reject min edge < 400px."""
    return min(shape_hw) >= cfg.min_edge_px


def preprocess_numpy(
    imgs: np.ndarray,
    cfg: PreprocessConfig = PreprocessConfig(),
    segmenter=None,
    device: str | torch.device = "cpu",
) -> tuple[np.ndarray, dict]:
    """Host API with a config object: numpy [B, H, W, 3] → **uint8** numpy
    [B, out, out, 3] (cast on the device before the copy back) and an info
    dict of numpy arrays."""
    out, info = preprocess_batch(
        torch.from_numpy(np.ascontiguousarray(imgs)).to(device),
        out_size=cfg.output_size,
        do_crop=cfg.do_crop,
        do_rotate=cfg.do_rotate,
        clahe_clip=cfg.clahe_clip,
        tiles=cfg.clahe_tiles,
        crop_margin=float(cfg.crop_margin_px),
        segmenter=segmenter,
    )
    out_u8 = quantize_u8(out)
    return out_u8.cpu().numpy(), {k: v.cpu().numpy() for k, v in info.items()}
