"""The batched preprocessing pipeline (port of mmtrs_tpu/preprocess.py:
``preprocess_batch``, ``preprocess_augment_batch``, ``min_edge_ok``,
``preprocess_numpy``, ``pipelined_run``, ``preprocess_stream``).

Order and toggles as src/preprocessing/pipeline.py ``process_file``
(:84-116): CLAHE on the LAB L channel → optional deskew → segmentation crop
(centre-crop fallback) → ``out_size``² output; the min-edge gate (<400 px)
happens at decode time on the host.

CLAHE takes the JAX package's TPU routes, chosen by its own predicate
(``supports``, copied in ops/kernels/clahe_lab.py): the fused LAB route
(kernels K1/K2, i8 chroma) where the fused kernels take the shape, else the
L-plane route (float LAB, kernels K8/K9 on the u8 L plane, float chroma).
Then u8 deskew through K3 → saliency boxes → crop-resize, or, with
augmentation, the crop∘augment warp (K4) and the ``legacy`` photometrics
(K5, K1/K2, K6). On a CPU tensor each kernel wrapper runs its plain PyTorch
version instead. The host entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mmtrs_tpu_torch.config import PreprocessConfig
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.models.segmenter import SaliencySegmenter
from mmtrs_tpu_torch.ops.augment import LegacyDraws, legacy_photometrics
from mmtrs_tpu_torch.ops.clahe import quantize_u8
from mmtrs_tpu_torch.ops.color import lab_to_rgb, rgb_to_lab
from mmtrs_tpu_torch.ops.deskew import deskew_batch
from mmtrs_tpu_torch.ops.kernels.clahe import clahe_l
from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused, supports
from mmtrs_tpu_torch.ops.resize import crop_box_resize, crop_warp_fused


def _clahe_lab_stage(imgs: torch.Tensor, clip: float, tiles: tuple[int, int]) -> torch.Tensor:
    """CLAHE on the LAB L channel, u8 out (normalise.py:10-16), on the route
    the JAX package's ``_clahe_lab_stage`` takes on a TPU
    (mmtrs_tpu/preprocess.py:47-68): the fused kernels K1 → K2 where
    ``supports`` holds; elsewhere float LAB (not rounded), CLAHE on the L
    plane through K8 → K9 with a u8 L′ store, L′ joined to the float a, b,
    back to RGB and stored u8 round-half-up."""
    if supports(imgs.shape[1], imgs.shape[2], tiles):
        return clahe_lab_fused(imgs, clip=clip, tiles=tiles)
    lab = rgb_to_lab(imgs.float())
    l2 = clahe_l(lab[..., 0], clip=clip, tiles=tiles, out_dtype=torch.uint8)
    return quantize_u8(lab_to_rgb(torch.cat([l2.float()[..., None], lab[..., 1:]], dim=-1)))


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
    # LAB2BGR on u8 returns u8), on the TPU's route for this shape
    x = _clahe_lab_stage(imgs, clahe_clip, tiles)

    # 2. optional deskew (normalise.py:19-57), written back into the CLAHE
    # stage's fresh output
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
    x = _clahe_lab_stage(imgs, clahe_clip, tiles)
    if do_rotate:  # in place: x is the CLAHE stage's fresh output
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


def preprocess_u8(x: torch.Tensor, cfg: PreprocessConfig, segmenter=None):
    """``preprocess_batch`` of a batch already on its device, with the
    config's settings, cast to u8 there: (u8 [B, out, out, 3], info dict of
    tensors)."""
    out, info = preprocess_batch(
        x,
        out_size=cfg.output_size,
        do_crop=cfg.do_crop,
        do_rotate=cfg.do_rotate,
        clahe_clip=cfg.clahe_clip,
        tiles=cfg.clahe_tiles,
        crop_margin=float(cfg.crop_margin_px),
        segmenter=segmenter,
    )
    return quantize_u8(out), info


def preprocess_numpy(
    imgs: np.ndarray,
    cfg: PreprocessConfig = PreprocessConfig(),
    segmenter=None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, dict]:
    """Host API with a config object: numpy [B, H, W, 3] → **uint8** numpy
    [B, out, out, 3] (cast on the device before the copy back) and an info
    dict of numpy arrays. ``device`` None is the card."""
    x = torch.from_numpy(np.ascontiguousarray(imgs)).to(resolve_device(device))
    out_u8, info = preprocess_u8(x, cfg, segmenter)
    return out_u8.cpu().numpy(), {k: v.cpu().numpy() for k, v in info.items()}


# ---------------------------------------------------------------------------
# Pipelined host↔device overlap
# ---------------------------------------------------------------------------


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree.cpu().numpy()


def pipelined_run(device_fn, host_batches, device: str | torch.device | None = None,
                  depth: int = 2):
    """Run ``device_fn`` over a stream of host batches with 3-stage overlap
    (mmtrs_tpu/preprocess.py:238-290):

    - a feeder thread takes the next item (decode / IO) one batch ahead, and
      on the card pins it so its copy to the device does not block;
    - the calling thread copies each batch to ``device`` and launches
      ``device_fn`` on it (the launches are asynchronous on the card);
    - a fetch thread copies batch N−1's results back while batch N runs.

    ``host_batches``: iterator of (meta, np.ndarray or tensor); a batch
    the feeder made on ``device`` already (the CLI decodes on the card) is
    used where it lies. ``device_fn``: tensor on ``device`` → tensor, or a
    dict / tuple / list of tensors. Yields (meta, the same structure of
    numpy arrays) in input order; ``depth`` bounds the batches in flight.
    ``device`` None is the card."""
    dev = resolve_device(device)
    it = iter(host_batches)

    def next_item():
        item = next(it, None)
        if item is None:
            return None
        meta, host = item
        x = host if isinstance(host, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(host))
        return meta, (x.pin_memory() if dev.type == "cuda" and x.device.type == "cpu" else x)

    with ThreadPoolExecutor(1) as feeder, ThreadPoolExecutor(1) as fetcher:
        pending: list = []
        nxt = feeder.submit(next_item)
        while True:
            item = nxt.result()
            if item is None:
                break
            nxt = feeder.submit(next_item)  # take N+1 while N computes
            meta, host = item
            out = device_fn(host.to(dev, non_blocking=True))
            pending.append((meta, fetcher.submit(_to_host, out)))
            if len(pending) >= depth:
                m, f = pending.pop(0)
                yield m, f.result()
        for m, f in pending:
            yield m, f.result()


def preprocess_stream(
    host_batches,
    cfg: PreprocessConfig = PreprocessConfig(),
    segmenter=None,
    device: str | torch.device | None = None,
):
    """Pipelined preprocessing over a stream of (meta, uint8 [B, H, W, 3])
    batches, host numpy or tensors (mmtrs_tpu/preprocess.py:293-321): the
    u8 cast happens on the device before the copy back. Yields (meta,
    out_u8 [B, out, out, 3], info dict of numpy arrays) in input order.
    ``device`` None is the card."""
    fn = lambda x: preprocess_u8(x, cfg, segmenter)
    for meta, (out_u8, info) in pipelined_run(fn, host_batches, device=device):
        yield meta, out_u8, info
