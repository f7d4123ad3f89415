"""Host-side image IO: decode/encode and batched directory iteration (the
port's twin of mmtrs_tpu/utils/images.py), on the port's codec
(``utils/codec.py``) instead of Pillow.

Images are u8 [H, W, 3] tensors on the device the caller names (None: the
card). On the CPU, JPEG files are decoded on a pool of host threads as
Pillow decodes them (libjpeg, or the port's own decoder for lossless and
arithmetic-coded frames); on the card each file is decoded by nvJPEG into
device memory, or by the own decoder on the host and moved there.

``iter_batches`` follows the JAX package's Pillow route for every input:
each image is resized with Pillow's BILINEAR filter (``resize_bilinear_u8``,
the same integer arithmetic, on the images' device) to the batch maximum
rounded up to /8, or to ``target_hw``. The JAX package's native route
(``target_hw`` given and every file a JPEG, native/loader.cpp) resizes with
half-pixel centres instead, which is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
from mmtrs_tpu_torch.utils.codec import decode_image, decode_paths, encode_jpeg, is_jpeg

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_image(path: str | Path, device: str | torch.device | None = None) -> torch.Tensor:
    """Decode to RGB u8 [H, W, 3] on ``device`` (None: the card)."""
    return decode_image(Path(path), device)


def save_jpeg(path: str | Path, img, quality: int = 95) -> Path:
    """JPEG writer (pipeline.py:49-67 convention): ``img`` [H, W, 3], a
    numpy array or a tensor of any dtype, clipped to 0..255 and truncated to
    u8 as the JAX package's ``np.clip(img, 0, 255).astype(np.uint8)`` does,
    then encoded on its device."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.array(img))  # a copy: any strides
    if t.dtype != torch.uint8:
        t = t.clamp(0, 255).to(torch.uint8)
    path.write_bytes(encode_jpeg(t, quality))
    return path


def list_images(d: str | Path) -> list[Path]:
    d = Path(d)
    return sorted(p for p in d.iterdir() if p.suffix.lower() in IMG_EXTS)


def _is_jpeg(path: Path) -> bool:
    try:
        with open(path, "rb") as f:
            return is_jpeg(f.read(3))
    except OSError:
        return False


def _decode_chunk(chunk: list[Path], min_edge: int, dev: torch.device) -> tuple[list, list, list]:
    """(images, ok paths, rejected (path, reason)) of one chunk, in path
    order: a file that does not decode is a ``decode_error``, then one whose
    shorter edge is below ``min_edge`` a ``min_edge`` reject."""
    decoded: dict[int, torch.Tensor | str] = {}
    if dev.type == "cpu":  # JPEGs on the codec's thread pool, the rest one by one
        jpegs = [i for i, p in enumerate(chunk) if _is_jpeg(p)]
        imgs, status = decode_paths([chunk[i] for i in jpegs], min_edge)
        for i, img, st in zip(jpegs, imgs, status):
            decoded[i] = img if st == 0 else ("min_edge" if st == 1 else "decode_error")
    for i, p in enumerate(chunk):
        if i in decoded:
            continue
        try:
            a = decode_image(p, dev)
        except (OSError, ValueError):
            decoded[i] = "decode_error"
            continue
        decoded[i] = "min_edge" if min_edge and min(a.shape[:2]) < min_edge else a
    imgs, ok, rejected = [], [], []
    for i, p in enumerate(chunk):
        a = decoded[i]
        if isinstance(a, str):
            rejected.append((p, a))
        else:
            imgs.append(a)
            ok.append(p)
    return imgs, ok, rejected


def iter_batches(
    paths: list[Path],
    batch_size: int = 16,
    target_hw: tuple[int, int] | None = None,
    min_edge: int = 0,
    device: str | torch.device | None = None,
) -> Iterator[tuple[list[Path], torch.Tensor, list]]:
    """Yield (ok_paths, batch u8 [b, H, W, 3] on ``device``, rejected).

    Images are resized to ``target_hw`` (default: the batch max size rounded
    to /8) before stacking; only an image whose size differs is resampled.
    Images with min edge < ``min_edge`` are rejected (pipeline.py:80).
    ``rejected`` entries are (path, reason) with reason in {"min_edge",
    "decode_error"}; a chunk with no image left yields an empty
    [0, 1, 1, 3] batch beside its rejects. ``device`` None is the card."""
    dev = resolve_device(device)
    for s in range(0, len(paths), batch_size):
        chunk = [Path(p) for p in paths[s : s + batch_size]]
        imgs, ok, rejected = _decode_chunk(chunk, min_edge, dev)
        if not imgs:
            if rejected:
                yield [], torch.zeros((0, 1, 1, 3), dtype=torch.uint8, device=dev), rejected
            continue
        if target_hw is None:
            h = max(a.shape[0] for a in imgs)
            w = max(a.shape[1] for a in imgs)
            h, w = ((h + 7) // 8) * 8, ((w + 7) // 8) * 8
        else:
            h, w = target_hw
        batch = torch.stack([a if tuple(a.shape[:2]) == (h, w) else resize_bilinear_u8(a, (h, w)) for a in imgs])
        yield ok, batch, rejected
