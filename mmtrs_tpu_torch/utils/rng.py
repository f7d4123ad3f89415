"""Seeded RNG discipline (port of mmtrs_tpu/utils/rng.py).

The reference derives a deterministic per-image RNG stream as
``seed * 1000003 + origin_id`` (augment_records.py:476), so augmentation is
reproducible per lineage whatever the iteration order. Here each
(seed, origin_id, aug_idx) lineage gets its own CPU ``torch.Generator``,
seeded with that mix and ``aug_idx`` folded in the same way:

    lineage_seed = ((seed · 1000003 + origin_id) · 1000003 + aug_idx) mod 2⁶⁴

Draws then depend on the lineage only, never on batch order or device. The
JAX package folds the same integers into threefry keys; its bits are not
reproduced here.
"""

from __future__ import annotations

import torch

RNG_STRIDE = 1000003
_MASK64 = (1 << 64) - 1


def lineage_seed(seed: int, origin_id: int, aug_idx: int = 0) -> int:
    """The integer mix above, as an unsigned 64-bit seed."""
    return ((int(seed) * RNG_STRIDE + int(origin_id)) * RNG_STRIDE + int(aug_idx)) & _MASK64


def generator_for_origin(seed: int, origin_id: int, aug_idx: int = 0) -> torch.Generator:
    """A fresh CPU generator for one (seed, origin_id, aug_idx) lineage."""
    return torch.Generator().manual_seed(lineage_seed(seed, origin_id, aug_idx))


def generators_for_batch(seed: int, origin_ids, aug_idxs) -> list[torch.Generator]:
    """One generator per image; ``aug_idxs`` may be one int for the batch."""
    origin_ids = [int(o) for o in origin_ids]
    if isinstance(aug_idxs, int):
        aug_idxs = [aug_idxs] * len(origin_ids)
    aug_idxs = [int(a) for a in aug_idxs]
    if len(aug_idxs) != len(origin_ids):
        raise ValueError(f"{len(origin_ids)} origin ids but {len(aug_idxs)} aug indices")
    return [generator_for_origin(seed, o, a) for o, a in zip(origin_ids, aug_idxs)]


def stem_id(stem: str) -> int:
    """A file stem's lineage id, the same in every process: CRC-32 of its
    UTF-8 bytes, mod 2³¹. The JAX package's augmentation CLIs take
    ``hash(stem) % 2**31``, which Python salts per process
    (``PYTHONHASHSEED``), so their children change from run to run."""
    import zlib

    return zlib.crc32(str(stem).encode("utf-8")) % (2**31)
