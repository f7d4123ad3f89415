"""Record-keeping offline augmentation: lineage tables and device-batched
images (port of mmtrs_tpu/data/records.py, on the port's pandas-free
:class:`~mmtrs_tpu_torch.utils.table.Table`).

:func:`build_augmented_table` builds the table as the JAX package does
(augment_records.py:369-576):

- every original row gets ``origin_id`` (its image_id) and ``aug_idx=0``;
  children 1..N inherit ALL parent metadata plus the parent's split;
- without a ``split`` column, a grouped train/test split over the originals
  (``_grouped_frac_split``: the same numpy ``default_rng`` calls, so the
  same ids); ``val_frac > 0`` carves a grouped ``val`` out of TRAIN;
- child rows are named ``<stem>__augK.jpg``;
- the lineage columns lead, the others follow in their order.

The children's images come from :func:`augment_children`, the device loop:
fixed-size batches of the child plan through
:func:`~mmtrs_tpu_torch.ops.augment.augment_batch`, each image's randomness
from its own (seed, origin_id, aug_idx) lineage, so rebuilding reproduces
the same images whatever the batch order.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch
from mmtrs_tpu_torch.utils.table import Table

LINEAGE_COLS = ["image_id", "image_name", "origin_id", "aug_idx", "split"]


def to_jpg_name(name: str) -> str:
    """Normalize any image filename to ``<stem>.jpg`` (augment_records.py:40)."""
    return Path(str(name)).stem + ".jpg"


def _grouped_frac_split(ids: np.ndarray, frac: float, seed: int) -> set:
    """Deterministic grouped holdout: ``round(frac·n)`` unique ids (at least
    one) from a permutation of the sorted unique ids."""
    uniq = np.unique(ids)
    rng = np.random.default_rng(seed)
    k = max(1, int(round(frac * len(uniq))))
    return set(rng.permutation(uniq)[:k].tolist())


def child_plan(origin_ids, n_aug: int) -> list[tuple[int, int, int]]:
    """(src_index, origin_id, aug_idx) of every child, origin-major with
    aug_idx 1..n_aug ascending, as build_augmented_table orders its rows."""
    return [(i, int(o), j) for i, o in enumerate(origin_ids) for j in range(1, n_aug + 1)]


def quantize_round_half_even(out: torch.Tensor) -> torch.Tensor:
    """The table's u8 store: clip(round(x), 0, 255) with round-half-even
    (``jnp.round``), unlike the chain's round-half-up; u8 passes through."""
    if out.dtype == torch.uint8:
        return out
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def augment_children(
    imgs: torch.Tensor, plan, preset: str = "ten", seed: int = 42, batch_size: int = 32
) -> torch.Tensor:
    """The children's images of a child plan.

    ``imgs``: the u8 originals [n, H, W, 3] on the device that runs the loop
    (moved there once by the caller); ``plan``: (src_index, origin_id,
    aug_idx) per child (:func:`child_plan`). Each batch of ``batch_size``
    children is padded by repeating its last entry, gathered from ``imgs`` on
    the device, drawn on the host (:func:`draw_batch`) and augmented with
    ``aug_idx − 1`` as the variant of ``ten``/``simple``, so n_aug = 10
    covers their ten variants. → u8 [len(plan), H, W, 3] on that device,
    quantised there with round-half-even."""
    if imgs.dtype != torch.uint8 or imgs.dim() != 4:
        raise ValueError(f"augment_children: needs u8 [n, H, W, 3] originals, got {imgs.dtype} {tuple(imgs.shape)}")
    _, H, W, _ = imgs.shape
    out = torch.empty((len(plan), *imgs.shape[1:]), dtype=torch.uint8, device=imgs.device)
    for s in range(0, len(plan), batch_size):
        part = list(plan[s : s + batch_size])
        n = len(part)
        src, origins, aug_idxs = zip(*(part + [part[-1]] * (batch_size - n)))
        variants = [a - 1 for a in aug_idxs]
        chunk = imgs.index_select(0, torch.tensor(src, device=imgs.device))
        draws = draw_batch(preset, seed, origins, aug_idxs, H, W, aug_idx=variants, img_size=H)
        res = augment_batch(chunk, draws, preset, aug_idx=variants, img_size=H)
        out[s : s + n] = quantize_round_half_even(res[:n])
    return out


def build_augmented_table(
    table: Table,
    imgs,
    n_aug: int = 10,
    preset: str = "ten",
    seed: int = 42,
    test_frac: float = 0.2,
    val_frac: float = 0.0,
    batch_size: int = 32,
    image_writer: Callable[[str, torch.Tensor], None] | None = None,
    device: str | torch.device | None = None,
) -> tuple[Table, torch.Tensor]:
    """Build the augmented lineage table and its images on ``device`` (None:
    the card).

    Args:
      table: one row per ORIGINAL case; must carry ``image_name`` and/or
          ``image_id``; ``split`` optional (created grouped if absent).
      imgs: ``[n, H, W, 3]`` u8 originals aligned with the rows (numpy or a
          tensor), moved to the device once.
      n_aug: children per original.
      preset: ``legacy`` | ``ten`` | ``simple`` | ``none``.
      image_writer: optional ``(name, img) -> None`` called for every output
          row, originals included, with the row's u8 [H, W, 3] image on the
          device.

    Returns:
      (table, out_imgs): the originals' rows, then the children's
      (origin-major, aug_idx ascending); ``out_imgs[i]`` is row i's u8 image,
      on the device.
    """
    if len(table) != len(imgs):
        raise ValueError(f"table has {len(table)} rows but imgs has {len(imgs)}")
    dev = resolve_device(device)
    df = table.copy()

    # --- normalize identity columns (augment_records.py:414-424) ---
    if "image_name" not in df:
        if "image_id" not in df:
            raise ValueError("need image_name or image_id")
        df["image_name"] = [f"{int(x)}.jpg" for x in df["image_id"]]
    df["image_name"] = [to_jpg_name(str(s).lower()) for s in df["image_name"]]
    if "image_id" not in df:
        df["image_id"] = [
            int("".join(c for c in Path(s).stem if c.isdigit()) or i + 1)
            for i, s in enumerate(df["image_name"])
        ]
    df["image_id"] = df["image_id"].astype(np.int64)
    df["origin_id"] = df["image_id"]
    df["aug_idx"] = np.zeros(len(df), np.int64)

    # --- grouped train/test split if absent (augment_records.py:426-433) ---
    if "split" not in df:
        test_ids = _grouped_frac_split(df["origin_id"], test_frac, seed)
        df["split"] = np.where(np.isin(df["origin_id"], list(test_ids)), "test", "train")

    # --- children: inherit everything, lineage overridden ---
    src = np.repeat(np.arange(len(df)), n_aug)
    children = df.take(src)
    children["image_id"] = int(df["image_id"].max()) + 1 + np.arange(len(src))
    children["image_name"] = [f"{Path(df['image_name'][i]).stem}__aug{j}.jpg"
                              for i, j in zip(src, np.tile(np.arange(1, n_aug + 1), len(df)))]
    children["aug_idx"] = np.tile(np.arange(1, n_aug + 1, dtype=np.int64), len(df))
    children["split"] = [str(s).lower() for s in children["split"]]
    plan = [(int(i), int(o), int(j)) for i, o, j in zip(src, children["origin_id"], children["aug_idx"])]

    # --- device-batched augmentation: the originals move there once ---
    imgs_d = imgs if isinstance(imgs, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(imgs))
    imgs_d = imgs_d.to(dev, torch.uint8)
    if plan:
        kids = augment_children(imgs_d, plan, preset=preset, seed=seed, batch_size=batch_size)
    else:
        kids = imgs_d[:0]
    out = Table.concat([df, children])
    out_imgs = torch.cat([imgs_d, kids])

    # --- grouped val inside TRAIN (augment_records.py:545-560) ---
    if val_frac > 0:
        tr_mask = np.array([str(s).lower() == "train" for s in out["split"]], dtype=bool)
        fams = out["origin_id"][tr_mask]
        if len(fams):
            val_ids = _grouped_frac_split(fams, val_frac, seed)
            split = out["split"].copy()
            split[np.isin(out["origin_id"], list(val_ids)) & tr_mask] = "val"
            out["split"] = split

    lead = [c for c in LINEAGE_COLS if c in out]
    out = out.select(lead + [c for c in out.columns if c not in lead])

    if image_writer is not None:
        for name, img in zip(out["image_name"], out_imgs):
            image_writer(name, img)
    return out, out_imgs
