"""The device loop of the record-keeping augmentation (port of the image half
of mmtrs_tpu/data/records.py:build_augmented_table, :128-153).

The lineage table (identity columns, grouped splits, child rows) needs
pandas and stays with the JAX package for now; what runs here is the part
that makes the children's images: fixed-size device batches of a child plan
through :func:`~mmtrs_tpu_torch.ops.augment.augment_batch`, each image's
randomness from its own (seed, origin_id, aug_idx) lineage, so rebuilding
reproduces the same images whatever the batch order.
"""

from __future__ import annotations

import torch

from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch


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
