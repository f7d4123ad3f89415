"""Batch-subset application (port of ``subset_apply`` from
mmtrs_tpu/ops/augment.py; the augmentation ops come with slice 2)."""

from __future__ import annotations

import torch


def subset_apply(op, imgs: torch.Tensor, on: torch.Tensor, *extras: torch.Tensor):
    """Apply a per-image-independent batch op only where ``on[b]``.

    Selects the rows with a boolean index, runs ``op(sub_imgs, *sub_extras)``
    on them and copies the results back with ``index_copy_`` into a copy of
    ``imgs``; untouched rows pass through bit-exact. Eager PyTorch has no
    static shapes, so the JAX version's static capacity and full-batch
    fallback are not needed: the output is the same."""
    idx = torch.nonzero(on.to(imgs.device)).flatten()
    if idx.numel() == 0:
        return imgs
    sub_out = op(imgs.index_select(0, idx), *[e.index_select(0, idx) for e in extras])
    return imgs.clone().index_copy_(0, idx, sub_out.to(imgs.dtype))
