"""Shared training/serving helpers (port of mmtrs_tpu/train/common.py).
Only ``normalize_imagenet`` so far; the trainers come with the training slice."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(imgs: torch.Tensor) -> torch.Tensor:
    """uint8/float 0..255 [B, H, W, 3] → ImageNet-normalised float32
    (datasets.py:21-22)."""
    x = imgs.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
