"""Configurations (the port's copies of ``PreprocessConfig`` and
``MMJointConfig`` in mmtrs_tpu/config.py).

Kept in the port so that it imports nothing of the JAX package;
tests/test_torch_hygiene.py holds each copy to the original's fields and
defaults.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PreprocessConfig:
    """Image preprocessing parameters (reference: src/config.py:14-18,
    src/preprocessing/pipeline.py:33-46)."""

    min_edge_px: int = 400
    output_size: int = 512
    clahe_clip: float = 3.0
    clahe_tiles: tuple[int, int] = (8, 8)
    rot_tolerance_deg: float = 15.0
    crop_margin_px: int = 15
    do_crop: bool = True
    do_rotate: bool = True
    jpeg_quality: int = 95
    # Segmentation mask-selection heuristics (reference: segment.py:33-58)
    seg_score_threshold: float = 0.05
    seg_min_saturation: float = 40.0
    # Canny-lite deskew gates (reference: normalise.py:19-57)
    canny_low: float = 50.0
    canny_high: float = 150.0
    deskew_min_edge_points: int = 10


@dataclass(frozen=True)
class MMJointConfig:
    """Joint image+tabular dual-task model
    (reference: train_mm_joint_dualtask.py:135-160,375-376)."""

    model_name: str = "efficientnet_b4"
    img_size: int = 380
    tab_dim: int = 9
    tab_hidden: int = 64
    tab_dropout: float = 0.2
    head_dropout: float = 0.2
    alpha_hard: float = 1.0
    beta_soft: float = 0.3
    epochs: int = 25
    batch_size: int = 12
    lr: float = 3e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    n_folds: int = 5
    seed: int = 42
    thr_grid: tuple[float, float, int] = (0.2, 0.8, 61)
    # train-time augmentation (reference trains under timm create_transform
    # with RandAugment rand-m9-mstd0.5-inc1 + random-erasing 0.2 —
    # train_mm_joint_dualtask.py:72-93); "none" disables (eval is never
    # augmented either way)
    train_aug: str = "randaug"
