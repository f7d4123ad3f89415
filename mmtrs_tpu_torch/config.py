"""Preprocessing configuration (the port's copy of
``mmtrs_tpu.config.PreprocessConfig``).

Kept in the port so that it imports nothing of the JAX package;
tests/test_torch_hygiene.py holds the two classes to the same fields and
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
