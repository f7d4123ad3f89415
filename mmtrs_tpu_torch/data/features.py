"""Clinical features: 9 base features + 7 engineered interactions (port of
``engineer_features_jax`` in mmtrs_tpu/data/features.py, on tensors and
without pandas)."""

from __future__ import annotations

import torch

BASE_FEATURES: tuple[str, ...] = (
    "depth",
    "width",
    "enamel_cracks",
    "occlusal_load",
    "carious_lesion",
    "opposing_type",
    "adjacent_teeth",
    "age_range",
    "cervical_lesion",
)

ENGINEERED_FEATURES: tuple[str, ...] = (
    "deep_and_thin",
    "deep_or_cracks",
    "load_implant",
    "risk_plus_cervical",
    "stable_wall",
    "depth_x_load",
    "depth_x_risk",
)

ALL_FEATURES: tuple[str, ...] = BASE_FEATURES + ENGINEERED_FEATURES


def engineer_features(x_base: torch.Tensor) -> torch.Tensor:
    """[..., 9] base features → [..., 16] in the order of ALL_FEATURES. The
    boolean combinations compare against the exact encodings."""
    d, w, ec, ol, cl, ot, cv = (x_base[..., i] for i in (0, 1, 2, 3, 4, 5, 8))
    dt = x_base.dtype
    eng = torch.stack(
        [
            ((d == 1) & (w == 0)).to(dt),
            ((d == 1) | (ec == 1)).to(dt),
            ((ol == 1) & (ot == 3)).to(dt),
            ((cl == 1) & (cv == 1)).to(dt),
            ((w == 1) & (ec == 0) & (ol == 0)).to(dt),
            d * ol,
            d * cl,
        ],
        dim=-1,
    )
    return torch.cat([x_base, eng], dim=-1)
