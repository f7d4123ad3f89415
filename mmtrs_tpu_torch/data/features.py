"""Clinical features: 9 base features + 7 engineered interactions (port of
mmtrs_tpu/data/features.py without pandas): ``engineer_features`` on
tensors, ``build_features`` and ``features_to_array`` on the port's
:class:`~mmtrs_tpu_torch.utils.table.Table`, and the label and weight
column names."""

from __future__ import annotations

import numpy as np
import torch

from mmtrs_tpu_torch.utils.table import Table

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

# Monotonicity prior over BASE_FEATURES (models/xgboost_model.py:30):
# depth(+), width(-), cracks(+), load(+), lesion(+), opposing(0),
# adjacent(0), age(0), cervical(+)
DEFAULT_MONOTONE: tuple[int, ...] = (1, -1, 1, 1, 1, 0, 0, 0, 1)

LABEL_HARD = "y_majority"
LABEL_SOFT = "p_indirect"
SAMPLE_WEIGHT = "weight"


def to_numeric(col: np.ndarray) -> np.ndarray:
    """pandas' ``to_numeric(col, errors="coerce")`` as float64: numbers as
    they are, text parsed as a float where it is one, anything else NaN."""
    col = np.asarray(col)
    if col.dtype.kind in "biuf":
        return col.astype(np.float64)

    def num(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return np.nan

    return np.array([num(v) for v in col], dtype=np.float64)


def build_features(table: Table, impute_zero: bool = True) -> Table:
    """9 base → 16 ordered int64 columns (prepare_streams.py:19-44
    semantics): each base column coerced to a number, missing values 0,
    then truncated to an integer, as the JAX package's
    ``fillna(0).astype(int)``."""
    missing = [c for c in BASE_FEATURES if c not in table]
    if missing:
        raise KeyError(f"Missing base features: {missing}")
    X = {}
    for c in BASE_FEATURES:
        col = to_numeric(table[c])
        if impute_zero:
            col = np.where(np.isnan(col), 0.0, col)
        X[c] = col.astype(np.int64)
    d, w = X["depth"], X["width"]
    ec, ol = X["enamel_cracks"], X["occlusal_load"]
    cl, ot, cv = X["carious_lesion"], X["opposing_type"], X["cervical_lesion"]
    X["deep_and_thin"] = ((d == 1) & (w == 0)).astype(np.int64)
    X["deep_or_cracks"] = ((d == 1) | (ec == 1)).astype(np.int64)
    X["load_implant"] = ((ol == 1) & (ot == 3)).astype(np.int64)
    X["risk_plus_cervical"] = ((cl == 1) & (cv == 1)).astype(np.int64)
    X["stable_wall"] = ((w == 1) & (ec == 0) & (ol == 0)).astype(np.int64)
    X["depth_x_load"] = d * ol
    X["depth_x_risk"] = d * cl
    return Table({c: X[c] for c in ALL_FEATURES})


def features_to_array(table: Table, engineered: bool = True) -> np.ndarray:
    """[N, 16] (or the 9 base columns as they are) float32."""
    if engineered:
        X = build_features(table)
        return np.stack([X[c] for c in ALL_FEATURES], axis=1).astype(np.float32)
    return np.stack([np.asarray(table[c], dtype=np.float32) for c in BASE_FEATURES], axis=1)


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
