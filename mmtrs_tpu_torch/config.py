"""Configurations (the port's copies of ``Paths``, ``PreprocessConfig``,
``AugmentConfig``, ``SplitConfig``, ``GBDTConfig``, ``MILConfig``,
``MMJointConfig``, ``FusionConfig``, ``VisionTrainConfig``,
``ProgressiveStage``, ``ProgressiveConfig`` and ``MeshConfig`` in
mmtrs_tpu/config.py, and of its ``config_to_json`` and
``config_from_dict``).

Kept in the port so that it imports nothing of the JAX package;
tests/test_torch_hygiene.py holds each copy to the original's fields and
defaults.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

REPO_ROOT = Path(__file__).resolve().parent.parent


@dataclass(frozen=True)
class Paths:
    """Directory layout mirroring the reference artifact conventions."""

    root: Path = REPO_ROOT
    raw_images: Path = REPO_ROOT / "data" / "raw" / "images"
    processed_images: Path = REPO_ROOT / "data" / "processed" / "images"
    log_dir: Path = REPO_ROOT / "logs"
    weights_dir: Path = REPO_ROOT / "weights"
    results_dir: Path = REPO_ROOT / "results"
    models_out_dir: Path = REPO_ROOT / "models" / "outputs"


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


@dataclass(frozen=True)
class GBDTConfig:
    """Histogram gradient-boosted trees (``models/gbdt.py``).

    Defaults follow the reference XGBoost recipe (xgboost_model.py:152-163);
    use :meth:`lgbm_like` / :meth:`stack_tab_like` for the other recipes.
    """

    objective: str = "binary_logistic"  # binary_logistic | soft_regression
    n_estimators: int = 1200
    learning_rate: float = 0.03
    max_depth: int = 3
    num_leaves: int = 31
    min_child_weight: float = 5.0
    gamma: float = 1.0
    subsample: float = 0.9
    colsample: float = 0.9
    reg_lambda: float = 1.0
    reg_alpha: float = 0.5
    max_bins: int = 64
    early_stopping_rounds: int = 120
    monotone_constraints: tuple[int, ...] | None = None
    consensus_power: float = 0.7
    min_weight: float = 0.0
    class_balanced: bool = True
    grow_policy: str = "depthwise"  # depthwise (xgb-like) | leafwise (lgbm-like)
    seed: int = 42

    @staticmethod
    def lgbm_like() -> "GBDTConfig":
        """Soft-target regressor recipe (reference: lightgbm_model.py:59-111).
        min_child_weight=20 mirrors LightGBM's min_data_in_leaf default (the
        L2 objective has unit hessian per sample)."""
        return GBDTConfig(
            objective="soft_regression",
            n_estimators=1200,
            learning_rate=0.03,
            max_depth=-1,
            num_leaves=31,
            min_child_weight=20.0,
            gamma=0.0,
            subsample=1.0,
            colsample=1.0,
            reg_lambda=0.0,
            reg_alpha=0.0,
            early_stopping_rounds=100,
            consensus_power=0.5,
            class_balanced=False,
            grow_policy="leafwise",
        )

    @staticmethod
    def stack_tab_like() -> "GBDTConfig":
        """Final-fusion tabular stream recipe (reference: stack_blend.py:134-147:
        lr .03, 700 est, 31 leaves, subsample/colsample .85, min_data_in_leaf 5,
        class_weight balanced, seed 42)."""
        return GBDTConfig(
            objective="binary_logistic",
            n_estimators=700,
            learning_rate=0.03,
            max_depth=-1,
            num_leaves=31,
            min_child_weight=1.0,
            gamma=0.0,
            subsample=0.85,
            colsample=0.85,
            reg_lambda=0.0,
            reg_alpha=0.0,
            early_stopping_rounds=0,
            class_balanced=True,
            grow_policy="leafwise",
            consensus_power=0.0,
        )


@dataclass(frozen=True)
class MILConfig:
    """Gated-attention MIL (reference: train_mil_attention_v1.py)."""

    model_name: str = "efficientnet_b0"
    bag_size: int = 12
    crop_scale: tuple[float, float] = (0.4, 1.0)
    img_size: int = 320
    attn_dim: int = 128
    epochs: int = 20
    batch_size: int = 8
    lr: float = 3e-4
    weight_decay: float = 1e-4
    n_folds: int = 5
    seed: int = 2025
    tta_hflip: bool = True


@dataclass(frozen=True)
class FusionConfig:
    streams: tuple[str, ...] = ("prob_tab", "prob_mm", "prob_mil")
    n_folds: int = 5
    thr_mode: str = "max_f1"  # max_f1|max_acc|youden|target_prec|target_rec
    thr_target: float = 0.8
    calibration: str = "none"  # none | platt | isotonic
    seed: int = 42
    meta_l1: bool = False
    meta_max_iter: int = 1000


# ---------------------------------------------------------------------------
# Vision trainers (reference: models/vision/train_hard.py,
#                  experiments/vision_v2/train_hard_v2.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VisionTrainConfig:
    model_name: str = "efficientnet_b3"
    img_size: int = 512
    task: str = "hard"  # hard | soft
    epochs: int = 30
    batch_size: int = 16
    lr: float = 3e-4
    weight_decay: float = 1e-4
    label_smoothing: float = 0.05
    drop_rate: float = 0.2
    drop_path: float = 0.1
    warmup_steps: int = 0
    seed: int = 42
    group_col: str = "origin_id"
    val_frac: float = 0.15
    tta_hflip: bool = True
    bf16: bool = True
    num_devices: int = 0  # 0 = all available


@dataclass(frozen=True)
class ProgressiveStage:
    img_size: int
    epochs: int
    batch_size: int
    lr: float


@dataclass(frozen=True)
class ProgressiveConfig:
    """Progressive multi-seed trainer (reference: train_hard_v2.py:175-280)."""

    model_name: str = "efficientnet_b4"
    stages: tuple[ProgressiveStage, ...] = (
        ProgressiveStage(384, 12, 16, 3e-4),
        ProgressiveStage(512, 8, 8, 1e-4),
    )
    seeds: tuple[int, ...] = (42, 43, 44)
    label_smoothing: float = 0.10
    warmup_steps: int = 100


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """1-D data mesh is the designed parallelism for these model scales
    (SURVEY.md §2.12). Axis names kept general for future TP axes."""

    data_axis: str = "data"
    num_devices: int = 0  # 0 = all


@dataclass(frozen=True)
class AugmentConfig:
    """Record-keeping augmentation parameters (reference:
    augment_records.py:369-576 and the presets at :335-362)."""

    preset: str = "ten"  # legacy | ten | simple | none
    n_aug: int = 10
    seed: int = 42
    test_frac: float = 0.2
    val_frac: float = 0.0
    image_size: int = 512
    # per-image deterministic RNG stream: seed * 1000003 + origin_id
    rng_stride: int = 1000003


@dataclass(frozen=True)
class SplitConfig:
    train_frac: float = 0.70
    val_frac: float = 0.15
    test_frac: float = 0.15
    seed: int = 42
    n_trials: int = 400
    group_col: str = "origin_id"
    n_folds: int = 5
    test_size: int = 80  # exact test rows (reference: Standraized_dataset.py:210-218)


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, Mapping):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2, sort_keys=True)


def config_from_dict(cls: type, d: Mapping[str, Any]) -> Any:
    """Rebuild a (possibly nested) frozen dataclass from a plain dict."""
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = f.type if isinstance(f.type, type) else None
        if ftype is not None and dataclasses.is_dataclass(ftype):
            v = config_from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)
