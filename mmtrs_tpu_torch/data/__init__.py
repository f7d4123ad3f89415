"""Tabular data (port of mmtrs_tpu/data/): the counterpart of each name in
the JAX package's ``mmtrs_tpu.data.__all__``; its ``engineer_features_jax``
is the port's ``engineer_features``."""

from mmtrs_tpu_torch.data.features import (
    ALL_FEATURES,
    BASE_FEATURES,
    ENGINEERED_FEATURES,
    build_features,
    engineer_features,
)
from mmtrs_tpu_torch.data.standardize import add_split, compute_targets, standardize_table
from mmtrs_tpu_torch.data.splits import (
    audit_report,
    balanced_grouped_split,
    group_kfold,
    grouped_train_test_split,
    propagate_split_to_augmented,
    stratified_group_kfold,
    stratified_kfold,
)

__all__ = [
    "BASE_FEATURES",
    "ENGINEERED_FEATURES",
    "ALL_FEATURES",
    "build_features",
    "engineer_features",
    "standardize_table",
    "compute_targets",
    "add_split",
    "grouped_train_test_split",
    "group_kfold",
    "stratified_kfold",
    "stratified_group_kfold",
    "balanced_grouped_split",
    "propagate_split_to_augmented",
    "audit_report",
]
