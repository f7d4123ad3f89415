"""Binary metrics and thresholds (port of mmtrs_tpu/metrics/): the
counterpart of each name in the JAX package's ``mmtrs_tpu.metrics.__all__``."""

from mmtrs_tpu_torch.metrics.binary import (
    average_precision,
    binary_report,
    brier,
    confusion,
    evaluate,
    log_loss,
    roc_auc,
)
from mmtrs_tpu_torch.metrics.thresholds import choose_threshold, sweep_thresholds, threshold_grid, tune_threshold

__all__ = [
    "roc_auc",
    "average_precision",
    "brier",
    "log_loss",
    "confusion",
    "binary_report",
    "evaluate",
    "choose_threshold",
    "tune_threshold",
    "threshold_grid",
    "sweep_thresholds",
]
