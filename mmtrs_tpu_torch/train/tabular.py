"""The tabular fold ensemble's loader (port of ``load_tab_ensemble`` in
mmtrs_tpu/train/tabular.py). The k-fold trainer comes with the tabular
training slice."""

from __future__ import annotations

from pathlib import Path

import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.models.gbdt import Forest


def load_tab_ensemble(folder: str | Path, device: str | torch.device | None = None) -> list[Forest]:
    """Every ``tab_fold*`` forest of ``folder``, in name order, on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    return [Forest.load(p.with_suffix(""), dev) for p in sorted(Path(folder).glob("tab_fold*.npz"))]
