"""L1 logistic meta-stacker (port of mmtrs_tpu/fusion/meta.py;
src/fusion/meta_learner.py:5-28 parity): the port's FISTA solver in place
of liblinear, on the card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import numpy as np
import torch

from mmtrs_tpu_torch.models.linear import LogisticRegression


class MetaStacker:
    """L1-regularised logistic meta-learner; harmful streams are dropped by
    the sparsity, and ``weights_`` is the clipped, normalised view."""

    def __init__(self, C: float = 1.0, device: str | torch.device | None = None):
        self.model = LogisticRegression(penalty="l1", C=C, max_iter=5000)
        self.device = device

    def fit(self, P, y) -> "MetaStacker":
        self.model.fit(np.asarray(P, dtype=float), np.asarray(y).astype(int), device=self.device)
        return self

    def predict_proba(self, P) -> np.ndarray:
        return np.clip(self.model.predict_proba(np.asarray(P, dtype=float))[:, 1], 0, 1)

    @property
    def weights_(self) -> list[float]:
        return self.model.weights_simplex.tolist()
