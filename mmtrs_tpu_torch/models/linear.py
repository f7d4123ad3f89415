"""Binary logistic regression (port of ``LogisticRegression`` in
mmtrs_tpu/models/linear.py, penalties ``l2`` and ``none``).

``fit`` is the JAX package's Newton solver in float32 (that package runs
without x64): the intercept is not regularised, ``s = w·p·(1−p) + 1e-12``,
and the loop runs while ``i < max_iter and max|step| > tol``. In f32 the
step may never fall below ``tol = 1e-8``, and then all ``max_iter`` steps
run, as they do in JAX. The stop reads ``max|step|`` on the host, one sync a
step on the card. Prediction is float64 numpy on the fitted coefficients.
The L1 solver, Platt, isotonic and temperature scaling come with the fusion
slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device


@dataclass
class LogisticRegression:
    """penalty: 'none' | 'l2'; C is the inverse regularisation strength
    (sklearn convention); class_weight='balanced' reweights like sklearn."""

    penalty: str = "l2"
    C: float = 1.0
    max_iter: int = 100
    tol: float = 1e-8
    class_weight: str | None = None
    fit_intercept: bool = True
    coef_: np.ndarray | None = field(default=None, repr=False)
    intercept_: float = 0.0
    n_iter_: int = 0

    def _sample_weights(self, y: np.ndarray) -> np.ndarray:
        w = np.ones(y.size, dtype=np.float64)
        if self.class_weight == "balanced":
            for cls in (0, 1):
                m = y == cls
                if m.any():
                    w[m] = y.size / (2.0 * m.sum())
        return w

    def fit(self, X, y, sample_weight=None,
            device: str | torch.device | None = None) -> "LogisticRegression":
        """Newton on ``device`` (None: the card)."""
        if self.penalty not in ("none", "l2"):
            raise ValueError(f"penalty {self.penalty!r}: the port fits 'l2' and 'none'")
        dev = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        w = self._sample_weights(y.astype(int))
        if sample_weight is not None:
            w = w * np.asarray(sample_weight, dtype=np.float64)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        Xd = f32(np.c_[X, np.ones(len(X))] if self.fit_intercept else X)
        d = Xd.shape[1]
        lam = 0.0 if self.penalty == "none" else 1.0 / self.C
        reg_mask = torch.ones(d, device=dev)
        if self.fit_intercept:
            reg_mask[-1] = 0.0
        beta, self.n_iter_ = _newton_logistic(Xd, f32(y), f32(w), lam, reg_mask,
                                              self.max_iter, self.tol)
        beta = beta.cpu().numpy().astype(np.float64)
        if self.fit_intercept:
            self.coef_, self.intercept_ = beta[:-1], float(beta[-1])
        else:
            self.coef_, self.intercept_ = beta, 0.0
        return self

    def decision_function(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        return X @ self.coef_ + self.intercept_

    def predict_proba(self, X) -> np.ndarray:
        z = self.decision_function(X)
        p = 1.0 / (1.0 + np.exp(-z))
        return np.c_[1 - p, p]


def _newton_logistic(X, y, w, lam, reg_mask, max_iter, tol) -> tuple[torch.Tensor, int]:
    beta = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    penalty = lam * torch.diag(reg_mask)
    i, delta = 0, float("inf")
    while i < max_iter and delta > tol:
        p = torch.sigmoid(X @ beta)
        g = X.T @ (w * (p - y)) + lam * reg_mask * beta
        s = w * p * (1 - p) + 1e-12
        H = (X * s[:, None]).T @ X + penalty
        step = torch.linalg.solve(H, g)
        beta = beta - step
        i += 1
        delta = step.abs().max().item()
    return beta, i
