"""Binary logistic regression and temperature scaling (port of
``LogisticRegression``, penalties ``l2`` and ``none``, and
``TemperatureScaler`` in mmtrs_tpu/models/linear.py).

``fit`` is the JAX package's Newton solver in float32 (that package runs
without x64): the intercept is not regularised, ``s = w·p·(1−p) + 1e-12``,
and the loop runs while ``i < max_iter and max|step| > tol``. In f32 the
step may never fall below ``tol = 1e-8``, and then all ``max_iter`` steps
run, as they do in JAX. The stop reads ``max|step|`` on the host, one sync a
step on the card. Prediction is float64 numpy on the fitted coefficients.
The L1 solver, Platt and isotonic calibration come with the fusion slice.

``TemperatureScaler.fit`` minimises the same loss as the JAX package, the
mean BCE of ``logits / T`` over log T, but by Newton's method in float64 to
convergence where the JAX package runs 50 steps of ``optax.lbfgs`` in f32.
The loss is convex in 1/T, so it has at most one minimum, and both reach
it (the tests hold T within 1e-4 relative).
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


@dataclass
class TemperatureScaler:
    """Single-parameter temperature on binary logits; fit minimizes BCE
    (train_mm_joint_dualtask.py:162-174 semantics)."""

    temperature: float = 1.0

    def fit(self, logits, y, max_iter: int = 100, tol: float = 1e-12) -> "TemperatureScaler":
        """Newton on u = log T from u = 0 (T = 1), host float64. With
        s = z·e^(−u): loss = mean(softplus(s) − y·s), d/du = −mean((σ(s) − y)·s),
        d²/du² = mean(σ(s)(1 − σ(s))·s² + (σ(s) − y)·s); a step that does
        not lower the loss is halved. It stops when the step or the slope
        falls below ``tol``: where the logits carry no signal the loss falls
        towards T → ∞ and T ends large (~1e11; JAX's f32 LBFGS ends ~1e14),
        p = 0.5 either way."""
        z = np.asarray(logits, dtype=np.float32).reshape(-1).astype(np.float64)
        t = np.asarray(y, dtype=np.float32).reshape(-1).astype(np.float64)

        def loss(u):
            s = z * np.exp(-u)
            return float(np.mean(np.logaddexp(0.0, s) - t * s))

        u, f = 0.0, loss(0.0)
        for _ in range(max_iter):
            s = z * np.exp(-u)
            p = 0.5 * (1.0 + np.tanh(0.5 * s))  # σ(s) without overflow
            g = -np.mean((p - t) * s)
            if abs(g) < tol:  # converged, or the loss flat towards T → ∞ (uninformative logits)
                break
            h = np.mean(p * (1.0 - p) * s * s + (p - t) * s)
            step = -g / h if h > 0 else -np.sign(g)
            while True:
                f_new = loss(u + step)
                if f_new <= f or abs(step) < tol:
                    break
                step *= 0.5
            u, f = u + step, f_new
            if abs(step) < tol:
                break
        self.temperature = float(np.exp(u))
        return self

    def transform_logits(self, logits) -> np.ndarray:
        return np.asarray(logits) / self.temperature

    def transform(self, logits) -> np.ndarray:
        z = self.transform_logits(logits)
        return 1.0 / (1.0 + np.exp(-z))
