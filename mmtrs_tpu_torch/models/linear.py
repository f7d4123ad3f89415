"""Binary logistic regression, calibration and temperature scaling (port of
mmtrs_tpu/models/linear.py: ``LogisticRegression`` with penalties ``l2``,
``none`` and ``l1``, ``platt_calibrate``, ``isotonic_calibrate``,
``make_calibrator`` and ``TemperatureScaler``).

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
        """Newton (or FISTA for ``l1``) on ``device`` (None: the card)."""
        if self.penalty not in ("none", "l2", "l1"):
            raise ValueError(f"unknown penalty {self.penalty!r}: 'l2', 'none' or 'l1'")
        dev = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        w = self._sample_weights(y.astype(int))
        if sample_weight is not None:
            w = w * np.asarray(sample_weight, dtype=np.float64)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        Xh = np.c_[X, np.ones(len(X))] if self.fit_intercept else X
        lam = 0.0 if self.penalty == "none" else 1.0 / self.C
        # lbfgs-style solvers don't regularise the intercept; liblinear (the
        # reference's L1 solver, meta_learner.py:12) does: match each
        reg_mask = torch.ones(Xh.shape[1], device=dev)
        if self.fit_intercept and self.penalty != "l1":
            reg_mask[-1] = 0.0
        if self.penalty == "l1":
            beta, self.n_iter_ = _prox_logistic(f32(Xh), f32(y), f32(w), lam, reg_mask,
                                                max(self.max_iter, 2000), self.tol)
            beta = beta.cpu().numpy().astype(np.float64)
        else:
            beta, self.n_iter_ = _newton_min_norm(Xh, f32, f32(y), f32(w), lam, reg_mask,
                                                  self.max_iter, self.tol)
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

    def predict(self, X, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(X)[:, 1] >= threshold).astype(int)

    @property
    def weights_simplex(self) -> np.ndarray:
        """Clipped-nonnegative, sum-1 coefficient view
        (MetaStacker.weights parity, meta_learner.py:20-28)."""
        w = np.clip(self.coef_, 0, None)
        s = w.sum()
        return w / s if s > 0 else np.full_like(w, 1.0 / max(w.size, 1))


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


def _newton_min_norm(Xh: np.ndarray, f32, y, w, lam, reg_mask, max_iter, tol) -> tuple[np.ndarray, int]:
    """``_newton_logistic`` on the design ``Xh`` (host f64, intercept column
    included) → (f64 coefficients, steps). Where unregularised columns are
    constant over the rows (all-zero, or two or more of them, as a constant
    feature beside the intercept) the Hessian is singular, and the JAX
    package's solve returns NaN: here those columns are replaced by one
    column of ones, the regular problem is solved, and its coefficient ``b``
    is spread as the minimum-norm solution ``β_k = v_k·b / Σ v_j²`` (a zero
    column gets 0). Gradient descent from zero, scikit-learn's lbfgs for
    ``penalty=None``, stays in that row space and ends there too. The
    predictions equal the fit without the constant columns. A design with
    no such columns takes the plain path, bit for bit."""
    free = (reg_mask == 0).cpu().numpy() if lam else np.ones(Xh.shape[1], bool)
    const = free & (Xh.max(axis=0) == Xh.min(axis=0)) if len(Xh) else np.zeros(Xh.shape[1], bool)
    v = Xh[0] if len(Xh) else np.zeros(Xh.shape[1])
    if not ((const & (v == 0)).any() or const.sum() >= 2):
        beta, it = _newton_logistic(f32(Xh), y, w, lam, reg_mask, max_iter, tol)
        return beta.cpu().numpy().astype(np.float64), it
    keep = np.nonzero(~const)[0]
    ones = (const & (v != 0)).any()
    Xr = np.c_[Xh[:, keep], np.ones(len(Xh))] if ones else Xh[:, keep]
    mask_r = torch.cat([reg_mask[torch.as_tensor(keep, device=reg_mask.device)],
                        reg_mask.new_zeros(int(ones))])
    beta_r, it = _newton_logistic(f32(Xr), y, w, lam, mask_r, max_iter, tol)
    beta_r = beta_r.cpu().numpy().astype(np.float64)
    beta = np.zeros(Xh.shape[1])
    beta[keep] = beta_r[: len(keep)]
    if ones:
        vc = np.where(const, v, 0.0)
        beta[const] = (vc * beta_r[-1] / (vc**2).sum())[const]
    return beta, it


_FISTA_BLOCK = 50


def _prox_logistic(X, y, w, lam, reg_mask, max_iter, tol) -> tuple[torch.Tensor, int]:
    """FISTA with soft-thresholding (L1), the JAX package's iteration in f32.
    A block of ``_FISTA_BLOCK`` iterations runs without reading the device;
    once ``max|β_new − β| <= tol`` the state stops changing, as JAX's
    ``while_loop`` stops there."""
    dev = X.device
    L = 0.25 * torch.linalg.matrix_norm(X * torch.sqrt(w)[:, None], ord=2) ** 2 + 1e-9
    step = 1.0 / L
    thr = step * lam * reg_mask
    beta = torch.zeros(X.shape[1], dtype=X.dtype, device=dev)
    z = beta.clone()
    t = torch.ones((), dtype=X.dtype, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(0, max_iter, _FISTA_BLOCK):
        for _ in range(_FISTA_BLOCK):
            live = ~done & (i < max_iter)
            g = X.T @ (w * (torch.sigmoid(X @ z) - y))
            raw = z - step * g
            beta_new = torch.sign(raw) * torch.clamp_min(torch.abs(raw) - thr, 0.0)
            t_new = 0.5 * (1 + torch.sqrt(1 + 4 * t * t))
            z_new = beta_new + (t - 1) / t_new * (beta_new - beta)
            delta = torch.max(torch.abs(beta_new - beta))
            beta = torch.where(live, beta_new, beta)
            z = torch.where(live, z_new, z)
            t = torch.where(live, t_new, t)
            i = i + live.long()
            done = done | (live & ~(delta > tol))
        if bool(done | (i >= max_iter)):  # one read a block
            break
    return beta, int(i)


# ---------------------------------------------------------------------------
# Calibration (host numpy, but Platt's Newton fit)
# ---------------------------------------------------------------------------


@dataclass
class PlattCalibrator:
    a: float = 1.0
    b: float = 0.0

    def transform(self, p) -> np.ndarray:
        z = np.asarray(p, dtype=np.float64)
        return 1.0 / (1.0 + np.exp(-(self.a * z + self.b)))


def platt_calibrate(scores, y, prior_correction: bool = True,
                    device: str | torch.device | None = None) -> PlattCalibrator:
    """Sigmoid calibration on scores: the Newton solver in f32 (100
    steps at most, tol 1e-10, unregularised) on [s, 1] with Platt's
    (n+1)/(n+2) targets when ``prior_correction`` (sklearn's
    _SigmoidCalibration), else the labels; on ``device`` (None: the card)."""
    dev = resolve_device(device)
    s = np.asarray(scores, dtype=np.float64).reshape(-1, 1)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if prior_correction:
        n_pos, n_neg = y.sum(), (1 - y).sum()
        t = np.where(y > 0, (n_pos + 1) / (n_pos + 2), 1.0 / (n_neg + 2))
    else:
        t = y
    if len(s) and s.max() == s.min():
        # a constant score column (a forest that scores every row alike):
        # the fit along b alone, so every row's p is the mean target; the
        # JAX package's solve returns NaN here
        m = float(np.mean(t))
        return PlattCalibrator(a=0.0, b=float(np.log(m) - np.log1p(-m)))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    beta, _ = _newton_logistic(f32(np.c_[s, np.ones(len(s))]), f32(t), torch.ones(len(s), device=dev),
                               0.0, torch.zeros(2, device=dev), 100, 1e-10)
    a, b = beta.cpu().tolist()
    return PlattCalibrator(a=float(a), b=float(b))


@dataclass
class IsotonicCalibrator:
    x_thresholds: np.ndarray = field(default_factory=lambda: np.zeros(0))
    y_thresholds: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def transform(self, p) -> np.ndarray:
        # out_of_bounds='clip' + linear interpolation (sklearn parity)
        return np.interp(np.asarray(p, dtype=np.float64), self.x_thresholds, self.y_thresholds)


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: the isotonic fit of y with weights w."""
    n = y.size
    start = list(range(n))
    vals = list(y.astype(np.float64))
    ws = list(w.astype(np.float64))
    i = 0
    while i < len(vals) - 1:
        if vals[i] > vals[i + 1] + 1e-15:
            new_w = ws[i] + ws[i + 1]
            new_v = (vals[i] * ws[i] + vals[i + 1] * ws[i + 1]) / new_w
            vals[i : i + 2] = [new_v]
            ws[i : i + 2] = [new_w]
            start.pop(i + 1)
            i = max(i - 1, 0)
        else:
            i += 1
    out = np.empty(n)
    bounds = start + [n]
    for k in range(len(vals)):
        out[bounds[k] : bounds[k + 1]] = vals[k]
    return out


def isotonic_calibrate(scores, y) -> IsotonicCalibrator:
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    t = np.asarray(y, dtype=np.float64).reshape(-1)
    order = np.argsort(s, kind="mergesort")
    s_s, t_s = s[order], t[order]
    # merge duplicate x by their mean (sklearn make_unique)
    ux, inv, counts = np.unique(s_s, return_inverse=True, return_counts=True)
    ty = np.zeros(ux.size)
    np.add.at(ty, inv, t_s)
    ty /= counts
    return IsotonicCalibrator(x_thresholds=ux, y_thresholds=_pava(ty, counts.astype(np.float64)))


class IdentityCalibrator:
    def transform(self, p) -> np.ndarray:
        return np.asarray(p)


def make_calibrator(kind: str, scores, y, device: str | torch.device | None = None):
    """'platt' | 'sigmoid' | 'isotonic' | 'none' (src/fusion/calibration.py:7-32);
    the Platt fits run on ``device`` (None: the card)."""
    if kind == "platt":
        return platt_calibrate(scores, y, prior_correction=False, device=device)
    if kind == "sigmoid":
        return platt_calibrate(scores, y, prior_correction=True, device=device)
    if kind == "isotonic":
        return isotonic_calibrate(scores, y)
    if kind in ("none", None):
        return IdentityCalibrator()
    raise ValueError(kind)


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
