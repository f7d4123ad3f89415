"""Shared training machinery (port of mmtrs_tpu/train/common.py): ImageNet
normalisation, the losses (BCE with optional sample weights, two-class CE
with label smoothing and class weights), the samplers (epoch batches,
inverse-class-count sampling), the imgs/s tracker, the device-resident
dataset, the best-epoch snapshot and the optimiser.

The optimiser is optax's, not ``torch.optim``'s:
``make_optimizer(lr, wd, total, grad_clip, warmup)`` is
``chain(clip_by_global_norm(grad_clip), adamw(schedule, weight_decay=wd))``
with the schedule ``warmup_cosine_decay_schedule(init=lr, peak=lr,
warmup_steps=1, decay_steps=max(total, 2), end=lr·1e-2)`` without warmup,
or ``(init=0, peak=lr, warmup_steps=w, ...)`` with ``w = min(warmup,
total − 1)`` steps of it, each part written out with optax's arithmetic:

- the schedule is evaluated in f32 at the step count before the step
  (without warmup the first step takes ``lr``, with it 0);
- the clip leaves the gradients alone when their global norm is below
  ``grad_clip`` and scales them by ``grad_clip / norm`` otherwise
  (``clip_grad_norm_`` divides by ``norm + 1e-6`` and differs);
- AdamW with b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction, and the decoupled decay ``lr·wd·p`` on every parameter
  (optax's ``adamw`` here has no mask; BatchNorm's running statistics are
  buffers, not parameters, and get none).

Mixed precision is the JAX package's: bf16 activations inside the backbone,
f32 parameters, gradients and optimiser state, no loss scaling.
"""

from __future__ import annotations

import copy
import functools
import math
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from mmtrs_tpu_torch.parallel.mesh import all_reduce_grads_

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.cache
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    # made once per device: a copy to the card per call would wait for it
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_imagenet(imgs: torch.Tensor) -> torch.Tensor:
    """uint8/float 0..255 [B, H, W, 3] → ImageNet-normalised float32
    (datasets.py:21-22)."""
    x = imgs.float() / 255.0
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card from pinned memory without
    waiting for it (a pageable copy synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def device_put_dataset(x, device: torch.device) -> torch.Tensor:
    """Move a whole (u8) image dataset to ``device`` once per run, so the
    trainers' per-step ``images[sel]`` is a gather there; a tensor already
    on that device is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def bce_logits(logit: torch.Tensor, target: torch.Tensor, sample_weight: torch.Tensor | None = None,
               group=None) -> torch.Tensor:
    """BCE on a single logit, the JAX package's stable form
    max(z, 0) − z·t + log1p(exp(−|z|)): the mean, or with ``sample_weight``
    Σ l·w / max(Σ w, 1e-8). With a data ``group`` (``parallel.mesh``) the
    rank's term of the global loss, whose mean over the ranks is that loss:
    the shard's mean (the shards are equal), or size · Σ_shard l·w /
    max(Σ_group w, 1e-8)."""
    loss = torch.clamp_min(logit, 0) - logit * target + torch.log1p(torch.exp(-torch.abs(logit)))
    if sample_weight is not None:
        if group is not None:
            wsum = group.all_sum(sample_weight.sum().reshape(1))[0]
            return group.size * (loss * sample_weight).sum() / torch.clamp_min(wsum, 1e-8)
        return (loss * sample_weight).sum() / torch.clamp_min(sample_weight.sum(), 1e-8)
    return loss.mean()


def ce_two_class(logits: torch.Tensor, y: torch.Tensor, label_smoothing: float = 0.05,
                 class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """2-class CE on [B, 2] logits (train_hard.py:195): one-hot targets
    smoothed to (1 − ls)·onehot + ls/2, each row's loss weighted by
    ``class_weights[y]`` when given, the mean."""
    y = y.long()
    oh = torch.nn.functional.one_hot(y, 2).to(logits.dtype) * (1 - label_smoothing) + label_smoothing / 2
    loss = -(oh * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    if class_weights is not None:
        loss = loss * class_weights[y]
    return loss.mean()


def weighted_sampler_indices(y: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """WeightedRandomSampler equivalent: ``n`` rows drawn with replacement
    with inverse-class-count weights (train_hard.py:64-69), the JAX
    package's ``rng.choice`` call on the caller's generator."""
    y = np.asarray(y).astype(int)
    counts = np.bincount(y, minlength=2).astype(np.float64)
    w = 1.0 / np.maximum(counts[y], 1.0)
    p = w / w.sum()
    return rng.choice(len(y), size=n, replace=True, p=p)


def epoch_batches(
    n: int,
    batch_size: int,
    rng: np.random.Generator,
    indices: np.ndarray | None = None,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """The JAX package's sampler: the same numpy ``Generator`` calls, so the
    batches are the same."""
    idx = np.arange(n) if indices is None else np.asarray(indices)
    idx = idx[rng.permutation(len(idx))]
    end = (len(idx) // batch_size) * batch_size if drop_last else len(idx)
    for s in range(0, max(end, 0), batch_size):
        yield idx[s : s + batch_size]


@dataclass
class Throughput:
    """imgs/s tracker (train_hard_kfold_v2.py:175-187 parity)."""

    images: int = 0
    seconds: float = 0.0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_images: int):
        self.seconds += time.perf_counter() - self._t0
        self.images += n_images

    @property
    def imgs_per_sec(self) -> float:
        return self.images / self.seconds if self.seconds > 0 else 0.0


def snapshot(model: torch.nn.Module, optimizer: "AdamW | None" = None) -> dict:
    """A copy of the model's state dict (parameters and BatchNorm
    statistics) and of the optimiser's state, on their device, that later
    steps do not change."""
    return {
        "model": {k: v.detach().clone() for k, v in model.state_dict().items()},
        "optimizer": None if optimizer is None else copy.deepcopy(optimizer.state_dict()),
    }


def warmup_cosine_lr(lr: float, total_steps: int, count: int, warmup_steps: int = 0) -> float:
    """The JAX ``make_optimizer``'s schedule at ``count``, in f32 with
    optax's operations. Without warmup, ``warmup_cosine_decay_schedule(
    init_value=lr, peak_value=lr, warmup_steps=1, decay_steps=max(total, 2),
    end_value=lr·1e-2)``: step 0 is the (flat) warmup's ``lr``. With
    ``warmup_steps`` > 0, w = min(warmup_steps, total − 1) steps rise
    linearly from 0 (init_value 0): step c < w takes lr − lr·(1 − c/w).
    From step w the cosine over ``decay_steps − w`` steps at ``count − w``.
    Near the end of the decay 1 + cos cancels, so one ulp of the cosine is
    ~1e-7 of the rate."""
    f = np.float32
    warmup = min(warmup_steps, max(total_steps - 1, 0))
    w = warmup if warmup else 1
    if count < w:
        if not warmup:
            return float(f(lr))
        frac = f(1) - f(count) / f(w)
        return float(f(-lr) * frac + f(lr))
    decay = max(total_steps, 2) - w
    alpha = lr * 1e-2 / lr  # end_value / peak_value, in double as optax takes it
    c = f(min(float(count - w), float(decay)))
    arg = f(math.pi) * c / f(decay)
    cosine = f(0.5) * (f(1) + f(math.cos(float(arg))))  # cos rounded once from double, as XLA's f32 cos is
    return float(f(lr) * (f(1 - alpha) * cosine + f(alpha)))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: g unchanged where
    ‖g‖ < max_norm, else g / ‖g‖ · max_norm; returns ‖g‖ (a device
    scalar, never read on the host)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def average_grads(params, group, loss: torch.Tensor) -> torch.Tensor:
    """Between backward and the optimiser step (so before its global-norm
    clip): with a data group (``parallel.mesh``), the gradients of
    ``params`` averaged over it, one gradient all-reduce that the loss rides
    in; → the loss detached, with a group the ranks' mean (the global
    batch's loss). Without one, the loss as it is."""
    loss = loss.detach()
    if group is None:
        return loss
    return all_reduce_grads_(params, group, loss.reshape(1).float())[0]


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(schedule, b1, b2, eps,
    weight_decay))`` over a list of parameters, stepped after ``backward``.
    Nothing is read on the host: the step count and learning rate are host
    numbers, the clip is a device-side select."""

    def __init__(self, params, lr: float, weight_decay: float, total_steps: int,
                 grad_clip: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 warmup_steps: int = 0):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.weight_decay, self.total_steps = lr, weight_decay, total_steps
        self.warmup_steps = warmup_steps
        self.grad_clip, self.b1, self.b2, self.eps = grad_clip, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_at(self, count: int) -> float:
        return warmup_cosine_lr(self.lr, self.total_steps, count, self.warmup_steps)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip)
        b1, b2 = self.b1, self.b2
        # mu ← (1 − b1)·g + b1·mu, nu ← (1 − b2)·g² + b2·nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        n = self.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd·p, p ← p − lr·u
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -self.lr_at(self.count))
        torch._foreach_add_(self.params, upd)
        self.count = n

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}


def make_optimizer(params, lr: float, weight_decay: float = 1e-4, total_steps: int = 1000,
                   grad_clip: float = 0.0, warmup_steps: int = 0) -> AdamW:
    """The JAX package's ``make_optimizer(lr, weight_decay, total_steps,
    warmup_steps, grad_clip)`` over ``params``."""
    return AdamW(params, lr, weight_decay, total_steps, grad_clip, warmup_steps=warmup_steps)
