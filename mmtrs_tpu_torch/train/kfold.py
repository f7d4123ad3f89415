"""K-fold vision trainer (port of mmtrs_tpu/train/kfold.py; the reference's
experiments/vision_v2 layer).

From train_hard_kfold_v2.py: StratifiedGroupKFold (:249-252), one logit with
BCE and pos_weight = neg/pos or the weighted sampler (:267-314), gradient
accumulation (:169-172), the head-only warm-up freeze (:319-334) and the
debug tools (--overfit-n, the quick train-probe AUC, grad norm, logit std,
imgs/s). From train_hard_groupcv_v3.py: pre-exported fold tables (:322-334),
binary-safe MixUp/CutMix (:38-82), the freeze → unfreeze schedule
(:226-293), parameter EMA (:219), patience (:285-293) and the constrained
threshold (:157-194).

The JAX trainer's optax pieces, written out:

- ``optax.MultiSteps(tx, k)`` (``grad_accum`` k > 1): each micro step's
  gradient goes into a running mean (``acc + (g − acc)/(n + 1)``); every
  k-th micro step AdamW takes that mean, and only then does its count (the
  schedule's step) advance. BatchNorm statistics move on every micro step,
  as they do in the JAX train step.
- The freeze: during ``freeze_epochs`` the optimiser holds only the
  ``classifier`` parameters; the backbone gets no update, no moments and no
  decay. At the first epoch after it the optimiser is rebuilt over every
  parameter with a fresh state (and a fresh accumulator), as in JAX. The
  JAX package wraps AdamW in ``optax.masked``, which passes the raw
  gradient through for the masked-out leaves, so its frozen epochs add each
  backbone gradient to its parameter at step size 1; the port does what
  the reference and the JAX docstring intend.
- EMA: after every micro step ``e ← d·e + (1 − d)·p`` in f32 over copies of
  the parameters taken at the fold's start; evaluation and the best state
  use the EMA parameters with the current BatchNorm statistics.

Everything runs on the card unless the caller passes ``device="cpu"``; the
model computes in f32 unless ``cfg.bf16``. The host reads the device once an
epoch (the step statistics) and once per ``predict_proba``. Batch order and
sampler indices come from ``np.random.default_rng(cfg.seed)`` with the JAX
package's calls; dropout and drop-path bits from the trainer's
``torch.Generator``, and the MixUp/CutMix draws from
``np.random.default_rng([cfg.seed, step])`` (``MixDraws``): neither are the
JAX package's bits. ``predict_proba``'s hflip TTA averages logits (the
vision trainer's averages probabilities).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.data.splits import stratified_group_kfold
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.binary import roc_auc
from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds, threshold_grid
from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
from mmtrs_tpu_torch.models.backbones.factory import create_model
from mmtrs_tpu_torch.ops.resize import resize_bilinear
from mmtrs_tpu_torch.parallel.mesh import all_mean_, all_reduce_grads_, data_parallel_eval, replicate, sharded
from mmtrs_tpu_torch.train.common import (
    Throughput,
    device_put_dataset,
    epoch_batches,
    host_to_device,
    make_optimizer,
    normalize_imagenet,
    weighted_sampler_indices,
)
from mmtrs_tpu_torch.utils.table import Table

# ---------------------------------------------------------------------------
# Binary-safe MixUp / CutMix (train_hard_groupcv_v3.py:38-82)
# ---------------------------------------------------------------------------


@dataclass
class MixDraws:
    """The random quantities of one ``apply_mixup_cutmix`` call: the gate,
    the mixup/cutmix choice, the partner permutation, the two Beta draws
    (f32) and the cut box's centre as uniform [0, 1) fractions of H and W
    (f32)."""

    gate: bool
    use_cut: bool
    perm: np.ndarray  # [B] int
    lam_mix: np.float32
    lam_cut: np.float32
    cy_u: np.float32
    cx_u: np.float32

    @staticmethod
    def draw(rng: np.random.Generator, batch: int, mixup_alpha: float = 0.2, cutmix_alpha: float = 1.0,
             p: float = 0.5) -> "MixDraws":
        return MixDraws(
            gate=bool(rng.random() < p), use_cut=bool(rng.random() < 0.5), perm=rng.permutation(batch),
            lam_mix=np.float32(rng.beta(mixup_alpha, mixup_alpha)),
            lam_cut=np.float32(rng.beta(cutmix_alpha, cutmix_alpha)),
            cy_u=np.float32(rng.random()), cx_u=np.float32(rng.random()),
        )

    @staticmethod
    def from_numpy(gate, use_cut, perm, lam_mix, lam_cut, cy_u, cx_u) -> "MixDraws":
        """From arrays (e.g. the JAX package's own draws for a key)."""
        f = lambda a: np.float32(np.asarray(a))
        return MixDraws(bool(np.asarray(gate)), bool(np.asarray(use_cut)), np.asarray(perm).astype(np.int64),
                        f(lam_mix), f(lam_cut), f(cy_u), f(cx_u))


def apply_mixup_cutmix(imgs: torch.Tensor, targets: torch.Tensor, draws: MixDraws):
    """Mix the batch [B, H, W, C] with its permutation ``draws.perm`` when
    the gate fires: mixup λ·x + (1 − λ)·x[perm], or cutmix (the box of
    sides √(1 − λ)·(H, W) around (cy, cx) pasted from x[perm], λ then 1 −
    the box's area share); the targets mixed by the same λ. The scalars are
    f32, as the JAX function's."""
    if not draws.gate:
        return imgs, targets
    B, H, W, _ = imgs.shape
    f = np.float32
    perm = torch.as_tensor(draws.perm, device=imgs.device)
    other = imgs.index_select(0, perm)
    if draws.use_cut:
        side = np.sqrt(f(1) - draws.lam_cut)
        rh, rw = side * f(H), side * f(W)
        cy, cx = draws.cy_u * f(H), draws.cx_u * f(W)
        # the box's rows and columns, decided on the host with the f32 bounds
        rows = (np.arange(H, dtype=f) >= cy - rh / f(2)) & (np.arange(H, dtype=f) < cy + rh / f(2))
        cols = (np.arange(W, dtype=f) >= cx - rw / f(2)) & (np.arange(W, dtype=f) < cx + rw / f(2))
        box = torch.from_numpy(rows[:, None] & cols[None, :]).to(imgs.device)[None, :, :, None]
        out = torch.where(box, other, imgs)
        lam = f(1) - f(rows.sum() * cols.sum()) / f(H * W)
    else:
        lam = draws.lam_mix
        out = float(lam) * imgs + float(f(1) - lam) * other
    t = float(lam) * targets + float(f(1) - lam) * targets.index_select(0, perm)
    return out, t


def tune_threshold_constrained(y, p, objective: str = "max_f1", min_recall: float = 0.0,
                               grid: np.ndarray | None = None) -> float:
    """Among thresholds with recall ≥ min_recall, the one maximising f1 or
    acc (groupcv_v3 tune_threshold :157-194); the unconstrained optimum
    when none meets the constraint."""
    ts = grid if grid is not None else threshold_grid("fusion")
    s = sweep_thresholds(y, p, ts)
    key = {"max_f1": "f1", "max_acc": "acc"}[objective]
    vals = np.where(s["rec"] >= min_recall, s[key], -np.inf)
    if np.all(np.isinf(vals) & (vals < 0)):
        vals = s[key]
    return float(ts[int(np.argmax(vals))])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KFoldConfig:
    model_name: str = "convnextv2_base"
    img_size: int = 512
    epochs: int = 20
    batch_size: int = 8
    grad_accum: int = 1
    lr: float = 3e-4
    weight_decay: float = 1e-4
    n_folds: int = 5
    seed: int = 42
    use_pos_weight: bool = True  # else weighted sampler
    freeze_epochs: int = 0  # head-only warm-up
    use_mixup: bool = False
    ema_decay: float = 0.0  # 0 = off
    patience: int = 0  # 0 = no early stopping
    overfit_n: int = 0  # debug: train on first N samples only
    thr_objective: str = "max_f1"
    thr_min_recall: float = 0.0
    bf16: bool = False


class KFoldHardTrainer:
    """Single-logit BCE k-fold trainer with the v2/v3 training tricks."""

    def __init__(self, cfg: KFoldConfig, device: str | torch.device | None = None, init: dict | None = None,
                 group=None):
        """``device`` None: the card. ``init``: the state dict every fold
        starts from (the JAX trainer's ``model.init(key(cfg.seed))``);
        without one, a Flax-default init drawn from
        ``torch.Generator().manual_seed(cfg.seed)``. The model has the
        factory's dropout 0.2 and drop-path 0.1. ``group``: a
        ``parallel.mesh.DataGroup`` (JAX's ``mesh=``): each rank preps and
        mixes the global batch (MixUp's partners cross the shards), steps
        on its rows, and scores its shard of every eval batch."""
        self.cfg = cfg
        self.group = group
        if group is not None and cfg.batch_size % group.size != 0:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by the group's size {group.size}")
        self.device = resolve_device(device)
        model = create_model(cfg.model_name, num_classes=1, dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
        if init is None:
            init = lecun_init_(model, torch.Generator().manual_seed(cfg.seed)).state_dict()
        self._init = {k: v.detach().to("cpu", copy=True) for k, v in init.items()}
        self.model = model.to(self.device)
        self.model.load_state_dict(self._init)
        self._eval_model = copy.deepcopy(self.model).requires_grad_(False)

    # -- the step --------------------------------------------------------------

    def init_state(self, total_steps: int, pos_weight: float = 1.0) -> None:
        """A fold's start: the model at ``init`` in train mode, the dropout
        generator, the optimiser for ``total_steps`` (the classifier alone
        while ``freeze_epochs``), the EMA copies and the step count."""
        self.model.load_state_dict(self._init)
        if self.group is not None:
            replicate(self.group, self.model)
        self.model.train()
        self.pos_weight = pos_weight
        self.gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self._build_opt(total_steps, freeze_backbone=self.cfg.freeze_epochs > 0)
        self._ema = [p.detach().clone() for p in self.model.parameters()] if self.cfg.ema_decay > 0 else None
        self.step = 0

    def _build_opt(self, total_steps: int, freeze_backbone: bool) -> None:
        """AdamW on the cosine schedule over the classifier (frozen) or
        every parameter, with an empty accumulator."""
        named = [(n, p) for n, p in self.model.named_parameters()
                 if not freeze_backbone or n.startswith("classifier.")]
        self.opt = make_optimizer([p for _, p in named], self.cfg.lr, self.cfg.weight_decay, total_steps)
        self._acc = [torch.zeros_like(p) for p in self.opt.params] if self.cfg.grad_accum > 1 else None
        self._micro = 0

    @torch.no_grad()
    def _apply(self) -> None:
        """The optimiser's part of a micro step (MultiSteps when grad_accum
        > 1)."""
        if self._acc is None:
            self.opt.step()
            return
        n = self._micro
        for a, p in zip(self._acc, self.opt.params):
            a.add_((p.grad - a) / (n + 1))
        if n == self.cfg.grad_accum - 1:
            for a, p in zip(self._acc, self.opt.params):
                p.grad = a.clone()
            if self.group is not None:  # the window's one gradient all-reduce
                all_reduce_grads_(self.opt.params, self.group)
            self.opt.step()
            for a in self._acc:
                a.zero_()
        self._micro = (n + 1) % self.cfg.grad_accum

    def train_step(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One micro step on a prepared batch → [loss, grad norm (over every
        parameter), logit std], device scalars (not read here). The loss is
        BCEWithLogits with pos_weight: Σ l·w / Σ w, w = pos_weight where
        t > 0.5, else 1. With a group the batch is the rank's rows, Σ w and
        the statistics are the global batch's, and the gradients are
        averaged once per optimiser step: every step without accumulation
        (the grad norm then the averaged gradient's), once a window with it
        (then no micro step's global gradient exists, and its grad norm is
        NaN)."""
        with sharded(self.group):
            logit = self.model(x, generator=self.gen)[..., 0]
        l = torch.clamp_min(logit, 0) - logit * t + torch.log1p(torch.exp(-torch.abs(logit)))
        w = torch.where(t > 0.5, torch.full_like(t, self.pos_weight), torch.ones_like(t))
        if self.group is None:
            loss = (l * w).sum() / w.sum()
        else:  # this rank's term of the global Σ l·w / Σ w (the ranks' mean is it)
            loss = self.group.size * (l * w).sum() / self.group.all_sum(w.sum().reshape(1))[0]
        for p in self.model.parameters():
            p.grad = None
        loss.backward()
        if self.group is None:
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            stats = [loss.detach(), gnorm, logit.detach().std(unbiased=False)]
        else:
            stats = self._group_stats(loss, logit)
        self._apply()
        self.step += 1
        if self._ema is not None:
            with torch.no_grad():
                d = self.cfg.ema_decay
                torch._foreach_mul_(self._ema, d)
                torch._foreach_add_(self._ema, torch._foreach_mul([p.detach() for p in self.model.parameters()],
                                                                  1 - d))
        return torch.stack(stats)

    def _group_stats(self, loss: torch.Tensor, logit: torch.Tensor) -> list[torch.Tensor]:
        """Under a group, before the optimiser's part: the global loss and
        logit moments averaged with the gradients (without accumulation), or
        alone (inside an accumulation window); → [loss, grad norm, logit
        std] of the global batch."""
        z = logit.detach().float()
        local = torch.stack([loss.detach().float(), z.sum(), (z * z).sum()])
        if self._acc is None:
            loss_g, zsum, z2sum = all_reduce_grads_(self.model.parameters(), self.group, local)
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        else:
            loss_g, zsum, z2sum = all_mean_(local, self.group)
            gnorm = torch.full((), float("nan"), device=loss.device)
        mean = zsum / z.numel()  # the ranks' mean of shard sums over a shard's rows: the global mean
        return [loss_g, gnorm, torch.sqrt(torch.clamp_min(z2sum / z.numel() - mean * mean, 0.0))]

    def _mix_draws(self, step: int, batch: int) -> MixDraws:
        return MixDraws.draw(np.random.default_rng([self.cfg.seed, step]), batch)

    def _prep(self, imgs: torch.Tensor) -> torch.Tensor:
        x = imgs
        if x.shape[1] != self.cfg.img_size:
            x = resize_bilinear(x, (self.cfg.img_size, self.cfg.img_size))
        return normalize_imagenet(x.float())

    # -- states ----------------------------------------------------------------

    def _eval_state(self) -> dict:
        """A copy of the weights evaluation uses: the EMA parameters (or the
        live ones) with the live BatchNorm statistics."""
        sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        if self._ema is not None:
            for (n, _), e in zip(self.model.named_parameters(), self._ema):
                sd[n] = e.clone()
        return {"model": sd}

    def frozen_leaves_moved(self) -> list[str]:
        """The backbone parameters that differ from the fold's start."""
        return [n for n, p in self.model.named_parameters()
                if not n.startswith("classifier.") and not torch.equal(p.detach().cpu(), self._init[n])]

    @torch.no_grad()
    def predict_proba(self, state: dict, images: torch.Tensor, tta: bool = True) -> np.ndarray:
        """sigmoid of the logit of ``state`` (a copy of the model in eval
        mode; the training model is untouched), with ``tta`` the mean of the
        image's and its W-flip's logits. The last batch is padded by
        repeating its last row; with a group each rank scores its shard of a
        batch, gathered in rank order (``data_parallel_eval``). One
        device→host copy."""
        net = self._eval_model
        net.load_state_dict(state["model"])
        net.eval()
        bs = self.cfg.batch_size
        images = device_put_dataset(images, self.device)

        def score(imgs):
            x = self._prep(imgs)
            l = net(x)[..., 0]
            return 0.5 * (l + net(x.flip(2))[..., 0]) if tta else l

        out, pads = [], []
        for s in range(0, len(images), bs):
            imgs = images[s : s + bs]
            pad = bs - len(imgs)
            if pad:
                imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
            out.append(data_parallel_eval(self.group, score, imgs))
            pads.append(pad)
        host = torch.cat(out).float().cpu().numpy()
        chunks, ofs = [], 0
        for pad in pads:
            p = 1 / (1 + np.exp(-host[ofs : ofs + bs]))
            chunks.append(p[: bs - pad])
            ofs += bs
        return np.concatenate(chunks)

    # -- a fold ----------------------------------------------------------------

    def fit_fold(self, images: torch.Tensor, y: np.ndarray, train_idx: np.ndarray, val_idx: np.ndarray,
                 epochs: int | None = None, log=print) -> dict:
        """Train one fold from the start on ``images`` (u8, on the device)
        → {"auc" (best val AUC), "state" (its eval state), "since", "thr"
        (the constrained threshold on val with TTA), "imgs_per_sec",
        "history" (per epoch loss, grad norm, logit std, val AUC), and
        "frozen_moved": with ``freeze_epochs``, the backbone parameters that
        the frozen epochs changed (none, by construction)}."""
        cfg = self.cfg
        dev = self.device
        epochs = epochs or cfg.epochs
        if cfg.overfit_n:
            train_idx = train_idx[: cfg.overfit_n]
        n = len(train_idx)
        ytr = y[train_idx].astype(np.float32)
        pos = max(ytr.sum(), 1.0)
        pos_weight = float((len(ytr) - pos) / pos) if cfg.use_pos_weight else 1.0
        steps = max(n // cfg.batch_size, 1) * epochs

        self.init_state(steps, pos_weight)
        y_d = torch.as_tensor(y.astype(np.float32), device=dev)
        val_d = torch.as_tensor(val_idx, device=dev)

        rng = np.random.default_rng(cfg.seed)
        best = {"auc": -np.inf, "state": self._eval_state(), "since": 0}
        tp = Throughput()
        history, frozen_moved = [], None
        for ep in range(epochs):
            if cfg.freeze_epochs and ep == cfg.freeze_epochs:
                frozen_moved = self.frozen_leaves_moved()
                # unfreeze: rebuild the optimiser over every parameter, keep the weights
                self._build_opt(steps, freeze_backbone=False)
            sampler = (None if cfg.use_pos_weight
                       else weighted_sampler_indices(ytr, (n // cfg.batch_size) * cfg.batch_size, rng))
            self.model.train()
            stats, seen = [], 0
            tp.start()
            for bidx in epoch_batches(n, cfg.batch_size, rng, indices=sampler):
                sel_d = host_to_device(train_idx[bidx], dev)
                x = self._prep(images.index_select(0, sel_d))
                t = y_d[sel_d]
                if cfg.use_mixup:
                    x, t = apply_mixup_cutmix(x, t, self._mix_draws(self.step, len(bidx)))
                if self.group is not None:  # mixed over the global batch, then this rank's rows
                    rows = self.group.rows(len(bidx))
                    x, t = x[rows], t[rows]
                stats.append(self.train_step(x, t))
                seen += len(bidx)
            stats = torch.stack(stats).cpu().numpy() if stats else np.full((1, 3), np.nan)  # one read an epoch
            tp.stop(seen)
            eval_state = self._eval_state()
            p_val = self.predict_proba(eval_state, images.index_select(0, val_d), tta=False)
            auc = roc_auc(y[val_idx], p_val)
            loss, gnorm, lstd = stats.mean(axis=0)
            history.append({"epoch": ep, "loss": float(loss), "grad_norm": float(gnorm), "logit_std": float(lstd),
                            "val_auc": auc})
            log(f"[kfold ep {ep}] loss {loss:.4f} gnorm {gnorm:.3f} logit_std {lstd:.3f} "
                f"val_auc {auc:.4f} ({tp.imgs_per_sec:.1f} imgs/s)")
            if auc > best["auc"]:
                best = {"auc": auc, "state": eval_state, "since": 0}
            else:
                best["since"] += 1
                if cfg.patience and best["since"] >= cfg.patience:
                    log(f"[kfold] early stop at epoch {ep}")
                    break
        if cfg.freeze_epochs and frozen_moved is None:
            frozen_moved = self.frozen_leaves_moved()
        # threshold on val with the constrained objective
        p_val = self.predict_proba(best["state"], images.index_select(0, val_d))
        best["thr"] = tune_threshold_constrained(y[val_idx], p_val, cfg.thr_objective, cfg.thr_min_recall)
        best["imgs_per_sec"] = tp.imgs_per_sec
        best["history"] = history
        best["frozen_moved"] = frozen_moved
        return best

    def quick_train_probe(self, state: dict, images: torch.Tensor, y: np.ndarray, n: int = 64) -> float:
        """Train-probe AUC on the first ``n`` rows (quick_train_sample_metrics
        :103-121)."""
        sel = np.arange(min(n, len(images)))
        p = self.predict_proba(state, images[: len(sel)], tta=False)
        return roc_auc(y[sel], p)


def run_hard_kfold(
    images,
    table: Table,
    cfg: KFoldConfig,
    outdir=None,
    epochs: int | None = None,
    via_folds: Table | None = None,
    log=print,
    device: str | torch.device | None = None,
    init: dict | None = None,
    group=None,
) -> dict:
    """StratifiedGroupKFold over the train+val rows' ``origin_id`` (or the
    ``fold`` column of a pre-exported ``via_folds`` table, groupcv_v3
    --via-folds-dir) on ``device`` (None: the card); with a data ``group``
    every rank runs it, the steps and evals divided
    (``KFoldHardTrainer``), and rank 0 writes ``outdir``. ``images``: u8
    [N, H, W, 3] aligned with ``table``'s rows (``y_majority``, ``split``,
    ``origin_id``, ``image_name``). Writes to ``outdir`` oof_val.csv and
    pred_test.csv (image_name, y, prob_vis_hard) and summary.json, for the
    stack (predict_hard.py:92-103). → the summary {"folds", "mean_val_auc",
    "test_auc"} as the JAX package returns it, plus "fits": each fold's
    ``fit_fold`` result (not written)."""
    from mmtrs_tpu_torch.utils.io import save_json
    from mmtrs_tpu_torch.utils.table import to_csv

    y = np.asarray(table["y_majority"]).astype(int)
    is_test = np.asarray(table["split"]) == "test"
    tv = np.nonzero(~is_test)[0]
    te = np.nonzero(is_test)[0]
    trainer = KFoldHardTrainer(cfg, device=device, init=init, group=group)
    if group is not None and group.rank != 0:
        outdir = None
    # the dataset lives on the device for the run: a step's rows are a gather there
    images = device_put_dataset(images, trainer.device)
    if via_folds is not None:
        folds = np.asarray(via_folds["fold"])
        splits = [(np.nonzero(folds[tv] != k)[0], np.nonzero(folds[tv] == k)[0]) for k in range(cfg.n_folds)]
    else:
        splits = list(stratified_group_kfold(y[tv], np.asarray(table["origin_id"])[tv], cfg.n_folds, cfg.seed))

    te_d = torch.as_tensor(te, device=trainer.device)
    oof = np.full(len(tv), np.nan)
    test_probs, summaries, fits = [], [], []
    for fold, (tr_rel, va_rel) in enumerate(splits):
        tr, va = tv[tr_rel], tv[va_rel]
        best = trainer.fit_fold(images, y, tr, va, epochs=epochs, log=log)
        oof[va_rel] = trainer.predict_proba(best["state"], images.index_select(0, torch.as_tensor(va, device=trainer.device)))
        if len(te):
            test_probs.append(trainer.predict_proba(best["state"], images.index_select(0, te_d)))
        summaries.append({"fold": fold, "val_auc": float(best["auc"]), "thr": best["thr"],
                          "imgs_per_sec": best["imgs_per_sec"]})
        fits.append(best)
    p_test = np.mean(test_probs, axis=0) if test_probs else np.zeros(0)
    result = {
        "folds": summaries,
        "mean_val_auc": float(np.mean([s["val_auc"] for s in summaries])),
        "test_auc": roc_auc(y[te], p_test) if len(te) else None,
    }
    if outdir is not None:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        names = np.asarray(table["image_name"])
        to_csv(Table({"image_name": names[tv], "y": y[tv], "prob_vis_hard": oof}), outdir / "oof_val.csv")
        to_csv(Table({"image_name": names[te], "y": y[te], "prob_vis_hard": p_test}), outdir / "pred_test.csv")
        save_json(result, outdir / "summary.json")
    return dict(result, fits=fits)
