"""MM dual-task trainer (port of mmtrs_tpu/train/mm.py; the reference's
train_mm_joint_dualtask.py).

GroupKFold on origin_id over the train+val rows, a per-fold StandardScaler
on the 9 tabular features, loss α·BCE(hard) + β·BCE(soft) in f32, optax's
AdamW with the per-step cosine schedule and grad-clip
(``train.common.make_optimizer``), on-line ``randaug`` of each train batch
on the device, per-epoch temperature scaling of the val logits, the F1
threshold sweep over 0.2–0.8 × 61, the best val AUC (strictly greater) kept
as a copy with its {thr, T, scaler}, 3-view TTA prediction (as is, flipped
along W, flipped along H) with sigmoid(logit / T); then oof_val.csv,
pred_test.csv, summary.json, metrics.jsonl and, with ``save_ckpts``, one
npz checkpoint per fold that ``serve.ensembles.MMEnsemble.from_folder``
reads, and ``finalize_mm_from_ckpts`` predicts again from without
training.

Everything runs on the card unless the caller passes ``device="cpu"``. The
dataset moves there once; a step gathers its rows there. The host reads
the device once per epoch (the step losses), once per ``logits`` call, and
otherwise only sends: batch indices, and the ``randaug`` draws made on the
host. Dropout and drop-path bits come from the trainer's own
``torch.Generator``, seeded from ``cfg.seed`` at every fold's start, so they
are not the JAX package's bits; nor are the ``randaug`` draws (one
generator per (seed, dataset row, epoch), ``ops.augment.draw_randaug``).

A fold starts from ``init`` (a state dict of ``MMJointDualHead``), as every
JAX fold starts from ``model.init(key(cfg.seed))``; without one, from a
Flax-default init drawn from ``torch.Generator().manual_seed(cfg.seed)``
(``lecun_init_``: LeCun-normal kernels, zero biases, identity BatchNorms).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.config import MMJointConfig
from mmtrs_tpu_torch.data.features import BASE_FEATURES
from mmtrs_tpu_torch.data.splits import group_kfold
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.binary import roc_auc
from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds
from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
from mmtrs_tpu_torch.models.linear import TemperatureScaler
from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch
from mmtrs_tpu_torch.ops.resize import resize_bilinear
from mmtrs_tpu_torch.parallel.mesh import data_parallel_eval, replicate, sharded
from mmtrs_tpu_torch.train.common import (
    average_grads,
    bce_logits,
    device_put_dataset,
    epoch_batches,
    host_to_device,
    make_optimizer,
    normalize_imagenet,
    snapshot,
)
from mmtrs_tpu_torch.utils.table import Table


@dataclass
class StandardScaler:
    mean: np.ndarray
    scale: np.ndarray

    @staticmethod
    def fit(X: np.ndarray) -> "StandardScaler":
        m = X.mean(axis=0)
        s = X.std(axis=0)
        return StandardScaler(m, np.where(s > 0, s, 1.0))

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.scale


def mm_fold_splits(table_tv: Table, n_folds: int):
    """The fold generator of training (and of the reference's finalize):
    GroupKFold over ``origin_id``, in sklearn's order."""
    yield from group_kfold(table_tv["origin_id"], n_folds)


class MMTrainer:
    def __init__(self, cfg: MMJointConfig = MMJointConfig(), device: str | torch.device | None = None,
                 init: dict | None = None, dtype: torch.dtype = torch.bfloat16, group=None):
        """``device`` None: the card. ``dtype`` is the backbone's compute
        type (bf16, as the JAX trainer's; the tests take f32). ``init``: the
        state dict every fold starts from (see the module's docstring).
        ``group``: a ``parallel.mesh.DataGroup`` (JAX's ``mesh=``): each
        rank steps on its rows of every batch and scores its shard of every
        eval batch, and the steps are the one-process steps on the whole
        batch."""
        self.cfg = cfg
        self.group = group
        if group is not None and cfg.batch_size % group.size != 0:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by the group's size {group.size}")
        self.device = resolve_device(device)
        model = MMJointDualHead(cfg.model_name, cfg.tab_hidden, cfg.tab_dropout, cfg.head_dropout,
                                dtype=dtype)
        if init is None:
            init = lecun_init_(model, torch.Generator().manual_seed(cfg.seed)).state_dict()
        self._init = {k: v.detach().clone() for k, v in init.items()}
        self.model = model.to(self.device)
        self.model.load_state_dict(self._init)

    def init_state(self, total_steps: int, pretrained: dict | None = None) -> None:
        """Reset the model to the fold's start, a fresh optimiser for
        ``total_steps`` and the dropout generator. ``pretrained``: backbone
        weights (a state dict of the backbone, port names) merged over the
        start; one that does not match the backbone raises."""
        cfg = self.cfg
        self.model.load_state_dict(self._init)
        if pretrained is not None:
            try:
                self.model.backbone.load_state_dict(pretrained, strict=True)
            except RuntimeError as e:
                raise ValueError(f"pretrained weights do not fit {cfg.model_name}'s backbone: {e}") from e
        if self.group is not None:
            replicate(self.group, self.model)
        self.model.train()
        self.opt = make_optimizer(self.model.parameters(), cfg.lr, cfg.weight_decay, total_steps,
                                  grad_clip=cfg.grad_clip)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def loss(self, img: torch.Tensor, tab: torch.Tensor, y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The train-mode forward of a prepared batch and its loss,
        α·BCE(hard) + β·BCE(soft) in f32: the step's first stage (with a
        group, of the rank's rows)."""
        with sharded(self.group):
            lc, lr_ = self.model(img, tab, generator=self.gen)
        return self.cfg.alpha_hard * bce_logits(lc, y) + self.cfg.beta_soft * bce_logits(lr_, p)

    def backward(self, loss: torch.Tensor) -> None:
        """The step's second stage: the gradients of ``loss``; the third is
        ``self.opt.step()``."""
        self.opt.zero_grad()
        loss.backward()

    def train_step(self, img: torch.Tensor, tab: torch.Tensor, y: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
        """One step on a prepared batch (all on the device; with a group the
        rank's rows, the gradients averaged over it before the clip) → its
        loss (the global batch's), a device scalar (not read here)."""
        loss = self.loss(img, tab, y, p)
        self.backward(loss)
        loss = average_grads(self.opt.params, self.group, loss)
        self.opt.step()
        return loss

    def _prep(self, imgs: torch.Tensor) -> torch.Tensor:
        x = imgs
        if x.shape[1] != self.cfg.img_size:
            x = resize_bilinear(x, (self.cfg.img_size, self.cfg.img_size))
        return normalize_imagenet(x.float())

    def _prep_train(self, imgs: torch.Tensor, sel: np.ndarray, epoch: int) -> torch.Tensor:
        """Train-batch prep: on-device augmentation (``cfg.train_aug``, the
        reference's timm create_transform, train_mm_joint_dualtask.py:72-93)
        of the u8 batch, its draws made on the host per (seed, dataset row,
        epoch), before resize and normalise. Eval batches go through
        ``_prep`` and are never augmented."""
        x = imgs
        if self.cfg.train_aug != "none":
            H, W = int(x.shape[1]), int(x.shape[2])
            sel = [int(s) for s in sel]
            draws = draw_batch(self.cfg.train_aug, self.cfg.seed, sel, [epoch] * len(sel), H, W, img_size=H)
            x = augment_batch(x, draws, self.cfg.train_aug, img_size=H)
        x = x.float()
        if x.shape[1] != self.cfg.img_size:
            x = resize_bilinear(x, (self.cfg.img_size, self.cfg.img_size))
        return normalize_imagenet(x)

    @torch.no_grad()
    def logits(self, images: torch.Tensor, tab: np.ndarray, tta: bool = True) -> np.ndarray:
        """3-way TTA (none/hflip/vflip) mean logit of the model in eval mode
        (trainer _predict :321-345). The last batch is padded by repeating
        its last row; with a group each rank scores its shard of a batch
        and the logits are gathered (``data_parallel_eval``). The view means
        stay on the device and are copied to the host once."""
        bs = self.cfg.batch_size
        was_training = self.model.training
        self.model.eval()
        tab = torch.as_tensor(np.asarray(tab, np.float32), device=self.device)  # one copy

        def score(imgs, t):
            x = self._prep(imgs)
            views = [x, x.flip(2), x.flip(1)] if tta else [x]
            return sum(self.model(v, t)[0] for v in views) / len(views)

        out = []
        for s in range(0, len(images), bs):
            imgs, t = images[s : s + bs], tab[s : s + bs]
            pad = bs - len(imgs)
            if pad:
                imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
                t = torch.cat([t, t[-1:].expand(pad, -1)])
            l = data_parallel_eval(self.group, score, imgs, t)
            out.append(l[: bs - pad])
        self.model.train(was_training)
        return torch.cat(out).cpu().numpy()  # the one device→host copy

    def fit_fold(self, images: torch.Tensor, tab_raw: np.ndarray, y: np.ndarray, p_soft: np.ndarray,
                 train_idx: np.ndarray, val_idx: np.ndarray, epochs: int | None = None, log=print) -> dict:
        """Train one fold from its start; → the best epoch's {"auc",
        "state" (``snapshot``), "T", "thr", "scaler"}, plus "history": per
        epoch its step losses (host numpy), val AUC, T and thr."""
        cfg = self.cfg
        dev = self.device
        epochs = epochs or cfg.epochs
        scaler = StandardScaler.fit(tab_raw[train_idx])
        tab = scaler.transform(tab_raw)
        tab_d = torch.as_tensor(tab, dtype=torch.float32, device=dev)
        y_d = torch.as_tensor(y.astype(np.float32), device=dev)
        p_d = torch.as_tensor(p_soft.astype(np.float32), device=dev)
        steps = max(len(train_idx) // cfg.batch_size, 1) * epochs
        self.init_state(steps)
        rng = np.random.default_rng(cfg.seed)
        val_d = torch.as_tensor(val_idx, device=dev)
        best, history = {"auc": -np.inf}, []
        grid = np.linspace(0.2, 0.8, 61)  # the JAX trainer's fixed grid (cfg.thr_grid is not read there)
        for ep in range(epochs):
            losses = []
            for bidx in epoch_batches(len(train_idx), cfg.batch_size, rng):
                sel = train_idx[bidx]
                if self.group is not None:  # this rank's rows: the randaug draws are per row
                    sel = sel[self.group.rows(len(sel))]
                sel_d = host_to_device(sel, dev)
                img = self._prep_train(images.index_select(0, sel_d), sel, ep)
                losses.append(self.train_step(img, tab_d[sel_d], y_d[sel_d], p_d[sel_d]))
            losses = torch.stack(losses).cpu().numpy()  # one device→host read an epoch
            # per-epoch temperature scaling on the val logits (:270-287)
            lv = self.logits(images.index_select(0, val_d), tab[val_idx], tta=False)
            ts = TemperatureScaler().fit(lv, y[val_idx])
            pv = 1 / (1 + np.exp(-lv / ts.temperature))
            auc = roc_auc(y[val_idx], pv)
            # F1 threshold sweep 0.2-0.8 × 61 (:290-295)
            sw = sweep_thresholds(y[val_idx], pv, grid)
            thr = float(grid[int(np.argmax(sw["f1"]))])
            log(f"[mm ep {ep}] loss {np.mean(losses):.4f} val_auc {auc:.4f} "
                f"T {ts.temperature:.3f} thr {thr:.3f}")
            history.append({"epoch": ep, "losses": losses, "val_auc": auc, "T": ts.temperature, "thr": thr})
            if auc > best["auc"]:
                best = {"auc": auc, "state": snapshot(self.model, self.opt), "T": ts.temperature,
                        "thr": thr, "scaler": scaler}
        best["history"] = history
        return best

    def predict_proba(self, fold: dict, images: torch.Tensor, tab_raw: np.ndarray) -> np.ndarray:
        """sigmoid(TTA logit / T) of ``fold`` (a ``fit_fold`` result, or
        {"state": {"model": state dict}, "T", "scaler"}); loads its weights
        into the trainer's model."""
        self.model.load_state_dict(fold["state"]["model"])
        tab = fold["scaler"].transform(tab_raw)
        l = self.logits(images, tab, tta=True)
        return 1 / (1 + np.exp(-l / fold["T"]))


def run_mm_kfold(
    images,
    table: Table,
    cfg: MMJointConfig = MMJointConfig(),
    outdir=None,
    epochs: int | None = None,
    save_ckpts: bool = False,
    log=print,
    device: str | torch.device | None = None,
    init: dict | None = None,
    dtype: torch.dtype = torch.bfloat16,
    group=None,
) -> dict:
    """The k-fold loop (train_mm_joint_dualtask.py:362-437) on ``device``
    (None: the card); with a data ``group`` (JAX's ``mesh=``) every rank
    runs it, the steps and evals divided (``MMTrainer``), and rank 0
    writes ``outdir``. ``images``: u8 [N, H, W, 3] aligned with ``table``'s
    rows (numpy, or a tensor already on the device), ``table`` with
    ``y_majority``, ``p_indirect``, the 9 base features, ``split``,
    ``origin_id`` and ``image_name``. Writes to ``outdir`` (when given)
    oof_val.csv and pred_test.csv (image_name, y, prob), summary.json and a
    ``fold_done`` record per fold in metrics.jsonl; with ``save_ckpts``,
    ``mm_dualtask_fold{k}.npz`` + ``.recipe.json`` (model_name, img_size,
    thr, T, scaler_mean, scaler_scale, fold). → {"summary", "oof", "test"}
    as the JAX package returns (Tables for its DataFrames), and "folds":
    each fold's ``fit_fold`` result."""
    from mmtrs_tpu_torch.models.convert import mm_joint_to_flax
    from mmtrs_tpu_torch.utils.checkpoint import save_npz_checkpoint
    from mmtrs_tpu_torch.utils.io import save_json
    from mmtrs_tpu_torch.utils.profiling import StructuredLogger
    from mmtrs_tpu_torch.utils.table import to_csv

    y = table["y_majority"].astype(int)
    p_soft = table["p_indirect"].astype(np.float32)
    tab_raw = np.stack([table[c] for c in BASE_FEATURES], axis=1).astype(np.float32)
    is_test = table["split"] == "test"
    tv = np.nonzero(~is_test)[0]
    te = np.nonzero(is_test)[0]

    trainer = MMTrainer(cfg, device=device, init=init, dtype=dtype, group=group)
    if group is not None and group.rank != 0:
        outdir = None
    # the dataset lives on the device for the whole run: a step's
    # images[sel] is a gather there, not a host copy
    images = device_put_dataset(images, trainer.device)
    te_d = torch.as_tensor(te, device=trainer.device)
    oof = np.full(len(tv), np.nan)
    test_probs, fold_summaries, folds = [], [], []
    mlog = StructuredLogger(Path(outdir) / "metrics.jsonl") if outdir is not None else None
    for fold, (tr_rel, va_rel) in enumerate(mm_fold_splits(table.take(tv), cfg.n_folds)):
        tr, va = tv[tr_rel], tv[va_rel]
        best = trainer.fit_fold(images, tab_raw, y, p_soft, tr, va, epochs, log)
        if mlog is not None:
            mlog.log("fold_done", fold=fold, val_auc=float(best["auc"]),
                     thr=float(best["thr"]), T=float(best["T"]))
        va_d = torch.as_tensor(va, device=trainer.device)
        oof[va_rel] = trainer.predict_proba(best, images.index_select(0, va_d), tab_raw[va])
        if len(te):
            test_probs.append(trainer.predict_proba(best, images.index_select(0, te_d), tab_raw[te]))
        fold_summaries.append(
            {"fold": fold, "val_auc": float(best["auc"]), "thr": best["thr"], "T": best["T"]}
        )
        if save_ckpts and outdir is not None:
            sd = {k: v.cpu() for k, v in best["state"]["model"].items()}
            save_npz_checkpoint(
                Path(outdir) / f"mm_dualtask_fold{fold}",
                mm_joint_to_flax(sd),
                recipe={
                    "model_name": cfg.model_name,
                    "img_size": cfg.img_size,
                    "thr": best["thr"],
                    "T": best["T"],
                    "scaler_mean": best["scaler"].mean.tolist(),
                    "scaler_scale": best["scaler"].scale.tolist(),
                    "fold": fold,
                },
            )
        folds.append(best)
        log(f"[mm fold {fold}] val_auc {best['auc']:.4f}")

    p_test = np.mean(test_probs, axis=0) if test_probs else np.zeros(0)
    summary = {
        "folds": fold_summaries,
        "mean_val_auc": float(np.mean([f["val_auc"] for f in fold_summaries])),
        "test_auc": roc_auc(y[te], p_test) if len(te) else None,
    }
    oof_t = Table({"image_name": table["image_name"][tv], "y": y[tv].astype(float), "prob": oof})
    test_t = Table({"image_name": table["image_name"][te], "y": y[te].astype(float), "prob": p_test})
    if outdir is not None:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        to_csv(oof_t, outdir / "oof_val.csv")
        to_csv(test_t, outdir / "pred_test.csv")
        save_json(summary, outdir / "summary.json")
    return {"summary": summary, "oof": oof_t, "test": test_t, "folds": folds}


def finalize_mm_from_ckpts(
    images,
    table: Table,
    ckpt_dir,
    cfg: MMJointConfig = MMJointConfig(),
    outdir=None,
    log=print,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """The finalized OOF and test predictions from saved fold checkpoints,
    without training (finalize_mm_dualtask_from_ckpts.py): the same
    GroupKFold as ``run_mm_kfold``, each fold's ``mm_dualtask_fold{k}.npz``
    with its recipe (scaler, T) read back, the 3-view TTA prediction; writes
    ``outdir``/finalized/oof_val.csv, pred_test.csv and summary.json. →
    {"summary", "oof", "test"} (Tables). On ``device`` (None: the card)."""
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax
    from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint
    from mmtrs_tpu_torch.utils.io import save_json
    from mmtrs_tpu_torch.utils.table import to_csv

    ckpt_dir = Path(ckpt_dir)
    y = table["y_majority"].astype(int)
    tab_raw = np.stack([table[c] for c in BASE_FEATURES], axis=1).astype(np.float32)
    is_test = table["split"] == "test"
    tv = np.nonzero(~is_test)[0]
    te = np.nonzero(is_test)[0]

    trainer = MMTrainer(cfg, device=device, dtype=dtype)
    images = device_put_dataset(images, trainer.device)
    te_d = torch.as_tensor(te, device=trainer.device)
    oof = np.full(len(tv), np.nan)
    test_probs = []
    for fold, (_, va_rel) in enumerate(mm_fold_splits(table.take(tv), cfg.n_folds)):
        va = tv[va_rel]
        tree, recipe = load_npz_checkpoint(ckpt_dir / f"mm_dualtask_fold{fold}")
        # the scaler as training fitted it: f32 statistics of the f32 features
        # (the JAX finalize reads them as float64, one rounding away)
        scaler = StandardScaler(mean=np.asarray(recipe["scaler_mean"], np.float32),
                                scale=np.asarray(recipe["scaler_scale"], np.float32))
        bundle = {"state": {"model": mm_joint_from_flax(tree)}, "T": recipe["T"], "scaler": scaler}
        va_d = torch.as_tensor(va, device=trainer.device)
        oof[va_rel] = trainer.predict_proba(bundle, images.index_select(0, va_d), tab_raw[va])
        if len(te):
            test_probs.append(trainer.predict_proba(bundle, images.index_select(0, te_d), tab_raw[te]))
        log(f"[finalize fold {fold}] T={recipe['T']:.3f}")

    p_test = np.mean(test_probs, axis=0) if test_probs else np.zeros(0)
    summary = {
        "oof_auc": roc_auc(y[tv], oof),
        "test_auc": roc_auc(y[te], p_test) if len(te) else None,
        "finalized_from": str(ckpt_dir),
    }
    oof_t = Table({"image_name": table["image_name"][tv], "y": y[tv].astype(float), "prob": oof})
    test_t = Table({"image_name": table["image_name"][te], "y": y[te].astype(float), "prob": p_test})
    if outdir is not None:
        fdir = Path(outdir) / "finalized"
        fdir.mkdir(parents=True, exist_ok=True)
        to_csv(oof_t, fdir / "oof_val.csv")
        to_csv(test_t, fdir / "pred_test.csv")
        save_json(summary, fdir / "summary.json")
    return {"summary": summary, "oof": oof_t, "test": test_t}
