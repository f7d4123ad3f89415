"""MIL attention trainer (port of mmtrs_tpu/train/mil.py; the reference's
train_mil_attention_v1.py).

GroupKFold on origin_id over the train+val rows; per step a bag of K
RandomResizedCrop instances of each image made on the device
(``models.mil.make_bags``, draws per (``cfg.seed + epoch``, origin_id));
BCE on the bag logit; optax's AdamW on the cosine schedule
(``train.common.make_optimizer``, no clip, as the JAX trainer); the best val
AUC (strictly greater) kept as a copy; prediction on the fixed eval bags
(seed 999, no flip) with the bag's W axis flipped as the second TTA view,
the mean logit → sigmoid; then oof_val.csv, pred_test.csv, summary.json
and, with ``save_ckpts``, ``mil_v1_fold{k}.npz`` + ``.recipe.json``, which
``serve.ensembles.MILEnsemble.from_folder`` serves.

Everything runs on the card unless the caller passes ``device="cpu"``. The
dataset moves there once; a step gathers its rows there. The host reads
the device once an epoch (the step losses) and once per ``predict_proba``;
otherwise it only sends batch indices and the bag draws it makes.
Dropout and drop-path bits come from the trainer's ``torch.Generator``
(seeded from ``cfg.seed`` at every fold's start), and the bag draws from
``BagDraws.draw``: neither are the JAX package's bits.

A fold starts from ``init`` (a ``MILNet`` state dict, as every JAX fold
starts from ``model.init(key(cfg.seed))``); without one, from a
Flax-default init drawn from ``torch.Generator().manual_seed(cfg.seed)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.config import MILConfig
from mmtrs_tpu_torch.data.splits import group_kfold
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.binary import roc_auc
from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
from mmtrs_tpu_torch.models.mil import BagDraws, MILNet, make_bags
from mmtrs_tpu_torch.train.common import (
    bce_logits,
    device_put_dataset,
    epoch_batches,
    host_to_device,
    make_optimizer,
    normalize_imagenet,
    snapshot,
)
from mmtrs_tpu_torch.utils.table import Table

EVAL_BAG_SEED = 999


class MILTrainer:
    def __init__(self, cfg: MILConfig = MILConfig(), device: str | torch.device | None = None,
                 init: dict | None = None, dtype: torch.dtype = torch.bfloat16,
                 drop_rate: float = 0.2, drop_path: float = 0.1):
        """``device`` None: the card. ``dtype`` is the encoder's compute
        type (bf16, as the JAX trainer's; the tests take f32). ``init``: the
        state dict every fold starts from. ``drop_rate``, ``drop_path``:
        the JAX module's rates by default (the tests set 0)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        model = MILNet(cfg.model_name, cfg.attn_dim, dtype=dtype, drop_rate=drop_rate, drop_path=drop_path)
        if init is None:
            init = lecun_init_(model, torch.Generator().manual_seed(cfg.seed)).state_dict()
        self._init = {k: v.detach().clone() for k, v in init.items()}
        self.model = model.to(self.device)
        self.model.load_state_dict(self._init)

    def init_state(self, total_steps: int) -> None:
        """Reset the model to the fold's start, a fresh optimiser for
        ``total_steps`` and the dropout generator."""
        cfg = self.cfg
        self.model.load_state_dict(self._init)
        self.model.train()
        self.opt = make_optimizer(self.model.parameters(), cfg.lr, cfg.weight_decay, total_steps)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _bags(self, imgs: torch.Tensor, seed: int, origin_ids, hflip_p: float) -> torch.Tensor:
        cfg = self.cfg
        d = BagDraws.draw(seed, origin_ids, cfg.bag_size, cfg.crop_scale, hflip_p=hflip_p).to(self.device)
        return normalize_imagenet(make_bags(imgs, d, cfg.img_size))

    def train_bags(self, imgs: torch.Tensor, seed: int, origin_ids) -> torch.Tensor:
        """Normalised training bags of a u8 batch on the device."""
        return self._bags(imgs, seed, origin_ids, 0.5)

    def eval_bags(self, imgs: torch.Tensor, origin_ids) -> torch.Tensor:
        """The fixed evaluation bags: seed 999, no flip."""
        return self._bags(imgs, EVAL_BAG_SEED, origin_ids, 0.0)

    def loss(self, bags: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The train-mode forward of prepared bags and its BCE: the step's
        first stage."""
        logit, _ = self.model(bags, generator=self.gen)
        return bce_logits(logit, y)

    def backward(self, loss: torch.Tensor) -> None:
        """The step's second stage; the third is ``self.opt.step()``."""
        self.opt.zero_grad()
        loss.backward()

    def train_step(self, bags: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step on prepared bags (on the device) → its loss, a device
        scalar (not read here)."""
        loss = self.loss(bags, y)
        self.backward(loss)
        self.opt.step()
        return loss.detach()

    def fit(self, images: torch.Tensor, y: np.ndarray, origin_ids: np.ndarray, train_idx: np.ndarray,
            val_idx: np.ndarray, epochs: int | None = None, log=print) -> tuple[dict, float]:
        """Train one fold from its start → (the best epoch's ``snapshot``,
        its val AUC). ``images``: u8 [N, H, W, 3] on the device."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        steps = max(len(train_idx) // cfg.batch_size, 1) * epochs
        self.init_state(steps)
        y_d = torch.as_tensor(y.astype(np.float32), device=self.device)
        rng = np.random.default_rng(cfg.seed)
        best_state, best_auc = snapshot(self.model, self.opt), -np.inf
        for ep in range(epochs):
            losses = []
            for bidx in epoch_batches(len(train_idx), cfg.batch_size, rng):
                sel = train_idx[bidx]
                sel_d = host_to_device(sel, self.device)
                bags = self.train_bags(images.index_select(0, sel_d), cfg.seed + ep, origin_ids[sel])
                losses.append(self.train_step(bags, y_d[sel_d]))
            losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)  # one read an epoch
            val_d = host_to_device(val_idx, self.device)
            p_val = self.predict_proba(None, images.index_select(0, val_d), origin_ids[val_idx])
            auc = roc_auc(y[val_idx], p_val)
            log(f"[mil ep {ep}] loss {np.mean(losses):.4f} val_auc {auc:.4f}")
            if auc > best_auc:
                best_state, best_auc = snapshot(self.model, self.opt), auc
        return best_state, best_auc

    @torch.no_grad()
    def predict_proba(self, state: dict | None, images: torch.Tensor, origin_ids,
                      tta: bool | None = None) -> np.ndarray:
        """sigmoid of the (hflip-TTA) mean logit on the eval bags, with
        ``state`` (a ``snapshot``; None: the model as it is) loaded. The
        last batch is padded by repeating its last image; the logits are
        copied to the host once."""
        cfg = self.cfg
        tta = cfg.tta_hflip if tta is None else tta
        if state is not None:
            self.model.load_state_dict(state["model"])
        was_training = self.model.training
        self.model.eval()
        origin_ids = np.asarray(origin_ids)
        bs = cfg.batch_size
        out = []
        for s in range(0, len(images), bs):
            imgs, oid = images[s : s + bs], origin_ids[s : s + bs]
            pad = bs - len(imgs)
            if pad:
                imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
                oid = np.concatenate([oid, np.repeat(oid[-1:], pad)])
            bags = self.eval_bags(imgs, oid)
            logit = self.model(bags)[0]
            if tta:
                logit = 0.5 * (logit + self.model(bags.flip(3))[0])
            out.append(logit[: bs - pad])
        self.model.train(was_training)
        if not out:
            return np.zeros(0, dtype=np.float32)
        host = torch.cat(out).cpu().numpy()  # the one device→host copy
        return 1 / (1 + np.exp(-host))


def run_mil_kfold(
    images,
    table: Table,
    cfg: MILConfig = MILConfig(),
    outdir=None,
    epochs: int | None = None,
    save_ckpts: bool = False,
    log=print,
    device: str | torch.device | None = None,
    init: dict | None = None,
    dtype: torch.dtype = torch.bfloat16,
    drop_rate: float = 0.2,
    drop_path: float = 0.1,
) -> dict:
    """The k-fold loop (train_mil_attention_v1.py:152-295) on ``device``
    (None: the card). ``images``: u8 [N, H, W, 3] aligned with ``table``'s
    rows (numpy, or a tensor already on the device); ``table`` with
    ``y_majority``, ``origin_id``, ``split`` and ``image_name``. Writes to
    ``outdir`` oof_val.csv and pred_test.csv (image_name, y, prob) and
    summary.json; with ``save_ckpts``, ``mil_v1_fold{k}.npz`` +
    ``.recipe.json`` (model_name, attn_dim, img_size, bag_size, fold).
    → {"summary", "oof", "test"} (Tables) and "states": each fold's best
    snapshot."""
    from mmtrs_tpu_torch.models.convert import milnet_to_flax
    from mmtrs_tpu_torch.utils.checkpoint import save_npz_checkpoint
    from mmtrs_tpu_torch.utils.io import save_json
    from mmtrs_tpu_torch.utils.table import to_csv

    y = table["y_majority"].astype(int)
    origin = np.asarray(table["origin_id"])
    is_test = table["split"] == "test"
    tv = np.nonzero(~is_test)[0]
    te = np.nonzero(is_test)[0]

    trainer = MILTrainer(cfg, device=device, init=init, dtype=dtype, drop_rate=drop_rate, drop_path=drop_path)
    dev = trainer.device
    images = device_put_dataset(images, dev)
    te_d = torch.as_tensor(te, device=dev)
    oof = np.full(len(tv), np.nan)
    test_probs, fold_aucs, states = [], [], []
    for fold, (tr_rel, va_rel) in enumerate(group_kfold(origin[tv], cfg.n_folds)):
        tr, va = tv[tr_rel], tv[va_rel]
        state, val_auc = trainer.fit(images, y, origin, tr, va, epochs=epochs, log=log)
        va_d = torch.as_tensor(va, device=dev)
        oof[va_rel] = trainer.predict_proba(state, images.index_select(0, va_d), origin[va])
        if len(te):
            test_probs.append(trainer.predict_proba(state, images.index_select(0, te_d), origin[te]))
        fold_aucs.append(val_auc)
        states.append(state)
        if save_ckpts and outdir is not None:
            sd = {k: v.cpu() for k, v in state["model"].items()}
            save_npz_checkpoint(
                Path(outdir) / f"mil_v1_fold{fold}",
                milnet_to_flax(sd),
                recipe={"model_name": cfg.model_name, "attn_dim": cfg.attn_dim,
                        "img_size": cfg.img_size, "bag_size": cfg.bag_size, "fold": fold},
            )
        log(f"[mil fold {fold}] val_auc {val_auc:.4f}")

    p_test = np.mean(test_probs, axis=0) if test_probs else np.zeros(0)
    summary = {
        "folds": [{"fold": i, "val_auc": float(a)} for i, a in enumerate(fold_aucs)],
        "mean_val_auc": float(np.mean(fold_aucs)),
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
    return {"summary": summary, "oof": oof_t, "test": test_t, "states": states}
