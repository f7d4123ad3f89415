"""Vision trainers (port of mmtrs_tpu/train/vision.py): hard (2-class CE)
and soft (weighted BCE on p_indirect).

Parity targets of the JAX package:
- models/vision/train_hard.py: the weighted sampler, CE with label smoothing
  and class-balanced weights, AdamW on the cosine schedule, the best val
  loss kept, hflip TTA, the F1 threshold grid;
- models/vision/train_soft.py: one logit, BCE on p_indirect weighted by the
  consensus weight;
- experiments/vision_v2/train_hard_v2.py: the head bias at the class prior,
  warmup, and the seed ensemble (``ensemble_predict``: logit mean with NaN
  repair).

Everything runs on the card unless the caller passes ``device="cpu"``. The
datasets move there once; a step gathers its rows there and augments them
there (``ops.augment.augment_batch``, kernels K1-K7 as the preset draws
them), from draws made on the host per (seed + epoch, origin_id, aug_idx)
lineage (``ops.augment.draw_batch``; not the JAX package's threefry bits).
Batch order and sampler indices come from ``np.random.default_rng(cfg.seed)``
with the JAX package's calls, so both packages see the same batches.
The host reads the device once an epoch (the step losses) and once per
``predict_proba``. Dropout and drop-path bits come from the trainer's own
``torch.Generator`` (seeded from ``cfg.seed`` by ``init_state``).

A state is ``{"model": state dict}`` (``train.common.snapshot``): the
trainer's model and optimiser hold the live one. ``fit`` keeps the epoch of
least val loss; its ``imgs_per_sec`` is each epoch's images over the host
time from its first batch's prep to the read of its losses (the JAX trainer
times its steps alone, a sync after each). The hflip TTA of
``predict_proba`` averages probabilities over the views (the JAX package's
``vision.py:206-238``), while ``ensemble_predict`` averages logits over
members.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mmtrs_tpu_torch.config import VisionTrainConfig
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.binary import binary_report, roc_auc
from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds, threshold_grid
from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
from mmtrs_tpu_torch.models.backbones.factory import create_model
from mmtrs_tpu_torch.models.convert import merge_pretrained
from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch
from mmtrs_tpu_torch.ops.resize import resize_bilinear
from mmtrs_tpu_torch.parallel.mesh import data_parallel_eval, replicate, sharded
from mmtrs_tpu_torch.train.common import (
    Throughput,
    average_grads,
    bce_logits,
    ce_two_class,
    device_put_dataset,
    epoch_batches,
    host_to_device,
    make_optimizer,
    normalize_imagenet,
    snapshot,
    weighted_sampler_indices,
)


@dataclass
class VisionData:
    """A dataset: u8 images [N, H, W, 3] (numpy, or a tensor) and per-row
    metadata (numpy)."""

    images: np.ndarray | torch.Tensor
    y: np.ndarray  # hard labels
    p: np.ndarray | None = None  # soft targets
    w: np.ndarray | None = None  # consensus weights
    origin_id: np.ndarray | None = None
    aug_idx: np.ndarray | None = None

    def __len__(self):
        return len(self.images)


class VisionTrainer:
    def __init__(self, cfg: VisionTrainConfig, aug_preset: str = "none", device: str | torch.device | None = None,
                 init: dict | None = None, group=None):
        """``device`` None: the card. The backbone computes in bf16 when
        ``cfg.bf16``, else f32. ``init``: the state dict ``init_state``
        starts from (the JAX trainer's ``model.init(key(cfg.seed))``);
        without one, a Flax-default init drawn from
        ``torch.Generator().manual_seed(cfg.seed)``. ``group``: a
        ``parallel.mesh.DataGroup`` (JAX's ``mesh=``): each rank preps and
        steps on its rows of every batch (the draws are per lineage) and
        scores its shard of every eval batch; the steps are the
        one-process steps on the whole batch."""
        self.cfg = cfg
        self.group = group
        if group is not None and cfg.batch_size % group.size != 0:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by the group's size {group.size}")
        self.aug_preset = aug_preset
        self.device = resolve_device(device)
        model = create_model(cfg.model_name, num_classes=2 if cfg.task == "hard" else 1, drop_rate=cfg.drop_rate,
                             drop_path=cfg.drop_path, dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
        if init is None:
            init = lecun_init_(model, torch.Generator().manual_seed(cfg.seed)).state_dict()
        self._init = {k: v.detach().clone() for k, v in init.items()}
        self.model = model.to(self.device)
        self.model.load_state_dict(self._init)
        self.opt = None

    # -- setup -------------------------------------------------------------

    def init_state(self, total_steps: int, head_bias: float = 0.0, pretrained: dict | None = None) -> dict:
        """Reset the model to its start, its classifier bias to
        ``head_bias`` (when not 0; for ``hard`` both logits move by it), a
        fresh optimiser for ``total_steps`` (with ``cfg.warmup_steps``) and
        the dropout generator; → the start state. ``pretrained``: backbone
        weights (port names, e.g. ``models.convert.vision_from_flax`` of a
        converted checkpoint) merged over the start, the head kept; a leaf
        that does not fit raises."""
        cfg = self.cfg
        sd = self._init if pretrained is None else merge_pretrained(self._init, pretrained)
        self.model.load_state_dict(sd)
        if head_bias:
            with torch.no_grad():
                self.model.classifier.bias.fill_(head_bias)
        if self.group is not None:
            replicate(self.group, self.model)
        self.model.train()
        self.opt = make_optimizer(self.model.parameters(), cfg.lr, cfg.weight_decay, total_steps,
                                  warmup_steps=cfg.warmup_steps)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        return snapshot(self.model)

    def train_step(self, x: torch.Tensor, y: torch.Tensor, p: torch.Tensor | None = None,
                   w: torch.Tensor | None = None, class_weights: torch.Tensor | None = None) -> torch.Tensor:
        """One step on a prepared batch (all on the device): the train-mode
        forward, its loss in f32 (``hard``: CE with ``cfg.label_smoothing``
        and ``class_weights``; ``soft``: BCE of the one logit on ``p``
        weighted by ``w``), backward and AdamW → the loss, a device scalar
        (not read here). With a group: the rank's rows, the weight sum and
        the gradients over the group, the global batch's loss."""
        with sharded(self.group):
            out = self.model(x, generator=self.gen)
        if self.cfg.task == "hard":
            loss = ce_two_class(out, y, self.cfg.label_smoothing, class_weights)
        else:
            loss = bce_logits(out[..., 0], p, w, self.group)
        self.opt.zero_grad()
        loss.backward()
        loss = average_grads(self.opt.params, self.group, loss)
        self.opt.step()
        return loss

    # -- batch prep ----------------------------------------------------------

    def _draws(self, seed: int, origin_ids, aug_idxs, H: int, W: int, aug_idx):
        """The host draws of the batch's lineages for ``aug_preset``."""
        return draw_batch(self.aug_preset, seed, origin_ids, aug_idxs, H, W, aug_idx=aug_idx, img_size=H)

    def _prep_images(self, imgs: torch.Tensor, train: bool, seed: int, origin_ids=None, aug_idxs=None) -> torch.Tensor:
        """u8 [B, H, W, 3] on the device → the model's input: in training
        ``aug_preset`` on the u8 batch (its draws per (seed, origin_id,
        aug_idx); origin ids default to the batch rows, aug indices to 0),
        then f32, resize to ``cfg.img_size`` and ImageNet normalisation."""
        x = imgs
        if train and self.aug_preset != "none":
            n, H, W = int(x.shape[0]), int(x.shape[1]), int(x.shape[2])
            oids = np.arange(n) if origin_ids is None else np.asarray(origin_ids)
            aids = np.zeros(n, np.int64) if aug_idxs is None else np.asarray(aug_idxs)
            draws = self._draws(seed, [int(o) for o in oids], [int(a) for a in aids], H, W, aug_idxs)
            x = augment_batch(x, draws, self.aug_preset, aug_idx=aug_idxs, img_size=H)
        x = x.float()
        if x.shape[1] != self.cfg.img_size:
            x = resize_bilinear(x, (self.cfg.img_size, self.cfg.img_size))
        return normalize_imagenet(x)

    # -- training ------------------------------------------------------------

    def fit(self, train: VisionData, val: VisionData, epochs: int | None = None, state: dict | None = None,
            log=print) -> tuple[dict, list]:
        """Train from ``state`` (None: ``init_state`` with the head bias at
        log(prior / (1 − prior)) of the train labels for ``hard``; a state
        is loaded into the model and trained with the optimiser that the
        last ``init_state`` made); → (the state of least val loss, the
        history: per epoch train_loss, the val loss/auc/acc/f1 and
        imgs_per_sec)."""
        cfg = self.cfg
        dev = self.device
        epochs = epochs or cfg.epochs
        images = device_put_dataset(train.images, dev)
        val = dataclasses.replace(val, images=device_put_dataset(val.images, dev))
        n = len(train)
        steps_per_epoch = max(n // cfg.batch_size, 1)
        if state is None:
            prior = float(np.clip(train.y.mean(), 1e-3, 1 - 1e-3))
            head_bias = float(np.log(prior / (1 - prior))) if cfg.task == "hard" else 0.0
            state = self.init_state(steps_per_epoch * epochs, head_bias=head_bias)
        elif self.opt is None:
            raise ValueError("fit(state=...) trains with the optimiser of init_state: call it first")
        else:
            self.model.load_state_dict(state["model"])

        rng = np.random.default_rng(cfg.seed)
        class_weights = None
        if cfg.task == "hard":
            counts = np.bincount(train.y.astype(int), minlength=2)
            cw = counts.sum() / (2.0 * np.maximum(counts, 1))
            class_weights = torch.as_tensor(cw, dtype=torch.float32, device=dev)
        to_dev = lambda a, dt: None if a is None else torch.as_tensor(np.asarray(a).astype(dt), device=dev)
        y_d, p_d, w_d = to_dev(train.y, np.int64), to_dev(train.p, np.float32), to_dev(train.w, np.float32)

        best = {"val_loss": np.inf, "val_auc": -np.inf, "state": state, "epoch": -1}
        tp = Throughput()
        history = []
        for ep in range(epochs):
            idx_stream = (weighted_sampler_indices(train.y, steps_per_epoch * cfg.batch_size, rng)
                          if cfg.task == "hard" else None)
            self.model.train()
            losses, seen = [], 0
            tp.start()
            for bidx in epoch_batches(n, cfg.batch_size, rng, indices=idx_stream, drop_last=True):
                sel, oids = bidx, None if train.origin_id is None else train.origin_id[bidx]
                if self.group is not None:  # this rank's rows, each with its batch position's lineage
                    rows = self.group.rows(len(bidx))
                    sel, oids = bidx[rows], np.arange(len(bidx))[rows] if oids is None else oids[rows]
                b_d = host_to_device(sel, dev)
                x = self._prep_images(
                    images.index_select(0, b_d), True, cfg.seed + ep, oids,
                    None if train.aug_idx is None else train.aug_idx[sel],
                )
                take = lambda t: None if t is None else t[b_d]
                losses.append(self.train_step(x, y_d[b_d], take(p_d), take(w_d), class_weights))
                seen += len(bidx)
            losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)  # one read an epoch
            tp.stop(seen)
            val_metrics = self.evaluate(None, val, tta=False)
            history.append({"epoch": ep, "train_loss": float(np.mean(losses)), **val_metrics,
                            "imgs_per_sec": tp.imgs_per_sec})
            log(f"[ep {ep}] loss {np.mean(losses):.4f} "
                f"val_loss {val_metrics['loss']:.4f} val_auc {val_metrics['auc']:.4f} "
                f"({tp.imgs_per_sec:.1f} imgs/s)")
            if val_metrics["loss"] < best["val_loss"]:
                best = {"val_loss": val_metrics["loss"], "val_auc": val_metrics["auc"],
                        "state": snapshot(self.model), "epoch": ep}
        return best["state"], history

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def predict_proba(self, state: dict | None, data: VisionData, tta: bool | None = None,
                      batch_size: int = 0) -> np.ndarray:
        """P(class 1) per row of ``data`` with ``state`` loaded into the
        model (None: the model as it is), in eval mode; with ``tta`` (None:
        ``cfg.tta_hflip``) the mean of the probabilities of the image and its
        W-flip. The last batch is padded by repeating its last row; with a
        group each rank scores its shard of a batch, gathered in rank order
        (``data_parallel_eval``). The logits are copied to the host once."""
        cfg = self.cfg
        tta = cfg.tta_hflip if tta is None else tta
        bs = batch_size or cfg.batch_size
        if state is not None:
            self.model.load_state_dict(state["model"])
        images = device_put_dataset(data.images, self.device)
        was_training = self.model.training
        self.model.eval()

        def score(imgs):
            x = self._prep_images(imgs, False, 0)
            views = [x, x.flip(2)] if tta else [x]
            return torch.stack([self.model(v) for v in views], dim=1)  # [b, views, out]

        outs, pads = [], []
        for s in range(0, len(images), bs):
            imgs = images[s : s + bs]
            pad = bs - len(imgs)
            if pad:
                imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
            outs.append(data_parallel_eval(self.group, score, imgs).transpose(0, 1))
            pads.append(pad)
        self.model.train(was_training)
        host = torch.cat(outs, dim=1).float().cpu().numpy()  # the one device→host copy
        out, ofs = [], 0
        for pad in pads:
            ls = host[:, ofs : ofs + bs]
            p = np.mean([self._to_prob(l) for l in ls], axis=0)
            out.append(p[: bs - pad])
            ofs += bs
        return np.concatenate(out)

    def _to_prob(self, out: np.ndarray) -> np.ndarray:
        if self.cfg.task == "hard":
            e = np.exp(out - out.max(axis=-1, keepdims=True))
            return (e / e.sum(-1, keepdims=True))[:, 1]
        return 1.0 / (1.0 + np.exp(-out[..., 0]))

    def evaluate(self, state: dict | None, data: VisionData, tta: bool = False) -> dict:
        p = self.predict_proba(state, data, tta=tta)
        y = data.y.astype(int)
        rep = binary_report(y, p, 0.5)
        # val loss proxy for checkpoint selection
        eps = 1e-7
        pc = np.clip(p, eps, 1 - eps)
        loss = float(-np.mean(y * np.log(pc) + (1 - y) * np.log(1 - pc)))
        return {"loss": loss, "auc": rep["auc"], "acc": rep["acc"], "f1": rep["f1"]}

    def tune_threshold_f1(self, state: dict | None, val: VisionData) -> float:
        """F1 grid on val applied to test (train_hard.py:131-139,224-243)."""
        p = self.predict_proba(state, val)
        ts = threshold_grid("fusion")
        s = sweep_thresholds(val.y.astype(int), p, ts)
        return float(ts[int(np.argmax(s["f1"]))])


def ensemble_predict(trainer: VisionTrainer, states: list, data: VisionData, tta: bool = True) -> np.ndarray:
    """Seed ensemble: the logit mean over members of their (TTA)
    probabilities clipped to [1e-7, 1 − 1e-7], NaN set to 0, then the
    sigmoid (ensemble_hard.py:68-97,200-205)."""
    logits = []
    for st in states:
        p = trainer.predict_proba(st, data, tta=tta)
        p = np.clip(p, 1e-7, 1 - 1e-7)
        logits.append(np.log(p / (1 - p)))
    m = np.mean(logits, axis=0)
    m = np.nan_to_num(m, nan=0.0)  # NaN repair
    return 1.0 / (1.0 + np.exp(-m))


def per_model_aucs(trainer: VisionTrainer, states: list, data: VisionData, tta: bool = True) -> list[float]:
    """Per-member AUC, to spot a bad seed before it drags the ensemble
    (ensemble_hard.py:122-137)."""
    return [roc_auc(data.y, trainer.predict_proba(st, data, tta=tta)) for st in states]
