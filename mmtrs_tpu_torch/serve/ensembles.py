"""Serving-side fold ensembles (port of mmtrs_tpu/serve/ensembles.py).

- :class:`MMEnsemble` (infer_mm.py:19-109): per fold a MMJointDualHead with
  its scaler statistics and temperature; the image resized to the fold's
  ``img_size`` when its height differs, 3 TTA views (as is, flipped along
  W, flipped along H) in one batch; tab-absent → the scaler means → a zero
  standardised vector; the [F, 3] logits copied to the host once, then in
  float64 the view mean, ÷T, sigmoid, fold mean;
- :class:`MILEnsemble` (infer_mil.py:116-158): one bag from all processed
  images of a case (resize 512 → centre-crop 480), fold-mean logit →
  sigmoid;
- :class:`TabEnsemble` (tab_model.py:19-122): the ``tab_fold*`` forests'
  mean probability on the 16 engineered features;
- :func:`build_service_from_weights`: the three streams and the Stacker
  from a weights folder (``mm_dualtask_v1/``, ``mil_v1/``, ``tab_v1/``, each
  optional).

Model checkpoints are ``<base>.npz`` beside the JAX package's
``<base>.recipe.json`` (utils/checkpoint.py; scripts/export_npz_checkpoints.py
writes them from Orbax checkpoints). Each fold keeps its own copy of the net
on the device, loaded once. Everything runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.data.features import engineer_features
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.models.convert import milnet_from_flax, mm_joint_from_flax
from mmtrs_tpu_torch.models.gbdt import Forest, predict_proba
from mmtrs_tpu_torch.models.mil import MILNet, make_eval_bag
from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
from mmtrs_tpu_torch.ops.resize import resize_bilinear
from mmtrs_tpu_torch.serve.service import PredictService, Stacker, read_oof_csv
from mmtrs_tpu_torch.train.common import normalize_imagenet
from mmtrs_tpu_torch.train.tabular import load_tab_ensemble
from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint


def _fold_nets(state_dicts: list[dict], model: torch.nn.Module, dev: torch.device) -> list:
    nets = []
    for sd in state_dicts:
        net = copy.deepcopy(model)
        net.load_state_dict(sd)
        nets.append(net.to(dev).eval())
    return nets


def _checkpoints(folder: str | Path, pattern: str):
    """(variables, recipe) of every ``pattern`` checkpoint in ``folder``, in
    name order; a recipe whose npz is missing or unreadable raises."""
    for rp in sorted(Path(folder).glob(pattern + ".recipe.json")):
        yield load_npz_checkpoint(str(rp)[: -len(".recipe.json")])


class MMEnsemble:
    def __init__(self, folds: list[dict], model: MMJointDualHead,
                 device: str | torch.device | None = None):
        """folds: each {"state_dict", "T", "mean", "scale", "img_size"};
        ``model`` is the architecture. Each fold gets its own copy of it on
        ``device`` (None: the card)."""
        self.device = resolve_device(device)
        self.folds = folds
        self.nets = _fold_nets([f["state_dict"] for f in folds], model, self.device)

    @staticmethod
    def from_folder(folder: str | Path, pattern: str = "mm_dualtask_fold*",
                    device: str | torch.device | None = None) -> "MMEnsemble | None":
        folds, model = [], None
        for variables, recipe in _checkpoints(folder, pattern):
            if model is None:
                model = MMJointDualHead(model_name=recipe["model_name"])
            folds.append({
                "state_dict": mm_joint_from_flax(variables),
                "T": float(recipe["T"]),
                "mean": np.asarray(recipe["scaler_mean"], np.float32),
                "scale": np.asarray(recipe["scaler_scale"], np.float32),
                "img_size": int(recipe["img_size"]),
            })
        return MMEnsemble(folds, model, device) if folds else None

    @torch.no_grad()
    def predict(self, img: np.ndarray, tab9: list[float] | None) -> float:
        """img: one processed image [H, W, 3] 0..255; tab9: 9 raw features or
        None (→ scaler means → zero standardised vector, infer_mm.py:75-83)."""
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device).float()[None]
        views = {}  # one batch of 3 views per img_size, shared by the folds
        tabs = []
        for f in self.folds:
            s = f["img_size"]
            if s not in views:
                v = resize_bilinear(x, (s, s)) if x.shape[1] != s else x
                v = normalize_imagenet(v)
                views[s] = torch.cat([v, v.flip(2), v.flip(1)])
            raw = np.asarray(tab9, np.float32) if tab9 is not None else f["mean"]
            tabs.append(np.tile((raw - f["mean"]) / f["scale"], (3, 1)))
        tabs = torch.from_numpy(np.stack(tabs)).to(self.device)  # [F, 3, 9], one copy
        logits = torch.stack([
            net(views[f["img_size"]], t)[0] for net, f, t in zip(self.nets, self.folds, tabs)
        ])
        logits = logits.double().cpu().numpy()  # [F, 3], one copy to the host
        Ts = np.asarray([f["T"] for f in self.folds])
        with np.errstate(over="ignore"):  # exp(+large) → inf → p = 0, as intended
            probs = 1.0 / (1.0 + np.exp(-logits.mean(axis=1) / Ts))
        return float(probs.mean())


class MILEnsemble:
    def __init__(self, folds: list[dict], model: MILNet, crop_size: int = 480,
                 device: str | torch.device | None = None):
        """folds: one ``MILNet`` state dict per fold; ``model`` is the
        architecture. Each fold gets its own copy of it on ``device`` (None:
        the card)."""
        self.device = resolve_device(device)
        self.nets = _fold_nets(folds, model, self.device)
        self.crop_size = crop_size

    @staticmethod
    def from_folder(folder: str | Path, pattern: str = "mil_v1_fold*",
                    device: str | torch.device | None = None) -> "MILEnsemble | None":
        """The recipe's model_name and attn_dim build the net; its img_size
        is a training setting (the serving crop stays 480)."""
        folds, model = [], None
        for variables, recipe in _checkpoints(folder, pattern):
            if model is None:
                model = MILNet(recipe.get("model_name", "efficientnet_b0"),
                               attn_dim=recipe.get("attn_dim", 128))
            folds.append(milnet_from_flax(variables))
        return MILEnsemble(folds, model, device=device) if folds else None

    @torch.no_grad()
    def predict(self, imgs: np.ndarray) -> float:
        """imgs: all processed images of the case [N, H, W, 3] (one bag,
        infer_mil.py:116-149); accepts a single [H, W, 3] too."""
        if imgs.ndim == 3:
            imgs = imgs[None]
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        bag = normalize_imagenet(make_eval_bag(x, self.crop_size))[None]  # [1, N, h, w, 3]
        logits = [net(bag)[0][0] for net in self.nets]
        logit = torch.stack(logits).double().mean().item()  # one copy to the host
        return float(1.0 / (1.0 + np.exp(-logit)))


class TabEnsemble:
    def __init__(self, forests: list[Forest], device: str | torch.device | None = None):
        """The forests' mean probability, on ``device`` (None: the card); a
        forest that lies elsewhere is moved there."""
        self.device = resolve_device(device)
        self.forests = [f.to(self.device) for f in forests]

    @staticmethod
    def from_folder(folder: str | Path,
                    device: str | torch.device | None = None) -> "TabEnsemble | None":
        dev = resolve_device(device)
        folder = Path(folder)
        if not folder.exists():
            return None
        forests = load_tab_ensemble(folder, dev)
        return TabEnsemble(forests, dev) if forests else None

    @torch.no_grad()
    def predict_one(self, tab9: list[float]) -> float:
        x = engineer_features(torch.tensor(tab9, dtype=torch.float32, device=self.device)[None])
        p = torch.stack([predict_proba(f, x)[0] for f in self.forests])
        return float(p.mean().item())  # one copy to the host


def build_service_from_weights(
    weights_dir: str | Path,
    results_dir: str | Path = "results/stack_v2",
    legacy_blend: bool = False,
    device: str | torch.device | None = None,
):
    """Wire a PredictService from a weights folder laid out as the
    reference's (weights/mm_dualtask_v1, weights/mil_v1, weights/tab_v1);
    every stream is optional, and the Stacker is fitted when both image
    streams' oof_val.csv exist. Runs on ``device`` (None: the card).
    ``results_dir`` is accepted only so that the signature matches the JAX
    package's; nothing reads it."""
    dev = resolve_device(device)
    weights_dir = Path(weights_dir)
    mm = MMEnsemble.from_folder(weights_dir / "mm_dualtask_v1", device=dev)
    mil = MILEnsemble.from_folder(weights_dir / "mil_v1", device=dev)
    tab = TabEnsemble.from_folder(weights_dir / "tab_v1", device=dev)

    stacker = None
    mm_oof = weights_dir / "mm_dualtask_v1" / "oof_val.csv"
    mil_oof = weights_dir / "mil_v1" / "oof_val.csv"
    if mm_oof.exists() and mil_oof.exists():
        stacker = Stacker.fit(read_oof_csv(mm_oof), read_oof_csv(mil_oof), device=dev)

    return PredictService(
        mm_predict=mm.predict if mm else None,
        mil_predict=mil.predict if mil else None,
        tab_predict=tab.predict_one if tab else None,
        stacker=stacker,
        legacy_blend=legacy_blend,
        device=dev,
    )
