"""Base-prediction stream collection (port of mmtrs_tpu/fusion/streams.py;
the reference's src/fusion/prepare_streams.py).

``collect_base_preds``: for the val and test frames, a probability array per
stream from whatever models are found on disk: the vision hard and soft
checkpoints (``vision_{task}_best.npz`` + ``.recipe.json``, as
``cli.run_train_images`` writes them, or as scripts/export_npz_checkpoints.py
exports the JAX package's) and the tabular forests (``xgb_forest`` /
``lgbm_forest`` .npz + .json). Model discovery is the reference's globbing
(``_find_model`` :46-55): the first match of a list of patterns.

The reference's graceful-None contract (:134-137, :173-176) holds for what
fails at load time: a recipe without its payload, a model the factory does
not know, a forest whose files do not parse; that stream is None and is
masked out downstream. Prediction is not wrapped: an error while a loaded
model predicts (a CUDA or kernel error) propagates.

Everything runs on ``device`` (None: the card).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.data.features import features_to_array
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.utils.table import Table


def find_model(root: str | Path, patterns: list[str]) -> Path | None:
    root = Path(root)
    if not root.exists():
        return None
    for pat in patterns:
        hits = sorted(root.glob(pat))
        if hits:
            return hits[0]
    return None


def _load_vision_ckpt(ckpt_base: Path, device: torch.device):
    """(trainer, state) of a vision checkpoint and its recipe (f32, as the
    JAX package's ``bf16=False``), or None when it cannot be loaded."""
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.models.backbones.factory import create_model
    from mmtrs_tpu_torch.models.convert import vision_from_flax
    from mmtrs_tpu_torch.train.vision import VisionTrainer
    from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint

    try:  # load-time failures only: a missing payload, an unknown model, a tree that does not fit
        tree, recipe = load_npz_checkpoint(ckpt_base)
        if recipe is None:
            return None
        cfg = VisionTrainConfig(model_name=recipe["model_name"], img_size=int(recipe["img_size"]),
                                task=recipe.get("task", "hard"), bf16=False)
        sd = vision_from_flax(tree, cfg.model_name)
        create_model(cfg.model_name, num_classes=2 if cfg.task == "hard" else 1).load_state_dict(sd, strict=True)
    except Exception:
        return None
    trainer = VisionTrainer(cfg, device=device, init=sd)
    return trainer, {"model": trainer.model.state_dict()}


def _predict_vision_ckpt(ckpt_base: Path, images, device: str | torch.device | None = None) -> np.ndarray | None:
    """Load a vision checkpoint through its recipe and batch-predict
    ``images`` (u8 [N, H, W, 3]) with its hflip TTA; None when it cannot be
    loaded."""
    from mmtrs_tpu_torch.train.vision import VisionData

    loaded = _load_vision_ckpt(Path(ckpt_base), resolve_device(device))
    if loaded is None:
        return None
    trainer, state = loaded
    return trainer.predict_proba(state, VisionData(images=images, y=np.zeros(len(images))))


def _predict_tab_forest(forest_base: Path, table: Table, device: str | torch.device | None = None) -> np.ndarray | None:
    from mmtrs_tpu_torch.models.gbdt import Forest, predict_proba

    dev = resolve_device(device)
    try:
        f = Forest.load(forest_base, device="cpu")
    except Exception:  # corrupt or partial forest files
        return None
    X = features_to_array(table)  # the 16 engineered columns, f32
    return predict_proba(f.to(dev), X).cpu().numpy()


def collect_base_preds(
    df_val: Table,
    df_test: Table,
    images_val,
    images_test,
    weight_dir: str | Path = "weights",
    ml_dir: str | Path = "models/outputs",
    device: str | torch.device | None = None,
) -> dict:
    """→ {"val": {...}, "test": {...}} with the streams v_hard, v_soft,
    xgb and lgbm (each an array or None)."""
    weight_dir, ml_dir = Path(weight_dir), Path(ml_dir)
    out = {"val": {}, "test": {}}

    vision = {
        "v_hard": find_model(weight_dir, ["vision_hard_best.recipe.json", "**/vision_hard_best.recipe.json"]),
        "v_soft": find_model(weight_dir, ["vision_soft_best.recipe.json", "**/vision_soft_best.recipe.json"]),
    }
    for k, rp in vision.items():
        if rp is None or images_val is None or images_test is None:
            out["val"][k] = out["test"][k] = None
            continue
        base = Path(str(rp)[: -len(".recipe.json")])
        out["val"][k] = _predict_vision_ckpt(base, images_val, device)
        out["test"][k] = _predict_vision_ckpt(base, images_test, device)

    tab = {
        "xgb": find_model(ml_dir, ["xgb_forest.npz", "**/xgb_forest.npz"]),
        "lgbm": find_model(ml_dir, ["lgbm_forest.npz", "**/lgbm_forest.npz"]),
    }
    for k, fp in tab.items():
        if fp is None:
            out["val"][k] = out["test"][k] = None
            continue
        base = fp.with_suffix("")
        out["val"][k] = _predict_tab_forest(base, df_val, device)
        out["test"][k] = _predict_tab_forest(base, df_test, device)
    return out
