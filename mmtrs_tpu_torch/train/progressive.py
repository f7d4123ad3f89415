"""Progressive multi-seed hard trainer (port of mmtrs_tpu/train/progressive.py;
the reference's train_hard_v2.py).

Stages 384 → 512 with their own epochs, batch size and learning rate; stage
N + 1 starts from stage N's best parameters and BatchNorm statistics
(:229-232) with a fresh AdamW for its own steps, the warmup only in stage 0
(:120-129); the head bias at the class prior (:93-117), class-balanced CE
with label smoothing 0.10, and one member per seed (:212), whose logit mean
with hflip TTA is the ensemble (ensemble_hard.py). Each stage builds its own
``VisionTrainer`` on ``device`` (None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from mmtrs_tpu_torch.config import ProgressiveConfig, VisionTrainConfig
from mmtrs_tpu_torch.train.vision import VisionData, VisionTrainer, ensemble_predict


def train_progressive(
    cfg: ProgressiveConfig,
    train: VisionData,
    val: VisionData,
    aug_preset: str = "none",
    log=print,
    device: str | torch.device | None = None,
    inits: dict | None = None,
    group=None,
) -> list:
    """→ one (trainer, best state) per seed, each trained through all
    stages. ``inits``: {seed: state dict} that each seed's first stage starts
    from (the JAX trainer's ``model.init(key(seed))``); without it, the
    trainer's seeded init. ``group``: a ``parallel.mesh.DataGroup`` (JAX's
    ``mesh=``) that every stage's trainer steps and evaluates over."""
    states = []
    prior = float(np.clip(train.y.mean(), 1e-3, 1 - 1e-3))
    head_bias = float(np.log(prior / (1 - prior)))
    for seed in cfg.seeds:
        state = None
        trainer = None
        for si, stage in enumerate(cfg.stages):
            vcfg = VisionTrainConfig(
                model_name=cfg.model_name,
                img_size=stage.img_size,
                task="hard",
                epochs=stage.epochs,
                batch_size=stage.batch_size,
                lr=stage.lr,
                label_smoothing=cfg.label_smoothing,
                warmup_steps=cfg.warmup_steps if si == 0 else 0,
                seed=seed,
            )
            init = inits.get(seed) if inits is not None and si == 0 else None
            trainer = VisionTrainer(vcfg, aug_preset=aug_preset, device=device, init=init, group=group)
            steps = max(len(train) // stage.batch_size, 1) * stage.epochs
            if state is None:
                state = trainer.init_state(steps, head_bias=head_bias)
            else:
                # resume: the previous stage's weights, a fresh optimiser for this one
                trainer.init_state(steps)
            log(f"[seed {seed} stage {si}] {stage.img_size}px ×{stage.epochs}ep")
            state, _ = trainer.fit(train, val, epochs=stage.epochs, state=state, log=log)
        states.append((trainer, state))
    return states


def progressive_ensemble_probs(states: list, data: VisionData) -> np.ndarray:
    """Seed-ensemble prediction (logit mean + TTA) with the last stage's
    trainer."""
    trainer = states[0][0]
    return ensemble_predict(trainer, [s for _, s in states], data, tta=True)
