"""Serving-side fold ensembles (port of mmtrs_tpu/serve/ensembles.py).

:class:`MILEnsemble` (infer_mil.py:116-158): one bag from all processed
images of a case (resize 512 → centre-crop 480), fold-mean logit →
sigmoid. Folds are port state dicts (from models/convert.py or a random
init); loading the JAX package's Orbax checkpoints comes with the
checkpoint slice, MM and Tab ensembles with theirs.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from mmtrs_tpu_torch.models.mil import MILNet, make_eval_bag
from mmtrs_tpu_torch.train.common import normalize_imagenet


class MILEnsemble:
    def __init__(self, folds: list[dict], model: MILNet, crop_size: int = 480):
        """folds: one ``MILNet`` state dict per fold; ``model`` is the
        architecture, on the device to serve from. Each fold gets its own
        copy of it, loaded once."""
        self.nets = []
        for sd in folds:
            net = copy.deepcopy(model)
            net.load_state_dict(sd)
            self.nets.append(net.eval())
        self.crop_size = crop_size
        self.device = next(model.parameters()).device

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
