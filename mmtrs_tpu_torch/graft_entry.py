"""The graft entry points (the twin of the repository's
``__graft_entry__.py``, which stays the JAX package's).

entry()              — the forward of the flagship model, the MM joint
                       dual-task image+tabular net (EfficientNet-B4 at 380,
                       bf16), with JAX's example arguments on the device.
dryrun_multichip(n)  — the real trainers data-parallel over n ranks
                       (``parallel.dryrun``): on the card over nccl, one card
                       a rank; with ``device="cpu"`` over gloo in CPU
                       processes, the counterpart of JAX's forced-CPU
                       subprocess.
"""

from __future__ import annotations

import functools

import torch

from mmtrs_tpu_torch.device import resolve_device


@torch.no_grad()
def _forward(model, img: torch.Tensor, tab: torch.Tensor):
    return model(img, tab)


def entry(device: str | torch.device | None = None):
    """→ (forward, (img, tab)): ``MMJointDualHead("efficientnet_b4")`` in
    bf16 with a Flax-default init drawn from seed 0 (JAX's ``key(0)``), in
    eval mode on ``device`` (None: the card), and JAX's example arguments
    img f32 zeros [4, 380, 380, 3], tab f32 zeros [4, 9] there. ``forward``
    (a ``functools.partial`` over the model) returns (hard logit, soft
    logit)."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead

    dev = resolve_device(device)
    model = lecun_init_(MMJointDualHead("efficientnet_b4", dtype=torch.bfloat16), torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    img = torch.zeros((4, 380, 380, 3), dtype=torch.float32, device=dev)
    tab = torch.zeros((4, 9), dtype=torch.float32, device=dev)
    return functools.partial(_forward, model), (img, tab)


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None, backend: str | None = None) -> None:
    """The dryrun's families (one data-parallel MM step and its sharded
    eval, the augmentation chain sharded by batch, one data-parallel MIL
    step) over ``n_devices`` ranks, each its own process. ``device`` None:
    the card, over nccl with one card a rank (raises when fewer are
    visible, or none); ``"cpu"``: CPU processes over gloo. ``backend``
    overrides the choice (gloo on the card lets ranks share one)."""
    from mmtrs_tpu_torch.parallel.dryrun import spawn

    spawn(n_devices, device=resolve_device(device), backend=backend)
