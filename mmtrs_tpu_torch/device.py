"""The compute device of the port's entry points.

An entry point takes ``device=None``, which means the card. The CPU is used
only when the caller passes ``device="cpu"`` (the tests do); without a CUDA
device a call that asked for none raises instead of carrying on elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``torch.device("cuda")``, raising when no CUDA device is
    visible; anything else → ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
