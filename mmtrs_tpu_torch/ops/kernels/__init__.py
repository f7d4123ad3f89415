"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

A wrapper checks device, dtype, shape and contiguity; for a CPU tensor it
returns its kernel's plain PyTorch version, for a CUDA tensor it launches
the kernel on the current stream (outputs from ``torch.empty``) or raises.
``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import functools

import torch

LAUNCHES: dict[str, int] = {
    "clahe_lab_fwd_lut": 0,
    "clahe_apply_lab_bwd": 0,
    "shift_rows": 0,
    "resample_rows": 0,
    "photometric": 0,
    "shift_rows_windowed": 0,
    "scatter_rows": 0,
    "clahe_hist_lut": 0,
    "clahe_apply": 0,
}


@functools.cache
def sm_count(device: int) -> int:
    """The card's SMs, which the launch plans of K1, K2, K8 and K9 fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when the kernel must launch, False for the CPU plain version;
    raises for mixed or other devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors must all be on one CUDA device or all on the CPU, got {kinds}")


def require(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """``dtype`` is one torch dtype or a tuple of the accepted ones."""
    ok = t.dtype in dtype if isinstance(dtype, tuple) else t.dtype == dtype
    if not ok or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: needs a contiguous {dtype} tensor of {ndim} dims, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def require_shape(name: str, what: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} {tuple(t.shape)} does not fit, expected {tuple(shape)}")
