"""In-place row scatter: CUDA kernel K7 (csrc/scatter_rows.cu) and its plain
PyTorch version.

Port of mmtrs_tpu/ops/pallas/scatter_kernel.py:scatter_rows_pallas
(``_scatter_kernel``): ``dst[idx[k]] = sub[k]`` written into ``dst`` itself;
rows outside ``idx`` are left untouched. It is the write-back of
:func:`~mmtrs_tpu_torch.ops.augment.subset_apply`. The kernel reads ``idx``
on the device, so a launch needs no host sync.
"""

from __future__ import annotations

import math

import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require

_DTYPES = (torch.uint8, torch.float32)


def scatter_rows_ref(dst: torch.Tensor, sub: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_rows_` (any device); returns ``dst``."""
    return dst.index_copy_(0, idx, sub)


def _check(dst: torch.Tensor, sub: torch.Tensor, idx: torch.Tensor) -> bool:
    """Every check of :func:`scatter_rows_`, raising with its reason; True
    when the kernel must launch, False for the CPU plain version."""
    name = "scatter_rows"
    require(name, dst, _DTYPES, dst.dim())
    require(name, sub, dst.dtype, dst.dim())
    require(name, idx, torch.int64, 1)
    if dst.dim() < 1 or tuple(sub.shape[1:]) != tuple(dst.shape[1:]) or idx.shape[0] != sub.shape[0]:
        raise ValueError(
            f"{name}: sub {tuple(sub.shape)} and idx {tuple(idx.shape)} do not fit dst {tuple(dst.shape)}"
        )
    return on_cuda(name, dst, sub, idx)


def scatter_rows_(dst: torch.Tensor, sub: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7: dst [B, ...] u8 or f32, sub [n, ...] of the same dtype and
    trailing shape, idx int64 [n] of unique row ids in [0, B) → ``dst``,
    rows ``idx`` overwritten in place. Uniqueness and range are the caller's
    contract (they are not checked on the card, which would cost a sync);
    the kernel skips an id outside [0, B) rather than write out of bounds.

    The launch path is kept lean, since at the chains' sizes a call's host
    cost is of the order of the kernel's: one expression accepts the
    arguments the kernel takes (every check of :func:`_check`); anything
    else goes through :func:`_check`, which raises or picks the plain
    version for CPU tensors."""
    fast = (  # get_device() is an int, where .device builds an object
        dst.is_cuda and dst.get_device() == sub.get_device() == idx.get_device()
        and sub.dtype == dst.dtype and dst.dtype in _DTYPES
        and idx.dtype == torch.int64 and idx.dim() == 1 and sub.dim() == dst.dim() >= 1
        and sub.shape[1:] == dst.shape[1:] and idx.shape[0] == sub.shape[0]
        and dst.is_contiguous() and sub.is_contiguous() and idx.is_contiguous()
    )
    if not fast and not _check(dst, sub, idx):
        return scatter_rows_ref(dst, sub, idx)
    n = sub.shape[0]
    if n:
        row_bytes = math.prod(dst.shape[1:]) * dst.element_size()
        code = _build.kernel("mmtrs_scatter_rows")(
            dst.data_ptr(), sub.data_ptr(), idx.data_ptr(), n, dst.shape[0], row_bytes,
            _build.stream_handle(),
        )
        _build.check_launch("scatter_rows", code)
        LAUNCHES["scatter_rows"] += 1
    return dst
