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


def scatter_rows_(dst: torch.Tensor, sub: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7: dst [B, ...] u8 or f32, sub [n, ...] of the same dtype and
    trailing shape, idx int64 [n] of unique row ids in [0, B) → ``dst``,
    rows ``idx`` overwritten in place. Uniqueness and range are the caller's
    contract (they are not checked on the card, which would cost a sync);
    the kernel skips an id outside [0, B) rather than write out of bounds."""
    name = "scatter_rows"
    require(name, dst, _DTYPES, dst.dim())
    require(name, sub, dst.dtype, dst.dim())
    require(name, idx, torch.int64, 1)
    if dst.dim() < 1 or tuple(sub.shape[1:]) != tuple(dst.shape[1:]) or idx.shape[0] != sub.shape[0]:
        raise ValueError(
            f"{name}: sub {tuple(sub.shape)} and idx {tuple(idx.shape)} do not fit dst {tuple(dst.shape)}"
        )
    if not on_cuda(name, dst, sub, idx):
        return scatter_rows_ref(dst, sub, idx)
    n = sub.shape[0]
    if n:
        row_bytes = math.prod(dst.shape[1:]) * dst.element_size()
        code = _build.library().mmtrs_scatter_rows(
            dst.data_ptr(), sub.data_ptr(), idx.data_ptr(), n, dst.shape[0], row_bytes,
            _build.stream_handle(),
        )
        _build.check_launch(name, code)
        LAUNCHES[name] += 1
    return dst
