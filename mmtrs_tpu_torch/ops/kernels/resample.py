"""One pass of the two-pass affine warp: CUDA kernel K4
(csrc/resample_rows.cu) and its plain PyTorch version.

Port of mmtrs_tpu/ops/pallas/shift_kernel.py:resample_rows_pallas
(``_resample_rows_kernel``). Along each line of n samples, K3's fractional
shift by ``off`` (replicate border), then the hat resample

    out[xo] = Σ_x tmp[x] · max(0, 1 − |clip(α·xo + r, 0, n − 1) − x|)

read as its two non-zero taps. ``alpha`` and ``r`` are per image (the TPU
kernel's row blocks never span images). NHWC in place of planar rows:

- axis 2: row (b, y) along W, off [B, H] (the warp's horizontal pass);
- axis 1: column (b, x) along H, off [B, W] (the vertical pass).
"""

from __future__ import annotations

import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require, require_shape
from mmtrs_tpu_torch.ops.kernels.shift import shift_rows_ref


def resample_rows_ref(
    img: torch.Tensor, off: torch.Tensor, alpha: torch.Tensor, r: torch.Tensor,
    axis: int = 2,
) -> torch.Tensor:
    """Plain version of :func:`resample_rows` (the same taps, any device)."""
    tmp = shift_rows_ref(img.float(), off, axis)
    if axis == 1:
        tmp = tmp.transpose(1, 2)
    B, R, n, C = tmp.shape
    pos = torch.arange(n, dtype=torch.float32, device=tmp.device)
    c = torch.clamp(alpha[:, None] * pos[None, :] + r[:, None], 0.0, n - 1.0)  # [B, n]
    c0 = torch.floor(c)
    w = (c - c0)[:, None, :, None]
    i0 = c0.long()
    i1 = torch.clamp_max(i0 + 1, n - 1)
    idx = lambda i: i[:, None, :, None].expand(B, R, n, C)
    out = (1.0 - w) * torch.gather(tmp, 2, idx(i0)) + w * torch.gather(tmp, 2, idx(i1))
    if axis == 1:
        out = out.transpose(1, 2)
    if img.dtype == torch.uint8:
        return (torch.clamp(out, 0.0, 255.0) + 0.5).to(torch.uint8).contiguous()
    return out.contiguous()


def resample_rows(
    img: torch.Tensor, off: torch.Tensor, alpha: torch.Tensor, r: torch.Tensor,
    axis: int = 2,
) -> torch.Tensor:
    """K4: img [B, H, W, C] u8 or f32; off f32 [B, H] (axis 2) or [B, W]
    (axis 1); alpha, r f32 [B] → the resampled batch in img's dtype (u8 is
    the round-half-up store)."""
    name = "resample_rows"
    require(name, img, (torch.uint8, torch.float32), 4)
    require(name, off, torch.float32, 2)
    require(name, alpha, torch.float32, 1)
    require(name, r, torch.float32, 1)
    if axis not in (1, 2):
        raise ValueError(f"{name}: axis must be 1 or 2, got {axis}")
    B, H, W, C = img.shape
    require_shape(name, "off", off, (B, H if axis == 2 else W))
    require_shape(name, "alpha", alpha, (B,))
    require_shape(name, "r", r, (B,))
    if not on_cuda(name, img, off, alpha, r):
        return resample_rows_ref(img, off, alpha, r, axis)
    out = torch.empty_like(img)
    code = _build.kernel("mmtrs_resample_rows")(
        img.data_ptr(), out.data_ptr(), off.data_ptr(), alpha.data_ptr(), r.data_ptr(),
        B, H, W, C, axis, int(img.dtype == torch.uint8), _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return out
