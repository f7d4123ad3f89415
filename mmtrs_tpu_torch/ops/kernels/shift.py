"""Fractional shifts of an NHWC batch along one axis: CUDA kernels K3 and
K6 (csrc/shift_rows.cu) and their plain PyTorch versions.

- K3 :func:`shift_rows`, port of mmtrs_tpu/ops/pallas/shift_kernel.py:
  shift_rows_pallas (``_shift_rows_kernel``): one offset per line,
  ``out[m, x] = in[m, x + off[m]]``, bilinear, replicate border;
- K6 :func:`shift_rows_windowed`, port of ``shift_rows_windowed_pallas``
  (``_shift_rows_pp_kernel``): one offset per pixel, summed over a window of
  taps [−max_shift, max_shift + 1] as the TPU kernel sums them.

The TPU kernels work on planar rows ``[B·C·H, W]`` behind an NHWC→planar
transpose, and their callers swap H and W for the other axis; these read
NHWC directly and take ``axis``:

- axis 2: row (b, y) shifts along W (K3: off [B, H]);
- axis 1: column (b, x) shifts along H (K3: off [B, W]).
"""

from __future__ import annotations

import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require, require_shape


def shift_rows_ref(img: torch.Tensor, off: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """Plain version of :func:`shift_rows` (the same two taps, any device)."""
    x = img.float()
    if axis == 1:
        x = x.transpose(1, 2)
    B, R, n, C = x.shape  # R lines of n samples
    k = torch.floor(off)
    f = (off - k)[:, :, None, None]
    s = torch.remainder(k.long(), n)
    pos = torch.arange(n, device=x.device)
    i0 = (pos[None, None, :] + s[:, :, None]) % n
    i1 = (i0 + 1) % n
    idx = lambda i: i[..., None].expand(B, R, n, C)
    a = torch.gather(x, 2, idx(i0))
    b = torch.gather(x, 2, idx(i1))
    out = (1.0 - f) * a + f * b
    src = pos.float()[None, None, :] + off[:, :, None]
    out = torch.where((src < 0.0)[..., None], x[:, :, :1, :], out)
    out = torch.where((src > n - 1.0)[..., None], x[:, :, -1:, :], out)
    if axis == 1:
        out = out.transpose(1, 2)
    if img.dtype == torch.uint8:
        return (torch.clamp(out, 0.0, 255.0) + 0.5).to(torch.uint8).contiguous()
    return out.contiguous()


def shift_rows(img: torch.Tensor, off: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """K3: img [B, H, W, C] u8 or f32, off f32 [B, H] (axis 2) or [B, W]
    (axis 1) → the shifted batch in the input's dtype (u8 out is the
    round-half-up store)."""
    name = "shift_rows"
    if img.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{name}: u8/f32 only, got {img.dtype}")
    require(name, img, img.dtype, 4)
    require(name, off, torch.float32, 2)
    if axis not in (1, 2):
        raise ValueError(f"{name}: axis must be 1 or 2, got {axis}")
    B, H, W, C = img.shape
    if off.shape != (B, H if axis == 2 else W):
        raise ValueError(f"{name}: off {tuple(off.shape)} does not fit {tuple(img.shape)} axis {axis}")
    if not on_cuda(name, img, off):
        return shift_rows_ref(img, off, axis)
    out = torch.empty_like(img)
    code = _build.kernel("mmtrs_shift_rows")(
        img.data_ptr(), out.data_ptr(), off.data_ptr(), B, H, W, C, axis,
        int(img.dtype == torch.uint8), _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return out


def shift_rows_windowed_ref(
    img: torch.Tensor, off: torch.Tensor, max_shift: int, axis: int = 2
) -> torch.Tensor:
    """Plain version of :func:`shift_rows_windowed` (the same two taps, any
    device): ``src = clip(p + off, 0, n − 1)`` blends samples
    ``i0 = floor(src)`` and ``min(i0 + 1, n − 1)``; a tap whose index relative
    to p lies outside the window [−m, m + 1] weighs 0; ``src ≤ 0`` takes the
    first sample and ``src ≥ n − 1`` the last."""
    x = img.float()
    if axis == 1:
        x, off = x.transpose(1, 2), off.transpose(1, 2)
    B, R, n, C = x.shape
    m = int(max_shift)
    pos = torch.arange(n, dtype=torch.float32, device=x.device)
    src = torch.clamp(pos + off, 0.0, n - 1.0)
    f0 = torch.floor(src)
    w = src - f0
    i0 = f0.long()
    i1 = torch.clamp_max(i0 + 1, n - 1)
    k = i0 - torch.arange(n, device=x.device)  # the first tap's index relative to p
    zero = torch.zeros((), device=x.device)
    w0 = torch.where((k >= -m) & (k <= m + 1), 1.0 - w, zero)[..., None]
    w1 = torch.where((k >= -m - 1) & (k <= m), w, zero)[..., None]
    idx = lambda i: i[..., None].expand(B, R, n, C)
    out = w0 * torch.gather(x, 2, idx(i0)) + w1 * torch.gather(x, 2, idx(i1))
    out = torch.where((src <= 0.0)[..., None], x[:, :, :1, :], out)
    out = torch.where((src >= n - 1.0)[..., None], x[:, :, -1:, :], out)
    if axis == 1:
        out = out.transpose(1, 2)
    if img.dtype == torch.uint8:
        return (torch.clamp(out, 0.0, 255.0) + 0.5).to(torch.uint8).contiguous()
    return out.contiguous()


def shift_rows_windowed(
    img: torch.Tensor, off: torch.Tensor, max_shift: int, axis: int = 2
) -> torch.Tensor:
    """K6: img [B, H, W, C] u8 or f32, off f32 [B, H, W] per pixel (shared by
    the channels), window ``max_shift`` ≥ 0 → ``out = in[.., p + off, ..]``
    along ``axis``, bilinear, replicate border, in the input's dtype (u8 out
    is the round-half-up store). An offset beyond the window gives what the
    TPU kernel's windowed sum gives: the taps outside [−m, m + 1] weigh 0,
    and a source clipped to the first or last sample takes it."""
    name = "shift_rows_windowed"
    require(name, img, (torch.uint8, torch.float32), 4)
    require(name, off, torch.float32, 3)
    if axis not in (1, 2):
        raise ValueError(f"{name}: axis must be 1 or 2, got {axis}")
    if int(max_shift) < 0:
        raise ValueError(f"{name}: max_shift must be >= 0, got {max_shift}")
    B, H, W, C = img.shape
    require_shape(name, "off", off, (B, H, W))
    if not on_cuda(name, img, off):
        return shift_rows_windowed_ref(img, off, max_shift, axis)
    out = torch.empty_like(img)
    code = _build.kernel("mmtrs_shift_rows_windowed")(
        img.data_ptr(), out.data_ptr(), off.data_ptr(), B, H, W, C, axis, int(max_shift),
        int(img.dtype == torch.uint8), _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return out
