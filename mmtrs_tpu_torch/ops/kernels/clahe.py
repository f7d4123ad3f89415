"""CLAHE on a u8 L plane: CUDA kernels K8 and K9 (csrc/clahe_l.cu) and their
plain PyTorch versions.

Port of mmtrs_tpu/ops/pallas/clahe_kernel.py:clahe_pallas, the L-plane
route, which runs ``_hist_lut_kernel_img`` (or the per-tile-row
``_hist_lut_kernel``) and then ``_apply_kernel_img``. Here:

- K8 :func:`clahe_hist_lut`: u8 L [B, H, W] → u8 LUTs [B, ty·tx, 256];
- K9 :func:`clahe_apply`: u8 L + LUTs → the 4-LUT bilinear blend, f32 or
  u8 round-half-up [B, H, W].

:func:`clahe_l` chains them as ``clahe_pallas`` does, rounding an f32 L
plane half-even to u8 first.
"""

from __future__ import annotations

import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.ops.clahe import (
    N_BINS,
    check_tiles,
    clip_limit,
    interpolate_luts,
    quantize_u8,
    tile_luts,
)
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require

_MAX_ROWS = 65535  # K9's grid puts the rows on gridDim.y


def quantize_l(l: torch.Tensor) -> torch.Tensor:
    """f32 L 0..255 → u8, round-half-even then clipped (clahe_kernel.py:226-229)."""
    return torch.clamp(torch.round(l), 0, N_BINS - 1).to(torch.uint8)


def clahe_hist_lut_ref(l: torch.Tensor, clip: float, tiles: tuple[int, int]) -> torch.Tensor:
    """Plain version of K8: u8 LUTs [B, ty·tx, 256]."""
    return tile_luts(l, clip, tiles).to(torch.uint8)


def clahe_apply_ref(l: torch.Tensor, lut: torch.Tensor, tiles: tuple[int, int],
                    out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K9: the blend as f32, or stored u8 round-half-up."""
    out = interpolate_luts(l, lut.float(), tiles)
    return quantize_u8(out) if out_dtype == torch.uint8 else out


def clahe_hist_lut(l: torch.Tensor, clip: float = 3.0, tiles=(8, 8)) -> torch.Tensor:
    """K8: u8 L [B, H, W] → u8 LUTs [B, ty·tx, 256]."""
    name = "clahe_hist_lut"
    require(name, l, torch.uint8, 3)
    B, H, W = l.shape
    check_tiles(H, W, tiles)
    if not on_cuda(name, l):
        return clahe_hist_lut_ref(l, clip, tiles)
    ty, tx = tiles
    area = (H // ty) * (W // tx)
    lut = torch.empty((B, ty * tx, N_BINS), dtype=torch.uint8, device=l.device)
    code = _build.kernel("mmtrs_clahe_hist_lut")(
        l.data_ptr(), lut.data_ptr(), B, H, W, ty, tx, clip_limit(clip, area),
        (N_BINS - 1) / area, _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return lut


def clahe_apply(l: torch.Tensor, lut: torch.Tensor, tiles=(8, 8),
                out_dtype=torch.float32) -> torch.Tensor:
    """K9: u8 L [B, H, W] + u8 LUTs [B, ty·tx, 256] → [B, H, W] f32 (the
    blend) or u8 (round-half-up of it)."""
    name = "clahe_apply"
    require(name, l, torch.uint8, 3)
    require(name, lut, torch.uint8, 3)
    B, H, W = l.shape
    check_tiles(H, W, tiles)
    ty, tx = tiles
    if lut.shape != (B, ty * tx, N_BINS):
        raise ValueError(f"{name}: LUTs {tuple(lut.shape)} do not fit {(B, ty * tx, N_BINS)}")
    if out_dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"{name}: out_dtype must be float32 or uint8, got {out_dtype}")
    if not on_cuda(name, l, lut):
        return clahe_apply_ref(l, lut, tiles, out_dtype)
    if H > _MAX_ROWS or B > _MAX_ROWS:
        raise ValueError(f"{name}: at most {_MAX_ROWS} rows and images, got {(B, H)}")
    out = torch.empty((B, H, W), dtype=out_dtype, device=l.device)
    code = _build.kernel("mmtrs_clahe_apply")(
        l.data_ptr(), lut.data_ptr(), out.data_ptr(), B, H, W, ty, tx,
        int(out_dtype == torch.uint8), _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return out


def clahe_l(l: torch.Tensor, clip: float = 3.0, tiles=(8, 8),
            out_dtype=torch.float32) -> torch.Tensor:
    """CLAHE on an L plane [B, H, W] (u8, or f32 0..255 rounded half-even to
    u8 first) through K8 then K9: f32 out by default, as ``clahe_pallas``."""
    pix = l.contiguous() if l.dtype == torch.uint8 else quantize_l(l).contiguous()
    return clahe_apply(pix, clahe_hist_lut(pix, clip, tiles), tiles, out_dtype)
