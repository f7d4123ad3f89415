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

import functools

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
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require, sm_count

_MAX_GRID = 65535  # K8 and K9 put the images, K9 its bands, on a grid dimension of this size
_MAX_SPLIT = 8  # K8's largest portable thread-block cluster
_SPLIT_PIXELS = 1 << 17  # K8 splits a tile while a block would count more pixels
_MAX_BAND = 32  # K9's longest band of rows


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


def hist_split(area: int, th: int) -> int:
    """K8's blocks per tile: 1, or a thread-block cluster of 2, 4 or 8 that
    merges its counts through distributed shared memory, doubled while a
    block would count more than ``_SPLIT_PIXELS`` of the tile's ``area`` (a
    12 MP photograph's tile has 190,512: one block then keeps too few loads
    in flight); never more blocks than the tile's ``th`` rows. Splitting to
    give every SM a block (a served request has 64 tiles) measured slower."""
    split = 1
    while split < _MAX_SPLIT and 2 * split <= th and area > _SPLIT_PIXELS * split:
        split *= 2
    return split


def apply_band(B: int, H: int, W: int, th: int, sms: int) -> int:
    """Rows a K9 block walks at most: one per 256 threads of a card's
    ``sms`` SMs that the plane would give one row a thread (a thread takes
    8 pixels of a row), from 2 to ``_MAX_BAND`` and at most ``th``, then
    evened out so that the bands of each run of ``th`` rows
    (:func:`band_rows`) differ by a row at most."""
    threads = B * H * ((W + 7) // 8)
    band = min(max(threads // (256 * sms), 2), _MAX_BAND, th)
    per = -(-th // band)
    return -(-th // per)


def apply_bands(H: int, th: int, band: int) -> int:
    """The bands of K9's grid: those of :func:`band_rows` that hold rows."""
    shift = th // 2
    return (H // th) * -(-th // band) + -(-shift // band) - shift // band


def band_rows(j: int, H: int, th: int, band: int) -> tuple[int, int]:
    """Rows [ya, yb) of K9's band ``j`` (its ``blockIdx.y``), as the kernel
    computes them: rows shifted by th // 2 put the changes of their lower
    tile row (th/2 + k·th) at multiples of th, and each run of th shifted
    rows is cut into ceil(th / band) bands of up to ``band`` rows, so no
    band spans more than two tile rows; the bands before row 0 are
    skipped."""
    shift = th // 2
    per = -(-th // band)
    m, q = divmod(j + shift // band, per)
    va = m * th + q * band
    vb = min(va + band, (m + 1) * th)
    return max(va - shift, 0), min(vb - shift, H)


@functools.lru_cache(maxsize=64)
def _hist_args(B: int, H: int, W: int, tiles: tuple, clip: float) -> tuple:
    """K8's arguments past the pointers for one shape: (B, H, W, ty, tx,
    clip limit, LUT scale 255 / area, blocks per tile). Raises off the tile
    grid."""
    check_tiles(H, W, tiles)
    ty, tx = tiles
    th, area = H // ty, (H // ty) * (W // tx)
    if B > _MAX_GRID:
        raise ValueError(f"clahe_hist_lut: at most {_MAX_GRID} images, got {B}")
    split = hist_split(area, th)
    return B, H, W, ty, tx, clip_limit(clip, area), (N_BINS - 1) / area, split


@functools.lru_cache(maxsize=64)
def _apply_args(B: int, H: int, W: int, tiles: tuple, device: int) -> tuple:
    """K9's arguments past the pointers: (B, H, W, ty, tx, band, bands)."""
    check_tiles(H, W, tiles)
    ty, tx = tiles
    th = H // ty
    band = apply_band(B, H, W, th, sm_count(device))
    bands = apply_bands(H, th, band)
    if B > _MAX_GRID or bands > _MAX_GRID:
        raise ValueError(f"clahe_apply: at most {_MAX_GRID} images and bands, got {(B, bands)}")
    return B, H, W, ty, tx, band, bands


def _lean(l: torch.Tensor) -> bool:
    """A contiguous u8 [B, H, W] plane on a card: the launch path's one check."""
    return l.is_cuda and l.dtype == torch.uint8 and l.dim() == 3 and l.is_contiguous()


def clahe_hist_lut(l: torch.Tensor, clip: float = 3.0, tiles=(8, 8)) -> torch.Tensor:
    """K8: u8 L [B, H, W] → u8 LUTs [B, ty·tx, 256]. A contiguous u8 plane on
    a card passes one check and takes its cached launch arguments;
    anything else goes through the full check, which raises or takes the
    plain version for a CPU tensor."""
    name = "clahe_hist_lut"
    if not _lean(l):
        require(name, l, torch.uint8, 3)
        check_tiles(l.shape[1], l.shape[2], tiles)
        if not on_cuda(name, l):
            return clahe_hist_lut_ref(l, clip, tiles)
    B, H, W = l.shape
    args = _hist_args(B, H, W, tuple(tiles), clip)
    lut = l.new_empty((B, args[3] * args[4], N_BINS))
    code = _build.kernel("mmtrs_clahe_hist_lut")(l.data_ptr(), lut.data_ptr(), *args, _build.stream_handle())
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return lut


def clahe_apply(l: torch.Tensor, lut: torch.Tensor, tiles=(8, 8),
                out_dtype=torch.float32) -> torch.Tensor:
    """K9: u8 L [B, H, W] + u8 LUTs [B, ty·tx, 256] → [B, H, W] f32 (the
    blend) or u8 (round-half-up of it), with K8's lean launch path."""
    name = "clahe_apply"
    B, H, W = l.shape if l.dim() == 3 else (0, 0, 0)
    ty, tx = tiles
    fast = (_lean(l) and lut.is_cuda and lut.get_device() == l.get_device() and lut.dtype == torch.uint8
            and lut.shape == (B, ty * tx, N_BINS) and lut.is_contiguous()
            and out_dtype in (torch.float32, torch.uint8))
    if not fast:
        require(name, l, torch.uint8, 3)
        require(name, lut, torch.uint8, 3)
        check_tiles(H, W, tiles)
        if lut.shape != (B, ty * tx, N_BINS):
            raise ValueError(f"{name}: LUTs {tuple(lut.shape)} do not fit {(B, ty * tx, N_BINS)}")
        if out_dtype not in (torch.float32, torch.uint8):
            raise ValueError(f"{name}: out_dtype must be float32 or uint8, got {out_dtype}")
        if not on_cuda(name, l, lut):
            return clahe_apply_ref(l, lut, tiles, out_dtype)
    args = _apply_args(B, H, W, tuple(tiles), l.get_device())
    out = l.new_empty((B, H, W), dtype=out_dtype)
    code = _build.kernel("mmtrs_clahe_apply")(
        l.data_ptr(), lut.data_ptr(), out.data_ptr(), *args, int(out_dtype == torch.uint8),
        _build.stream_handle(),
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
