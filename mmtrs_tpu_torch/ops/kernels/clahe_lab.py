"""CLAHE on the LAB L channel of a u8 RGB batch: CUDA kernels K1 and K2
(csrc/clahe_lab.cu) and their plain PyTorch versions.

Port of mmtrs_tpu/ops/pallas/lab_kernels.py:clahe_lab_fused, which chains
the Pallas kernels ``_fwd_kernel`` → ``_hist_lut_kernel_img`` →
``_apply_kernel_img`` → ``_bwd_kernel``. Here:

- K1 :func:`clahe_lab_fwd_lut`: u8 RGB [B, H, W, 3] → u8 L, i8 a−128,
  i8 b−128 planes [B, H, W] and per-tile u8 LUTs [B, ty·tx, 256];
- K2 :func:`clahe_apply_lab_bwd`: planes + LUTs → u8 RGB [B, H, W, 3].

Rounding follows the Pallas kernels: L and chroma round half-even (L as
round(L·f32(2.55))), chroma clipped before the int8 cast, every u8 store
floor(clip(x) + 0.5).
"""

from __future__ import annotations

import ctypes
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
from mmtrs_tpu_torch.ops.color import (
    _LAB_DELTA,
    _WHITE,
    _f_lab,
    _inv_f,
    _linear_to_srgb,
    _srgb_to_linear,
    fdiv,
)
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require, sm_count


def _q_i8_lattice(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -128.0, 127.0).to(torch.int8)


def lab_fwd_ref(imgs: torch.Tensor):
    """Plain version of the forward LAB step: u8 [B, H, W, 3] → (lq u8, da i8,
    db i8), each [B, H, W] (lab_kernels.py:_fwd_kernel)."""
    x = _srgb_to_linear(fdiv(imgs.float(), 255.0))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    X = 0.412453 * r + 0.357580 * g + 0.180423 * b
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    xn, yn, zn = fdiv(X, _WHITE[0]), fdiv(Y, _WHITE[1]), fdiv(Z, _WHITE[2])
    fx, fy, fz = _f_lab(xn), _f_lab(yn), _f_lab(zn)
    L = torch.where(yn > _LAB_DELTA, 116.0 * fy - 16.0, 903.3 * yn)
    da = _q_i8_lattice(500.0 * (fx - fy))
    db = _q_i8_lattice(200.0 * (fy - fz))
    lq = torch.clamp(torch.round(L * (255.0 / 100.0)), 0.0, 255.0).to(torch.uint8)
    return lq, da, db


def lab_bwd_ref(l2: torch.Tensor, da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward step: L' (u8 values), chroma → u8 RGB
    (lab_kernels.py:_bwd_kernel)."""
    fyp = fdiv(l2.float() * (100.0 / 255.0) + 16.0, 116.0)
    fx = fyp + da.float() * (1.0 / 500.0)
    fz = fyp - db.float() * (1.0 / 200.0)
    X = _inv_f(fx) * _WHITE[0]
    Y = _inv_f(fyp) * _WHITE[1]
    Z = _inv_f(fz) * _WHITE[2]
    r = 3.240479 * X - 1.537150 * Y - 0.498535 * Z
    g = -0.969256 * X + 1.875992 * Y + 0.041556 * Z
    b = 0.055648 * X - 0.204043 * Y + 1.057311 * Z
    rgb = torch.stack([r, g, b], dim=-1)
    return quantize_u8(_linear_to_srgb(rgb) * 255.0)


def clahe_lab_fwd_lut_ref(imgs: torch.Tensor, clip: float, tiles: tuple[int, int]):
    """Plain version of K1: (lq, da, db, lut u8 [B, ty·tx, 256])."""
    lq, da, db = lab_fwd_ref(imgs)
    return lq, da, db, tile_luts(lq, clip, tiles).to(torch.uint8)


def clahe_apply_lab_bwd_ref(lq, da, db, lut, tiles: tuple[int, int]) -> torch.Tensor:
    """Plain version of K2: u8 RGB [B, H, W, 3]."""
    l2 = quantize_u8(interpolate_luts(lq, lut.float(), tiles))
    return lab_bwd_ref(l2, da, db)


def _check_imgs(name: str, imgs: torch.Tensor, tiles) -> None:
    require(name, imgs, torch.uint8, 4)
    if imgs.shape[-1] != 3:
        raise ValueError(f"{name}: needs [B, H, W, 3] RGB, got {tuple(imgs.shape)}")
    check_tiles(imgs.shape[1], imgs.shape[2], tiles)


def fwd_split(n_tiles: int, th: int, sms: int) -> int:
    """K1's blocks per tile: 1, or a thread-block cluster of 2 or 4 while
    ``n_tiles`` (B·ty·tx) blocks would give the card's ``sms`` SMs fewer
    than two each (a served 512² upload has 64 tiles); never more than the
    tile's ``th`` rows."""
    split = 1
    while split < 4 and n_tiles * split < 2 * sms:
        split *= 2
    while split > th:
        split //= 2
    return split


def bwd_band(B: int, H: int, W: int, th: int, sms: int) -> int:
    """Rows each K2 block walks: the most, a power of two up to 16, that
    still give the card's ``sms`` SMs 512 threads each (a thread takes 4
    pixels of a row) and divide ``th // 2``. A row's lower tile row changes
    at rows th/2 + k·th, so such a band reads two tile rows of LUTs, which
    the kernel stages (another band reads them from global memory)."""
    threads = B * H * ((W + 3) // 4)
    band = 16
    while band > 1 and (threads // band < 512 * sms or (th // 2) % band):
        band //= 2
    return band


class FwdLaunch(ctypes.Structure):
    """K1's launch constants past the pointers (csrc/clahe_lab.cu:FwdLaunch)."""

    _fields_ = [(name, ctypes.c_int) for name in ("B", "H", "W", "ty", "tx", "limit")] + [
        ("lut_scale", ctypes.c_float), ("split", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _fwd_args(B: int, H: int, W: int, tiles: tuple, clip: float, device: int) -> FwdLaunch:
    """K1's launch constants for one shape on one card: the clip limit, the
    LUT scale 255 / area and the blocks per tile. Raises off the tile grid."""
    check_tiles(H, W, tiles)
    ty, tx = tiles
    area = (H // ty) * (W // tx)
    split = fwd_split(B * ty * tx, H // ty, sm_count(device))
    return FwdLaunch(B, H, W, ty, tx, clip_limit(clip, area), (N_BINS - 1) / area, split)


@functools.lru_cache(maxsize=64)
def _bwd_args(B: int, H: int, W: int, tiles: tuple, device: int) -> tuple:
    """K2's launch constants past the pointers: (B, H, W, ty, tx, band)."""
    check_tiles(H, W, tiles)
    ty, tx = tiles
    return B, H, W, ty, tx, bwd_band(B, H, W, H // ty, sm_count(device))


def clahe_lab_fwd_lut(imgs: torch.Tensor, clip: float = 3.0, tiles=(8, 8)):
    """K1: u8 RGB [B, H, W, 3] → (lq u8, da i8, db i8 [B, H, W], lut u8 [B, ty·tx, 256]).

    The launch path is lean, since a served request is bound by host
    launches: one expression accepts a contiguous u8 RGB batch on a card,
    the launch constants are one cached struct, and the three planes are one
    allocation. Anything else goes through the full check, which raises or
    takes the plain version for a CPU tensor."""
    name = "clahe_lab_fwd_lut"
    fast = (imgs.is_cuda and imgs.dtype == torch.uint8 and imgs.dim() == 4 and imgs.shape[3] == 3
            and imgs.is_contiguous())
    if not fast:
        _check_imgs(name, imgs, tiles)
        if not on_cuda(name, imgs):
            return clahe_lab_fwd_lut_ref(imgs, clip, tiles)
    B, H, W, _ = imgs.shape
    args = _fwd_args(B, H, W, tuple(tiles), clip, imgs.get_device())
    planes = imgs.new_empty((3, B, H, W), dtype=torch.int8)  # lq, da, db
    lut = imgs.new_empty((B, args.ty * args.tx, N_BINS))
    code = _build.kernel("mmtrs_clahe_lab_fwd_lut")(
        imgs.data_ptr(), planes.data_ptr(), lut.data_ptr(), ctypes.addressof(args),
        _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    lq, da, db = planes.unbind(0)
    return lq.view(torch.uint8), da, db, lut


def _check_planes(name: str, lq, da, db, lut, tiles) -> None:
    require(name, lq, torch.uint8, 3)
    require(name, da, torch.int8, 3)
    require(name, db, torch.int8, 3)
    require(name, lut, torch.uint8, 3)
    B, H, W = lq.shape
    check_tiles(H, W, tiles)
    ty, tx = tiles
    if da.shape != lq.shape or db.shape != lq.shape or lut.shape != (B, ty * tx, N_BINS):
        raise ValueError(f"{name}: mismatched plane / LUT shapes")


def clahe_apply_lab_bwd(lq, da, db, lut, tiles=(8, 8)) -> torch.Tensor:
    """K2: planes [B, H, W] + LUTs [B, ty·tx, 256] → u8 RGB [B, H, W, 3],
    with K1's lean launch path."""
    name = "clahe_apply_lab_bwd"
    fast = (
        lq.is_cuda and lq.get_device() == da.get_device() == db.get_device() == lut.get_device()
        and lq.dtype == torch.uint8 and da.dtype == torch.int8 and db.dtype == torch.int8
        and lut.dtype == torch.uint8 and lq.dim() == 3 and lq.shape == da.shape == db.shape
        and lut.shape == (lq.shape[0], tiles[0] * tiles[1], N_BINS)
        and lq.is_contiguous() and da.is_contiguous() and db.is_contiguous() and lut.is_contiguous()
    )
    if not fast:
        _check_planes(name, lq, da, db, lut, tiles)
        if not on_cuda(name, lq, da, db, lut):
            return clahe_apply_lab_bwd_ref(lq, da, db, lut, tiles)
    B, H, W = lq.shape
    args = _bwd_args(B, H, W, tuple(tiles), lq.get_device())
    out = lq.new_empty((B, H, W, 3))
    code = _build.kernel("mmtrs_clahe_apply_lab_bwd")(
        lq.data_ptr(), da.data_ptr(), db.data_ptr(), lut.data_ptr(), out.data_ptr(), *args,
        _build.stream_handle(),
    )
    _build.check_launch(name, code)
    LAUNCHES[name] += 1
    return out


def _plane_rows(H: int) -> int:
    """Copy of mmtrs_tpu/ops/pallas/lab_kernels.py:_plane_rows: the fused
    TPU kernels' 16-aligned row block."""
    for rows in range(min(128, H // 16 * 16), 15, -16):
        if H % rows == 0:
            return rows
    raise ValueError(f"no 16-aligned row block for H={H}")


def supports(H: int, W: int, tiles=(8, 8)) -> bool:
    """Copy of mmtrs_tpu/ops/pallas/lab_kernels.py:supports: the shapes on
    which the JAX package takes the fused LAB route (K1/K2 here); elsewhere
    it takes the L-plane route (K8/K9). Held equal by
    tests/test_torch_hygiene.py."""
    if not (
        W % 128 == 0 and H % 16 == 0 and H % tiles[0] == 0 and W % tiles[1] == 0
    ):
        return False
    try:
        return _plane_rows(H) % 32 == 0
    except ValueError:
        return False


def _as_u8(imgs: torch.Tensor) -> torch.Tensor:
    if imgs.dtype == torch.uint8:
        return imgs.contiguous()
    return quantize_u8(imgs.float()).contiguous()


def clahe_lab_fused(imgs: torch.Tensor, clip: float = 3.0, tiles=(8, 8)) -> torch.Tensor:
    """RGB 0..255 [B, H, W, 3] → CLAHE on LAB L → u8 RGB, through K1 and K2."""
    lq, da, db, lut = clahe_lab_fwd_lut(_as_u8(imgs), clip, tiles)
    return clahe_apply_lab_bwd(lq, da, db, lut, tiles)


def clahe_lab_fused_ref(imgs: torch.Tensor, clip: float = 3.0, tiles=(8, 8)) -> torch.Tensor:
    """Plain version of :func:`clahe_lab_fused`, on any device."""
    x = _as_u8(imgs)
    check_tiles(x.shape[1], x.shape[2], tiles)
    lq, da, db, lut = clahe_lab_fwd_lut_ref(x, clip, tiles)
    return clahe_apply_lab_bwd_ref(lq, da, db, lut, tiles)
