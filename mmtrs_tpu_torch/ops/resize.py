"""Resizes and crop geometry as separable bilinear resamples (port of
mmtrs_tpu/ops/resize.py: ``resize_bilinear``, ``center_crop_resize``,
``crop_box_resize``, ``_crop_affine_params``, ``crop_warp_fused``,
``mask_to_box``).

The JAX package builds a dense hat-weight matrix per axis and multiplies,
because the TPU has no fast gather; an H100 gathers, so each axis here is a
direct two-tap read with the same clamped coordinates (replicate border) and
the same weights. float32 throughout, except ``crop_warp_fused``, which
keeps a u8 batch u8 (kernel K4), and ``resize_bilinear_u8``, serving's
bucket resize, which computes Pillow's integer BILINEAR resize (host work in
the JAX package, mmtrs_tpu/serve/service.py:133-143).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mmtrs_tpu_torch.ops.color import fdiv
from mmtrs_tpu_torch.ops.warp import _to_3x3, invert_affine, mat3, warp_affine_shear


def _resample_axis(imgs: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """imgs [B, H, W, C] f32; coords [B, n_out] source positions along H
    (axis 1) or W (axis 2) → bilinear samples, clamped to the image."""
    B, H, W, C = imgs.shape
    n_src = imgs.shape[axis]
    c = torch.clamp(coords, 0.0, n_src - 1.0)
    i0 = torch.floor(c)
    w = c - i0
    i0 = i0.long()
    i1 = torch.clamp_max(i0 + 1, n_src - 1)
    n_out = coords.shape[1]
    if axis == 1:
        shape, view_w = (B, n_out, W, C), w[:, :, None, None]
        idx = lambda i: i[:, :, None, None].expand(shape)
    else:
        shape, view_w = (B, H, n_out, C), w[:, None, :, None]
        idx = lambda i: i[:, None, :, None].expand(shape)
    a = torch.gather(imgs, axis, idx(i0))
    b = torch.gather(imgs, axis, idx(i1))
    return (1.0 - view_w) * a + view_w * b


def resize_bilinear(imgs: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR-compatible batched resize (half-pixel centres)."""
    B, H, W, C = imgs.shape
    oh, ow = out_hw
    dev = imgs.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * (H / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * (W / ow) - 0.5
    out = _resample_axis(imgs.float(), ys[None].expand(B, oh), axis=1)
    return _resample_axis(out, xs[None].expand(B, ow), axis=2)


_PRECISION_BITS = 32 - 8 - 2  # Pillow's libImaging/Resample.c


def _pillow_bilinear_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the bilinear filter over the whole
    axis, then ``normalize_coeffs_8bpc``: (source index [n_out, k], clamped
    into the axis; integer weight [n_out, k], 0 past each output's taps).
    Computed in double on the host in Pillow's order of operations."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), n_in) - xmin
    taps = np.arange(ksize)
    used = taps[None, :] < xmax[:, None]
    t = np.abs(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where(used & (t < 1.0), 1.0 - t, 0.0)
    ww = np.zeros(n_out)
    for j in range(ksize):  # Pillow's sum, tap by tap
        ww = ww + k[:, j]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    one = 1 << _PRECISION_BITS
    coef = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int32)
    idx = np.minimum(xmin[:, None] + taps[None, :], n_in - 1)
    return idx, coef


def _pillow_pass(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """One Pillow 8-bit pass along ``axis`` of u8 [B, H, W, C]: an int32
    accumulator from 1 << 21, the taps' u8 · weight products added, then
    >> 22 and clipped to 0..255."""
    idx, coef = _pillow_bilinear_taps(x.shape[axis], n_out)
    idx = torch.from_numpy(idx).to(x.device)
    coef = torch.from_numpy(coef).to(x.device)
    view = [1, 1, 1, 1]
    view[axis] = n_out
    acc = None
    for j in range(idx.shape[1]):
        term = x.index_select(axis, idx[:, j]).to(torch.int32) * coef[:, j].view(view)
        acc = term + (1 << (_PRECISION_BITS - 1)) if acc is None else acc + term
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def resize_bilinear_u8(imgs: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``PIL.Image.resize((w, h), Image.BILINEAR)`` of u8 RGB, bit for bit,
    on the tensor's device: u8 [H, W, 3] or [B, H, W, 3] → the same rank at
    ``out_hw``. The horizontal pass runs first, u8 between the passes, and
    each pass only where its dimension changes (libImaging/Resample.c)."""
    if imgs.dtype != torch.uint8 or imgs.dim() not in (3, 4):
        raise ValueError(f"resize_bilinear_u8: needs u8 [H, W, C] or [B, H, W, C], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    x = imgs if imgs.dim() == 4 else imgs[None]
    oh, ow = out_hw
    if x.shape[2] != ow:
        x = _pillow_pass(x, 2, ow)
    if x.shape[1] != oh:
        x = _pillow_pass(x, 1, oh)
    return x if imgs.dim() == 4 else x[0]


def center_crop_resize(imgs: torch.Tensor, out_size: int) -> torch.Tensor:
    """Centre square crop then resize (pipeline.py:23-29)."""
    B, H, W, C = imgs.shape
    side = min(H, W)
    y0, x0 = (H - side) // 2, (W - side) // 2
    crop = imgs[:, y0 : y0 + side, x0 : x0 + side, :]
    return resize_bilinear(crop, (out_size, out_size))


def _crop_affine_params(boxes: torch.Tensor, H: int, W: int, out_size: int, margin: float):
    """Per-sample scale and translation of the dst→src axis-aligned map
    src = scale·dst + t, plus the crop-rect bounds for the zero-pad mask."""
    b = boxes.float()
    y0 = torch.clamp_min(b[:, 0] - margin, 0.0)
    x0 = torch.clamp_min(b[:, 1] - margin, 0.0)
    y1 = torch.clamp_max(b[:, 2] + margin, float(H))
    x1 = torch.clamp_max(b[:, 3] + margin, float(W))
    h = y1 - y0
    w = x1 - x0
    d = torch.maximum(h, w)
    y_off = torch.floor((d - h) / 2.0)
    x_off = torch.floor((d - w) / 2.0)
    scale = fdiv(d, out_size)
    ty = 0.5 * scale - 0.5 - y_off + y0
    tx = 0.5 * scale - 0.5 - x_off + x0
    return scale, ty, tx, y0, x0, y1, x1


def crop_box_resize(
    imgs: torch.Tensor, boxes: torch.Tensor, out_size: int, margin: float = 15.0
) -> torch.Tensor:
    """Batched ``crop_with_mask`` geometry (segment.py:60-82): per-sample box
    (y0, x0, y1, x1) + margin, clamp, pad-to-square with zeros, resize to
    ``out_size``². Returns float32 [B, out, out, C]."""
    B, H, W, C = imgs.shape
    scale, ty, tx, y0, x0, y1, x1 = _crop_affine_params(boxes, H, W, out_size, margin)
    u = torch.arange(out_size, dtype=torch.float32, device=imgs.device)
    sy = scale[:, None] * u[None, :] + ty[:, None]  # [B, out]
    sx = scale[:, None] * u[None, :] + tx[:, None]
    out = _resample_axis(imgs.float(), sy, axis=1)
    out = _resample_axis(out, sx, axis=2)

    # zero the pad region: outputs whose source falls outside the crop rect
    row_ok = (sy >= y0[:, None] - 0.5) & (sy <= y1[:, None] - 0.5)
    col_ok = (sx >= x0[:, None] - 0.5) & (sx <= x1[:, None] - 0.5)
    mask = row_ok[:, :, None] & col_ok[:, None, :]
    return torch.where(mask[..., None], out, torch.zeros((), device=out.device))


def crop_warp_fused(
    imgs: torch.Tensor, boxes: torch.Tensor, mats: torch.Tensor, out_size: int,
    margin: float = 15.0,
) -> torch.Tensor:
    """``crop_box_resize`` composed with a per-image affine augmentation in
    ONE two-pass warp (``warp_affine_shear``, kernel K4): the crop is the
    axis-aligned affine src = scale·dst + t, so crop∘augment is one affine.

    ``mats``: [B, 2, 3] or [B, 3, 3] forward maps in the crop-output frame.
    The warp samples with a replicate border, then the exact combined mask
    zeroes each output pixel whose augment source leaves the [0, out − 1]²
    crop frame or whose original source leaves the crop rect (the
    pad-to-square zeros). Needs square inputs with H == W == out_size. A u8
    batch stays u8."""
    B, H, W, C = imgs.shape
    if H != out_size or W != out_size:
        raise ValueError(f"crop_warp_fused requires H=W=out_size, got {(H, W, out_size)}")
    m_total, m_aug, crop_params = _crop_warp_matrix(boxes, mats, H, W, out_size, margin)
    out = warp_affine_shear(imgs, m_total, border="replicate")
    ok = _crop_warp_mask(m_aug, crop_params, out_size)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def _crop_warp_matrix(boxes, mats, H, W, out_size, margin):
    """Combined crop∘augment forward matrix, the augment matrix, and the
    crop parameters for the mask."""
    crop_params = _crop_affine_params(boxes, H, W, out_size, margin)
    scale, ty, tx = crop_params[:3]
    m_aug = _to_3x3(mats.to(device=scale.device, dtype=torch.float32))
    z, one = torch.zeros_like(scale), torch.ones_like(scale)
    inv_s = 1.0 / scale
    m_crop = torch.stack([
        torch.stack([inv_s, z, -tx * inv_s], dim=-1),
        torch.stack([z, inv_s, -ty * inv_s], dim=-1),
        torch.stack([z, z, one], dim=-1),
    ], dim=-2)  # [B, 3, 3] in (x, y, 1)
    return mat3(m_aug, m_crop), m_aug, crop_params


def _crop_warp_mask(m_aug, crop_params, out_size):
    """[B, out, out] bool: True where the output pixel has a real source."""
    scale, ty, tx, y0, x0, y1, x1 = crop_params
    inva = invert_affine(m_aug)
    xx = torch.arange(out_size, dtype=torch.float32, device=m_aug.device)[None, None, :]
    yy = torch.arange(out_size, dtype=torch.float32, device=m_aug.device)[None, :, None]
    e = lambda i, j: inva[:, i, j, None, None]
    vx = e(0, 0) * xx + e(0, 1) * yy + e(0, 2)
    vy = e(1, 0) * xx + e(1, 1) * yy + e(1, 2)
    col = lambda v: v[:, None, None]
    sx = col(scale) * vx + col(tx)
    sy = col(scale) * vy + col(ty)
    lim = float(out_size - 1)
    return (
        (vx >= 0.0) & (vx <= lim) & (vy >= 0.0) & (vy <= lim)
        & (sx >= col(x0) - 0.5) & (sx <= col(x1) - 0.5)
        & (sy >= col(y0) - 0.5) & (sy <= col(y1) - 0.5)
    )


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] bool → f32 (y0, x0, y1, x1) with exclusive upper bounds; an
    empty mask gives (H, W, 0, 0), as the JAX package's static-shape form."""
    H, W = mask.shape
    rows, cols = mask.any(dim=1), mask.any(dim=0)
    ridx = torch.arange(H, device=mask.device)
    cidx = torch.arange(W, device=mask.device)
    y0 = torch.where(rows, ridx, H).min()
    y1 = torch.where(rows, ridx, -1).max() + 1
    x0 = torch.where(cols, cidx, W).min()
    x1 = torch.where(cols, cidx, -1).max() + 1
    return torch.stack([y0, x0, y1, x1]).to(torch.float32)
