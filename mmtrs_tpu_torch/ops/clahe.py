"""CLAHE — contrast-limited adaptive histogram equalisation, batched (port of
mmtrs_tpu/ops/clahe.py).

The plain PyTorch version, split in its two halves so the CUDA kernels'
plain versions (ops/kernels/clahe_lab.py) reuse them:

1. :func:`tile_luts` — per-tile 256-bin histograms, OpenCV's integer clip
   limit ``max(int(clip·area/256), 1)`` and integer redistribution
   (``excess // 256`` to every bin, +1 to the first ``residual`` bins at
   step ``max(256 // residual, 1)``), LUT = round(cdf·f32(255/area));
2. :func:`interpolate_luts` — bilinear blend of the 4 neighbouring tile LUTs
   with OpenCV's tile coordinate ``y/th − 0.5`` and edge clamping, in the
   JAX oracle's formula and order.

:func:`clahe` is the plain oracle; :func:`clahe_dispatch` is the L-plane
route through the CUDA kernels K8 and K9 (ops/kernels/clahe.py).
"""

from __future__ import annotations

import torch

from mmtrs_tpu_torch.ops.color import lab_to_rgb, rgb_to_lab

N_BINS = 256


def clip_limit(clip: float, area: int) -> int:
    """OpenCV's integer clip limit, computed in double on the host."""
    return max(int(clip * area / N_BINS), 1)


def tile_luts(pix: torch.Tensor, clip: float, tiles: tuple[int, int]) -> torch.Tensor:
    """pix: integer L [B, H, W] in 0..255 → LUTs [B, ty·tx, 256] float32
    (integer-valued)."""
    B, H, W = pix.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    area = th * tw
    tile = (
        pix.long().reshape(B, ty, th, tx, tw).permute(0, 1, 3, 2, 4).reshape(B, ty * tx, area)
    )
    hist = torch.zeros(B, ty * tx, N_BINS, dtype=torch.int64, device=pix.device)
    hist.scatter_add_(2, tile, torch.ones_like(tile))

    limit = clip_limit(clip, area)
    excess = torch.clamp_min(hist - limit, 0).sum(-1, keepdim=True)
    hist = torch.clamp_max(hist, limit)
    batch_add = excess // N_BINS
    resid = excess - batch_add * N_BINS
    step = torch.clamp_min(N_BINS // torch.clamp_min(resid, 1), 1)
    bins = torch.arange(N_BINS, device=pix.device)
    bonus = ((bins % step) == 0) & ((bins // step) < resid)
    cdf = torch.cumsum(hist + batch_add + bonus.long(), dim=-1).float()
    return torch.clamp(torch.round(cdf * ((N_BINS - 1) / area)), 0, N_BINS - 1)


def interpolate_luts(
    pix: torch.Tensor, lut: torch.Tensor, tiles: tuple[int, int]
) -> torch.Tensor:
    """pix [B, H, W] integer L, lut [B, ty·tx, 256] → blended float32 [B, H, W]."""
    B, H, W = pix.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    dev = pix.device
    f32 = torch.float32
    fy = torch.arange(H, dtype=f32, device=dev) / torch.tensor(float(th), device=dev) - 0.5
    fx = torch.arange(W, dtype=f32, device=dev) / torch.tensor(float(tw), device=dev) - 0.5
    y0 = torch.clamp(torch.floor(fy), 0, ty - 1)
    x0 = torch.clamp(torch.floor(fx), 0, tx - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[None, :, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[None, None, :]
    y0, x0 = y0.long(), x0.long()
    y1 = torch.clamp_max(y0 + 1, ty - 1)
    x1 = torch.clamp_max(x0 + 1, tx - 1)

    lut_flat = lut.reshape(B, ty * tx * N_BINS)
    p = pix.long()

    def g(tiy, tix):
        t = (tiy[:, None] * tx + tix[None, :]) * N_BINS + p  # [B, H, W]
        return torch.gather(lut_flat, 1, t.reshape(B, -1)).reshape(B, H, W)

    v00, v01, v10, v11 = g(y0, x0), g(y0, x1), g(y1, x0), g(y1, x1)
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def check_tiles(H: int, W: int, tiles: tuple[int, int]) -> None:
    if H % tiles[0] or W % tiles[1]:
        raise ValueError(f"image {H}x{W} is not divisible by the tile grid {tiles}")


def clahe(
    l: torch.Tensor, clip: float = 3.0, tiles: tuple[int, int] = (8, 8)
) -> torch.Tensor:
    """l: [B, H, W] float32 in 0..255 (H, W divisible by the tile grid)."""
    B, H, W = l.shape
    check_tiles(H, W, tiles)
    pix = torch.clamp(torch.round(l), 0, N_BINS - 1).long()
    return interpolate_luts(pix, tile_luts(pix, clip, tiles), tiles)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """The chain's u8 store: floor(clip(x, 0, 255) + 0.5) (round-half-up)."""
    return (torch.clamp(x, 0.0, 255.0) + 0.5).to(torch.uint8)


def clahe_dispatch(
    l: torch.Tensor, clip: float = 3.0, tiles: tuple[int, int] = (8, 8)
) -> torch.Tensor:
    """CLAHE on an L plane [B, H, W] f32 0..255 → f32, as
    mmtrs_tpu/ops/clahe.py:clahe_dispatch routes it to ``clahe_pallas``: K8
    then K9 on a CUDA tensor. On a CPU tensor the two wrappers take their
    plain versions, which compute :func:`clahe` bit for bit."""
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_l  # it imports this module

    return clahe_l(l, clip=clip, tiles=tiles)


def clahe_rgb(
    imgs: torch.Tensor,
    clip: float = 3.0,
    tiles: tuple[int, int] = (8, 8),
    quant_l: bool = False,
) -> torch.Tensor:
    """RGB → LAB (rounded, the reference's u8 data path) → CLAHE on L → RGB.
    ``quant_l`` stores the CLAHE output L as u8 round-half-up (cv2's
    saturate_cast<uchar>)."""
    lab = torch.round(rgb_to_lab(imgs))
    l2 = clahe_dispatch(lab[..., 0], clip=clip, tiles=tiles)
    if quant_l:
        l2 = torch.floor(torch.clamp(l2, 0.0, 255.0) + 0.5)
    lab = torch.cat([l2[..., None], lab[..., 1:]], dim=-1)
    return lab_to_rgb(lab)
