"""Batched deskew: edge-orientation estimate + conditional rotation (port of
mmtrs_tpu/ops/deskew.py).

Parity with normalise.py:19-57 as the JAX package states it: a Sobel +
one-step-hysteresis edge map on the 4×4-pooled gray image, the principal
axis of the edge mass from mask-weighted moments, and a rotation (three
shears, replicate border) only where |angle| ≥ 15°.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mmtrs_tpu_torch.ops.augment import subset_apply_
from mmtrs_tpu_torch.ops.color import rgb_to_gray, sqrt_rn
from mmtrs_tpu_torch.ops.warp import rotate_shear3


def _sobel(gray: torch.Tensor):
    """3×3 Sobel via shifts (replicate border), gray: [B, H, W]."""
    p = F.pad(gray[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    tl, tc, tr = p[:, :-2, :-2], p[:, :-2, 1:-1], p[:, :-2, 2:]
    ml, mr = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    bl, bc, br = p[:, 2:, :-2], p[:, 2:, 1:-1], p[:, 2:, 2:]
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    return gx, gy


def canny_lite(gray: torch.Tensor, low: float = 50.0, high: float = 150.0) -> torch.Tensor:
    """Strong edges + weak edges adjacent to strong (1-step hysteresis)."""
    gx, gy = _sobel(gray)
    mag = sqrt_rn(gx * gx + gy * gy)
    strong = mag >= high
    weak = mag >= low
    dil = F.max_pool2d(strong.float()[:, None], 3, stride=1, padding=1)[:, 0]
    return strong | (weak & (dil > 0))


def estimate_skew_angle(
    imgs: torch.Tensor,
    low: float = 50.0,
    high: float = 150.0,
    min_points: int = 10,
    downsample: bool = True,
) -> torch.Tensor:
    """Principal-axis angle (degrees) of the edge mass, per image [B]."""
    gray = rgb_to_gray(imgs.float())
    if downsample:
        B, H, W = gray.shape
        h4, w4 = (H // 4) * 4, (W // 4) * 4
        gray = gray[:, :h4, :w4].reshape(B, h4 // 4, 4, w4 // 4, 4).mean(dim=(2, 4))
    m = canny_lite(gray, low, high).long()
    B, H, W = m.shape
    # the edge mass's moments as exact int64 sums, then f64: an image's angle
    # does not depend on the other images of its batch (on the card a float
    # sum's order follows the batch's shape, which moved angles by ~4e-5°)
    ys = torch.arange(H, device=m.device)[None, :, None]
    xs = torch.arange(W, device=m.device)[None, None, :]
    my_, mx_ = m * ys, m * xs
    n = m.sum(dim=(1, 2))
    sy, sx = (s.sum(dim=(1, 2)).double() for s in (my_, mx_))
    syy, sxx, syx = ((a * b).sum(dim=(1, 2)).double() for a, b in ((my_, ys), (mx_, xs), (my_, xs)))
    safe_n = torch.clamp_min(n, 1).double()
    # covariance of (y, x) like np.cov of the coordinate list; its 1/(n − 1)
    # cancels in the angle
    vyy, vxx, vyx = syy - sy * sy / safe_n, sxx - sx * sx / safe_n, syx - sy * sx / safe_n
    # angle (from the x-axis) of the eigenvector with the larger eigenvalue
    angle = (torch.atan2(2.0 * vyx, vxx - vyy) * (0.5 * 180.0 / math.pi)).float()
    return torch.where(n < min_points, torch.zeros_like(angle), angle)


def deskew_batch(
    imgs: torch.Tensor,
    tolerance_deg: float = 15.0,
    low: float = 50.0,
    high: float = 150.0,
):
    """Rotate each image so its dominant edge axis lies horizontal; skip
    small corrections (|angle| < tolerance). Returns (imgs, applied_angle).

    The rotated images are written back into ``imgs`` itself
    (:func:`subset_apply_`), so the caller passes a batch it owns (the
    pipelines pass the CLAHE stage's fresh output). Only the firing images
    go through the three shears; a u8 batch is stored as u8 after each
    shear (the TPU main path's route, ≤1.5 levels from the JAX CPU path's
    single final quantisation)."""
    B, H, W, _ = imgs.shape
    angle = estimate_skew_angle(imgs, low, high)
    apply = angle.abs() >= tolerance_deg
    eff = torch.where(apply, angle, torch.zeros_like(angle))

    def do_warp(x, a):
        # the reference rotates about (W/2, H/2) (normalise.py:48-56)
        return rotate_shear3(x, a, center_xy=(W / 2.0, H / 2.0)).to(imgs.dtype)

    return subset_apply_(do_warp, imgs, apply, eff), eff
