"""Gather-free rotation by three shears (port of mmtrs_tpu/ops/warp.py:
``_shift_rows_frac``, ``rotate_shear3``). Images are NHWC."""

from __future__ import annotations

import math

import torch

from mmtrs_tpu_torch.ops.kernels.shift import shift_rows


def _shift_rows_frac(img: torch.Tensor, off: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """out[b, y, x] = in[b, y, x + off[b, y]] (axis 2; axis 1 shifts columns
    along H by off[b, x]); bilinear, replicate border, dtype-preserving (a
    u8 batch is stored round-half-up after the shift)."""
    if img.dtype != torch.uint8:
        img = img.float()
    return shift_rows(img.contiguous(), off.float().contiguous(), axis=axis)


def rotate_shear3(
    imgs: torch.Tensor, angles_deg: torch.Tensor, center_xy=None
) -> torch.Tensor:
    """Batched rotation about the centre via 3 shears; cv2 convention
    (positive angle = counter-clockwise in display coordinates), replicate
    border. angles: [B] degrees, |θ| ≤ 90. A u8 batch stays u8 through every
    shear (the TPU main path's per-shear store)."""
    B, H, W, C = imgs.shape
    cx, cy = center_xy if center_xy is not None else ((W - 1) / 2.0, (H - 1) / 2.0)
    dev = imgs.device
    th = angles_deg.to(device=dev, dtype=torch.float32) * (math.pi / 180.0)
    alpha = -torch.tan(th / 2.0)  # x-shear factor
    beta = torch.sin(th)  # y-shear factor
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :] - cy
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx

    # pass 1: x-shear   out[y, x] = in[y, x + α·(y−cy)]
    out = _shift_rows_frac(imgs, alpha[:, None] * ys, axis=2)
    # pass 2: y-shear   out[y, x] = in[y + β·(x−cx), x]
    out = _shift_rows_frac(out, beta[:, None] * xs, axis=1)
    # pass 3: x-shear
    return _shift_rows_frac(out, alpha[:, None] * ys, axis=2)
