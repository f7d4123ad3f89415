"""Batched geometric warps (port of mmtrs_tpu/ops/warp.py): the 3×3
transform builders, rotation by three shears, the two-pass affine warp
``warp_affine_shear``, the per-pixel shift ``shift_axis_windowed``, and the
gather warps ``sample_bilinear``, ``warp_affine`` and ``warp_perspective``.

Images are NHWC; matrices are *forward* maps (src→dst) like cv2, and
sampling uses the inverse. The shears and passes run through the CUDA
kernels K3 (``shift_rows``), K4 (``resample_rows``) and K6
(``shift_rows_windowed``), which read NHWC lines along either axis in place
of the TPU route's planar transposes. The gather warps are plain PyTorch on
either device, as their JAX versions are an XLA gather with no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from mmtrs_tpu_torch.ops.kernels.resample import resample_rows
from mmtrs_tpu_torch.ops.kernels.shift import shift_rows, shift_rows_windowed

# -- 3×3 transform builders ------------------------------------------------
#
# Each entry may be a Python number or a tensor of per-image values [B];
# the result is [3, 3] or [B, 3, 3] float32 on the tensors' device.


def _matrix(rows) -> torch.Tensor:
    dev = next((v.device for row in rows for v in row if isinstance(v, torch.Tensor)), None)
    vals = torch.broadcast_tensors(
        *[torch.as_tensor(v, dtype=torch.float32, device=dev) for row in rows for v in row]
    )
    return torch.stack(vals, dim=-1).reshape(vals[0].shape + (len(rows), len(rows[0])))


def rotation_matrix(angle_deg, center_xy, scale=1.0) -> torch.Tensor:
    """cv2.getRotationMatrix2D parity: 2×3 forward map, positive angle =
    counter-clockwise in display coordinates (y down)."""
    a = torch.as_tensor(angle_deg, dtype=torch.float32) * (math.pi / 180.0)
    alpha = torch.cos(a) * scale
    beta = torch.sin(a) * scale
    cx, cy = center_xy
    return _matrix([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ])


def mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3×3 composition ``a @ b`` in full float32 (broadcast products summed,
    never a TF32 matmul)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _to_3x3(m: torch.Tensor) -> torch.Tensor:
    if m.shape[-2:] == (3, 3):
        return m
    pad = torch.tensor([0.0, 0.0, 1.0], dtype=m.dtype, device=m.device).expand(m.shape[:-2] + (1, 3))
    return torch.cat([m, pad], dim=-2)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a 2×3 (or 3×3) transform as 3×3, by the adjugate over the
    determinant (the JAX package's closed form)."""
    m3 = _to_3x3(m)
    a, b, c = m3[..., 0, 0], m3[..., 0, 1], m3[..., 0, 2]
    d, e, f = m3[..., 1, 0], m3[..., 1, 1], m3[..., 1, 2]
    g, h, i = m3[..., 2, 0], m3[..., 2, 1], m3[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    row0 = torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1)
    row1 = torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1)
    row2 = torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def sample_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, border: str = "replicate",
                    cval: float = 0.0) -> torch.Tensor:
    """Bilinear sample of img [H, W, C] at float coords ys/xs [...] →
    [..., C]; neighbours clamped to the image (``replicate``), or every
    sample outside [0, H − 1] × [0, W − 1] set to ``cval`` (``constant``)."""
    H, W = img.shape[0], img.shape[1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)

    def gather(yi, xi):
        return img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]

    out = (gather(y0i, x0i) * (1 - wy) * (1 - wx) + gather(y0i, x0i + 1) * (1 - wy) * wx
           + gather(y0i + 1, x0i) * wy * (1 - wx) + gather(y0i + 1, x0i + 1) * wy * wx)
    if border == "constant":
        inside = ((ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1))[..., None]
        out = torch.where(inside, out, torch.as_tensor(cval, dtype=out.dtype, device=out.device))
    return out


def _warp_one(img, inv3, out_h, out_w, border, cval, perspective):
    yy = torch.arange(out_h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(out_w, dtype=torch.float32, device=img.device)[None, :]
    # the 3×3 coordinate transform unrolled, as the JAX package does it (a
    # matmul may run in TF32 on the card)
    sx = inv3[0, 0] * xx + inv3[0, 1] * yy + inv3[0, 2]
    sy = inv3[1, 0] * xx + inv3[1, 1] * yy + inv3[1, 2]
    if perspective:
        sz = inv3[2, 0] * xx + inv3[2, 1] * yy + inv3[2, 2]
        sz = torch.where(sz.abs() > 1e-8, sz, torch.full_like(sz, 1e-8))
        sx, sy = sx / sz, sy / sz
    return sample_bilinear(img, sy, sx, border, cval)


def warp_affine(imgs: torch.Tensor, matrices: torch.Tensor, out_hw: tuple[int, int] | None = None,
                border: str = "replicate", cval: float = 0.0, perspective: bool = False,
                device: str | torch.device | None = None) -> torch.Tensor:
    """Batched gather warp of f32 [B, H, W, C] by per-sample forward maps
    [B, 2, 3] or [B, 3, 3] (src→dst, cv2 convention) → [B, out_h, out_w,
    C] on ``device`` (None: the images' device)."""
    dev = torch.device(device) if device is not None else imgs.device
    imgs = imgs.to(dev, torch.float32)
    B, H, W, _ = imgs.shape
    out_h, out_w = out_hw or (H, W)
    inv = invert_affine(torch.as_tensor(matrices, dtype=torch.float32).to(dev))
    return torch.stack([_warp_one(imgs[i], inv[i], out_h, out_w, border, cval, perspective) for i in range(B)])


def warp_perspective(imgs: torch.Tensor, matrices: torch.Tensor, out_hw: tuple[int, int] | None = None,
                     border: str = "replicate", cval: float = 0.0,
                     device: str | torch.device | None = None) -> torch.Tensor:
    return warp_affine(imgs, matrices, out_hw, border, cval, perspective=True, device=device)


def identity3() -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32)


def translate3(tx, ty) -> torch.Tensor:
    return _matrix([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]])


def scale3(sx, sy, center_xy=(0.0, 0.0)) -> torch.Tensor:
    cx, cy = center_xy
    s = _matrix([[sx, 0.0, 0.0], [0.0, sy, 0.0], [0.0, 0.0, 1.0]])
    return mat3(mat3(translate3(cx, cy).to(s.device), s), translate3(-cx, -cy).to(s.device))


def rotate3(angle_deg, center_xy) -> torch.Tensor:
    return _to_3x3(rotation_matrix(angle_deg, center_xy))


def hflip3(width: float) -> torch.Tensor:
    return _matrix([[-1.0, 0.0, width - 1], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])


def vflip3(height: float) -> torch.Tensor:
    return _matrix([[1.0, 0.0, 0.0], [0.0, -1.0, height - 1], [0.0, 0.0, 1.0]])


def affineize_homography(h3: torch.Tensor, cx: float, cy: float) -> torch.Tensor:
    """First-order (tangent) affine of homographies [..., 3, 3] at the image
    centre: the stand-in for the gentle augmentation Perspective. Returns
    3×3 affines (last row 0, 0, 1)."""
    p = torch.tensor([cx, cy, 1.0], dtype=torch.float32, device=h3.device)
    w = (h3 * p).sum(dim=-1)
    u, v, s = w[..., 0], w[..., 1], w[..., 2]
    ss = s * s
    j00 = (h3[..., 0, 0] * s - u * h3[..., 2, 0]) / ss
    j01 = (h3[..., 0, 1] * s - u * h3[..., 2, 1]) / ss
    j10 = (h3[..., 1, 0] * s - v * h3[..., 2, 0]) / ss
    j11 = (h3[..., 1, 1] * s - v * h3[..., 2, 1]) / ss
    tx = u / s - (j00 * cx + j01 * cy)
    ty = v / s - (j10 * cx + j11 * cy)
    return _matrix([[j00, j01, tx], [j10, j11, ty], [0.0, 0.0, 1.0]])


# -- rotation by three shears (K3) -------------------------------------------


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


# -- per-pixel shift (K6) ------------------------------------------------------


def shift_axis_windowed(
    imgs: torch.Tensor, off: torch.Tensor, max_shift: int, axis: int = 2
) -> torch.Tensor:
    """Per-pixel fractional shift along one spatial axis:
    ``out[b, y, x] = in[b, y, x + off[b, y, x]]`` (axis 2; axis 1 along H),
    bilinear, edge-replicate sourcing, dtype-preserving (u8 in, u8
    round-half-up out), exact for |off| ≤ max_shift. Beyond that it gives the
    TPU kernel's windowed sum: taps more than ``max_shift`` (+ 1) samples
    from the output position weigh 0, and a source clipped to the first or
    last sample takes it. Combine with an explicit mask for constant
    borders."""
    if imgs.dtype != torch.uint8:
        imgs = imgs.float()
    return shift_rows_windowed(imgs.contiguous(), off.float().contiguous(), int(max_shift), axis)


# -- two-pass affine warp (K4) -------------------------------------------------


def invert_affine_params(mats: torch.Tensor):
    """[B, 2, 3] / [B, 3, 3] forward maps → inverse-map coefficients
    (a, b, c, d, e, f): src_x = a·x + b·y + c, src_y = d·x + e·y + f."""
    inv = invert_affine(mats)
    return (inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2],
            inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2])


def _warp_shear_params(H, W, a, b, c, d, e_safe, f):
    """Per-row offsets of the horizontal pass and per-column offsets of the
    vertical pass, each split as (mean r, deviation from it), so both stages
    of K4 stay in range for flips (α < 0) and large constant offsets."""
    ys_idx = torch.arange(H, dtype=torch.float32, device=a.device)[None, :]
    xs_idx = torch.arange(W, dtype=torch.float32, device=a.device)[None, :]
    alpha_h = a - b * d / e_safe                     # [B]
    beta_h = (b / e_safe)[:, None] * ys_idx + (c - b * f / e_safe)[:, None]
    r_h = beta_h.mean(dim=1)                         # [B]
    off_h = beta_h - r_h[:, None]                    # [B, H]
    beta_v = d[:, None] * xs_idx + f[:, None]        # [B, W]
    r_v = beta_v.mean(dim=1)
    off_v = beta_v - r_v[:, None]                    # [B, W]
    return alpha_h, r_h, off_h, r_v, off_v


def warp_passes(matrices: torch.Tensor, H: int, W: int):
    """The inverse map's coefficients (a, b, c, d, e, f) of forward maps
    ``matrices`` [B, 2, 3] / [B, 3, 3], and K4's (off, alpha, r) for the
    warp's two passes: along W (off [B, H], alpha = a − bd/e) and along H
    (off [B, W], alpha = e, held at |e| ≥ 1e-3)."""
    a, b, c, d, e, f = invert_affine_params(matrices)
    lim = torch.where(e < 0, torch.full_like(e, -1e-3), torch.full_like(e, 1e-3))
    e_safe = torch.where(e.abs() < 1e-3, lim, e)
    alpha_h, r_h, off_h, r_v, off_v = _warp_shear_params(H, W, a, b, c, d, e_safe, f)
    pass_h = (off_h.contiguous(), alpha_h.contiguous(), r_h.contiguous())
    pass_v = (off_v.contiguous(), e_safe.contiguous(), r_v.contiguous())
    return (a, b, c, d, e, f), pass_h, pass_v


def warp_affine_shear(
    imgs: torch.Tensor, matrices: torch.Tensor, border: str = "constant", cval: float = 0.0
) -> torch.Tensor:
    """Batched affine warp (cv2 forward-matrix convention) as the
    Catmull-Smith two-pass decomposition of the inverse map
    src_x = a·x + b·y + c, src_y = d·x + e·y + f:

      pass 1 (K4 along W): tmp[y', x] = in[y', (a − bd/e)·x + (b/e)·y' + c − bf/e]
      pass 2 (K4 along H): out[y, x]  = tmp[e·y + d·x + f, x]

    |e| is held ≥ 1e-3 (|rotation| ≲ 70° after flips keeps it far above
    that). A u8 batch stays u8: the inter-pass intermediate and the output
    are u8 round-half-up stores, as on the TPU main path; f32 stays f32.
    ``border``: "constant" (``cval`` where the source leaves the image) or
    "replicate"."""
    if border not in ("constant", "replicate"):
        raise ValueError(f"warp_affine_shear: border must be 'constant' or 'replicate', got {border!r}")
    B, H, W, C = imgs.shape
    (a, b, c, d, e, f), pass_h, pass_v = warp_passes(matrices.to(device=imgs.device, dtype=torch.float32), H, W)
    x = (imgs if imgs.dtype == torch.uint8 else imgs.float()).contiguous()
    tmp = resample_rows(x, *pass_h, axis=2)
    out = resample_rows(tmp, *pass_v, axis=1)
    if border == "replicate":
        return out
    yy = torch.arange(H, dtype=torch.float32, device=imgs.device)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=imgs.device)[None, None, :]
    col = lambda v: v[:, None, None]
    sx = col(a) * xx + col(b) * yy + col(c)
    sy = col(d) * xx + col(e) * yy + col(f)
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    fill = torch.full((), int(round(cval)) if out.dtype == torch.uint8 else cval,
                      dtype=out.dtype, device=out.device)
    return torch.where(inside[..., None], out, fill)
