"""Colour-space conversions on float32 tensors (port of mmtrs_tpu/ops/color.py).

OpenCV 8-bit conventions: LAB with L scaled to [0, 255] and a, b offset by
+128, sRGB gamma applied; GRAY = 0.299 R + 0.587 G + 0.114 B. Tensors are
float32 0..255, channel-last, any leading batch dims.

pow and cbrt are the same exp/log compositions as the JAX package and the
CUDA kernels (csrc/lab_math.cuh), never ``torch.pow``: a one-ULP difference
at the L quantiser is amplified by the CLAHE LUT to several levels.
"""

from __future__ import annotations

import torch

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875992, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_WHITE = (0.950456, 1.0, 1.088754)
_LAB_DELTA = 0.008856  # (6/29)^3
_LAB_K = 7.787


def _mat3(m, a, b, c):
    return tuple(m[i][0] * a + m[i][1] * b + m[i][2] * c for i in range(3))


def fdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / f32(d)`` as a true IEEE division on every device.

    CUDA PyTorch turns division by a Python scalar into multiplication by its
    reciprocal, which can differ by one ULP from JAX's and the kernels'
    division; a 0-d tensor on the same device keeps the division."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _pow_el(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p for x > 0 as exp(p·log(max(x, 1e-12))); the caller guards the domain."""
    return torch.exp(p * torch.log(torch.clamp_min(x, 1e-12)))


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    cbrt = _pow_el(torch.clamp_min(t, 0.0), 1.0 / 3.0)
    return torch.where(t > _LAB_DELTA, cbrt, _LAB_K * t + 16.0 / 116.0)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        xc <= 0.04045, fdiv(xc, 12.92), _pow_el(fdiv(xc + 0.055, 1.055), 2.4)
    )


def _linear_to_srgb(y: torch.Tensor) -> torch.Tensor:
    y = torch.clamp_min(y, 0.0)
    return torch.where(y <= 0.0031308, 12.92 * y, 1.055 * _pow_el(y, 1.0 / 2.4) - 0.055)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """float32 RGB 0..255 → OpenCV-8U-scaled LAB (L, a, b all 0..255-ish)."""
    x = _srgb_to_linear(fdiv(rgb.float(), 255.0))
    X, Y, Z = _mat3(_RGB2XYZ, x[..., 0], x[..., 1], x[..., 2])
    xn, yn, zn = fdiv(X, _WHITE[0]), fdiv(Y, _WHITE[1]), fdiv(Z, _WHITE[2])
    fx, fy, fz = _f_lab(xn), _f_lab(yn), _f_lab(zn)
    L = torch.where(yn > _LAB_DELTA, 116.0 * fy - 16.0, 903.3 * yn)
    a = 500.0 * (fx - fy) + 128.0
    b = 200.0 * (fy - fz) + 128.0
    return torch.stack([fdiv(L * 255.0, 100.0), a, b], dim=-1)


def _inv_f(f: torch.Tensor) -> torch.Tensor:
    t3 = f * f * f
    return torch.where(t3 > _LAB_DELTA, t3, fdiv(f - 16.0 / 116.0, _LAB_K))


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    L = fdiv(lab[..., 0] * 100.0, 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = fdiv(L + 16.0, 116.0)
    fx = fy + fdiv(a, 500.0)
    fz = fy - fdiv(b, 200.0)
    X = _inv_f(fx) * _WHITE[0]
    Y = _inv_f(fy) * _WHITE[1]
    Z = _inv_f(fz) * _WHITE[2]
    r, g, b2 = _mat3(_XYZ2RGB, X, Y, Z)
    srgb = _linear_to_srgb(torch.stack([r, g, b2], dim=-1))
    return torch.clamp(srgb * 255.0, 0.0, 255.0)
