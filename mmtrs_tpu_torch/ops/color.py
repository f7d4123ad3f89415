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


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 ``sqrt`` correctly rounded on every device.

    PyTorch's CPU f32 ``sqrt`` is not IEEE on every build: on 2.13 (AVX2
    and AVX-512 alike) it is one ulp from the correctly rounded root on ~22 %
    of inputs in [0.4, 1), and its f64 ``sqrt`` is one ulp off on ~1 %. An
    f32 input's root lies at least 2^-50 (relative) from every f32 rounding
    midpoint, four f64 ulps, so the f64 root within one ulp rounds to the
    correctly rounded f32 root. CUDA's f32 ``sqrt`` is ``sqrtf``, already
    correctly rounded, so the card keeps it and the kernels' bits."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


# Elements a CPU call of a transcendental takes at once: below ATen's grain
# of 2048, so each call runs on the calling thread.
_SERIAL_CHUNK = 1024


def serial_cpu(op, x: torch.Tensor) -> torch.Tensor:
    """``op(x, out=...)`` (``torch.log``, ``torch.exp``) with every element
    computed on the calling thread when ``x`` lies on the CPU.

    PyTorch's CPU log (MKL's vector math) split over the intra-op threads
    now and then gives one thread's whole share other last bits than the
    calling thread gives the same values, so a plain version's u8 result
    changed from run to run. Calls of at most ``_SERIAL_CHUNK`` elements run
    where they are made, and give one answer under any thread count. A
    CUDA tensor takes ``op`` whole, as the kernels' bit-equality needs."""
    if x.device.type != "cpu" or x.numel() <= _SERIAL_CHUNK:
        return op(x)
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.numel(), _SERIAL_CHUNK):
        op(flat[s : s + _SERIAL_CHUNK], out=out[s : s + _SERIAL_CHUNK])
    return out.reshape(x.shape)


def _pow_el(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p for x > 0 as exp(p·log(max(x, 1e-12))); the caller guards the domain."""
    return serial_cpu(torch.exp, p * serial_cpu(torch.log, torch.clamp_min(x, 1e-12)))


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


# HSV. ``%`` in the JAX package is floor-mod; torch.remainder computes it
# the same way (fmod plus a sign fix), bit for bit on the CPU.


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """float32 RGB 0..255 → OpenCV-scaled HSV: H ∈ [0, 180), S, V ∈ [0, 255]."""
    x = fdiv(rgb.float(), 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    one = torch.ones_like(c)
    safe_c = torch.where(c > 0, c, one)
    h = torch.where(
        v == r,
        (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    h = torch.where(c > 0, torch.remainder(h * 60.0, 360.0), torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, one), torch.zeros_like(c))
    return torch.stack([h / 2.0, s * 255.0, v * 255.0], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """OpenCV-scaled HSV → float32 RGB 0..255."""
    h = torch.remainder(hsv[..., 0] * 2.0, 360.0)
    s = fdiv(hsv[..., 1], 255.0)
    v = fdiv(hsv[..., 2], 255.0)
    c = v * s
    hp = fdiv(h, 60.0)
    xc = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.remainder(torch.floor(hp).to(torch.int32), 6)

    def pick(*t):
        out = t[5]
        for k in range(4, -1, -1):
            out = torch.where(idx == k, t[k], out)
        return out

    m = v - c
    rgb = torch.stack(
        [pick(c, xc, z, z, xc, c), pick(xc, c, c, xc, z, z), pick(z, z, xc, c, c, xc)], dim=-1
    )
    return torch.clamp((rgb + m[..., None]) * 255.0, 0.0, 255.0)


def hsv_shift(imgs: torch.Tensor, dh: torch.Tensor, ds: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """HueSaturationValue: per-image shifts [B] in OpenCV HSV units (H mod 180,
    S and V clipped to 0..255) → float32 RGB 0..255."""
    hsv = rgb_to_hsv(imgs)
    h = torch.remainder(hsv[..., 0] + dh[:, None, None], 180.0)
    s = torch.clamp(hsv[..., 1] + ds[:, None, None], 0.0, 255.0)
    v = torch.clamp(hsv[..., 2] + dv[:, None, None], 0.0, 255.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))
