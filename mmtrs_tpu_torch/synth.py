"""Synthetic tooth-like photographs from a numpy seed, for smoke runs and tests.

A bright, yellowish rotated ellipse (the tooth; mean saturation ≈ 75, above
the segmenter's metal gate of 40) on a dark gum-coloured background with
Gaussian noise. ``angles_deg`` sets each ellipse's major-axis angle, so a
caller can make images that deskew must rotate (|angle| ≥ 15°).
"""

from __future__ import annotations

import numpy as np


def synth_teeth(
    n: int, size: int | tuple[int, int] = 512, seed: int = 0, angles_deg=None
) -> np.ndarray:
    """→ uint8 [n, H, W, 3]. ``angles_deg`` (length n) defaults to uniform
    draws in ±10°."""
    rng = np.random.default_rng(seed)
    H, W = (size, size) if isinstance(size, int) else size
    if angles_deg is None:
        angles_deg = rng.uniform(-10.0, 10.0, n)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    m = min(H, W)
    out = np.empty((n, H, W, 3), dtype=np.uint8)
    for i in range(n):
        cy, cx = H / 2 + rng.normal(0, m * 0.04), W / 2 + rng.normal(0, m * 0.04)
        a, b = m * rng.uniform(0.28, 0.34), m * rng.uniform(0.12, 0.18)
        th = np.deg2rad(angles_deg[i])
        dx, dy = xs - cx, ys - cy
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        mask = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        img = np.array([60.0, 35.0, 40.0], np.float32) + rng.normal(0, 6, (H, W, 3))
        tooth = np.array([228.0, 208.0, 160.0], np.float32)
        img[mask] = tooth + rng.normal(0, 8, (int(mask.sum()), 3))
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out
