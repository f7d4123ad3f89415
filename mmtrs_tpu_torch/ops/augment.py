"""Batched augmentation: the ``legacy`` preset (port of mmtrs_tpu/ops/augment.py).

The reference's albumentations pipeline (augment_records.py:94-130
_legacy_compose): HFlip .5, VFlip .05, ShiftScaleRotate (.05/.10/12°) p.9,
Perspective .02-.05 p.2, OneOf{CLAHE(2.0), BrightnessContrast ±.15,
HSV 5/12/8} p.5, GaussNoise var 5-15 p.2, MotionBlur(5) p.1, Elastic α10 σ5
p.1, CoarseDropout one hole of size/24 p.1.

Drawing and applying are separate. :func:`draw_legacy` makes every
per-image random quantity of the preset on the host, from one CPU
generator per (seed, origin_id, aug_idx) lineage (utils/rng.py), into a
:class:`LegacyDraws`; :func:`augment_legacy` and
:func:`~mmtrs_tpu_torch.preprocess.preprocess_augment_batch` apply them on
the batch's device. The gates, ranges and distributions are the JAX
package's draw structure; its threefry bits are not reproduced, so a test
hands JAX's own draws in through :meth:`LegacyDraws.from_numpy`.

All geometric members compose into one affine warp (kernel K4); the
pointwise members are one pass (kernel K5); CLAHE (K1/K2), motion blur and
the elastic shift (K6) run on the images whose gate fired
(:func:`subset_apply`). Every stage stores u8, as the TPU main path does.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from mmtrs_tpu_torch.ops.clahe import quantize_u8
from mmtrs_tpu_torch.ops.color import hsv_shift  # noqa: F401  (a primitive of this module in the JAX package)
from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused
from mmtrs_tpu_torch.ops.kernels.photometric import (
    N_PARAMS,
    photometric,
    photometric_ref as photometrics_pointwise_ref,  # noqa: F401  (the JAX package's name for it)
)
from mmtrs_tpu_torch.ops.warp import (
    _to_3x3,
    affineize_homography,
    hflip3,
    mat3,
    rotation_matrix,
    shift_axis_windowed,
    translate3,
    vflip3,
    warp_affine_shear,
)
from mmtrs_tpu_torch.utils.rng import generators_for_batch


def subset_apply(op, imgs: torch.Tensor, on: torch.Tensor, *extras: torch.Tensor):
    """Apply a per-image-independent batch op only where ``on[b]``.

    Selects the rows with a boolean index, runs ``op(sub_imgs, *sub_extras)``
    on them and copies the results back with ``index_copy_`` into a copy of
    ``imgs``; untouched rows pass through bit-exact. Eager PyTorch has no
    static shapes, so the JAX version's static capacity and full-batch
    fallback are not needed: the output is the same. ``op`` must keep the
    batch's dtype (a u8 chain quantises inside ``op``); otherwise this raises
    rather than cast."""
    idx = torch.nonzero(on.to(imgs.device)).flatten()
    if idx.numel() == 0:
        return imgs
    sub_out = op(imgs.index_select(0, idx), *[e.index_select(0, idx) for e in extras])
    if sub_out.dtype != imgs.dtype:
        raise TypeError(
            f"subset_apply: op returned {sub_out.dtype} for a {imgs.dtype} batch; "
            "quantise inside op instead of relying on a cast"
        )
    return imgs.clone().index_copy_(0, idx, sub_out)


# -- primitives --------------------------------------------------------------


def brightness_contrast(imgs, brightness, contrast):
    """albumentations RandomBrightnessContrast (brightness_by_max):
    out = clip(img·(1 + c) + b·255); brightness, contrast: [B]."""
    col = lambda v: v[:, None, None, None]
    return torch.clamp(imgs * (1.0 + col(contrast)) + col(brightness) * 255.0, 0.0, 255.0)


def gauss_noise(imgs, noise, var):
    """Additive white Gaussian noise: ``noise`` standard normals shaped like
    ``imgs``, ``var`` [B] per image; clipped to 0..255."""
    return torch.clamp(imgs + noise * torch.sqrt(var)[:, None, None, None], 0.0, 255.0)


def coarse_dropout(imgs, y0, x0, hole: int):
    """CoarseDropout(max_holes=1, size=hole) at integer origins y0, x0 [B];
    zero fill."""
    B, H, W, _ = imgs.shape
    yy = torch.arange(H, device=imgs.device)[None, :, None]
    xx = torch.arange(W, device=imgs.device)[None, None, :]
    y0, x0 = y0.long()[:, None, None], x0.long()[:, None, None]
    mask = (yy >= y0) & (yy < y0 + hole) & (xx >= x0) & (xx < x0 + hole)
    return torch.where(mask[..., None], torch.zeros_like(imgs), imgs)


def _motion_kernels(theta: torch.Tensor, k: int) -> torch.Tensor:
    """[B, k, k] directional line kernels: k taps along angle θ, splatted
    bilinearly onto a (k+1)² grid, cropped to k² and normalised."""
    B = theta.shape[0]
    r = (k - 1) / 2.0
    t = torch.linspace(-r, r, k, device=theta.device)
    px = t[None] * torch.cos(theta)[:, None] + r
    py = t[None] * torch.sin(theta)[:, None] + r
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    kern = torch.zeros(B, (k + 1) * (k + 1), device=theta.device)
    for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        kern.scatter_add_(1, (y0 + dy) * (k + 1) + (x0 + dx), wt)
    kern = kern.view(B, k + 1, k + 1)[:, :k, :k]
    return kern / kern.sum(dim=(1, 2), keepdim=True)


def motion_blur(imgs: torch.Tensor, theta: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """MotionBlur analog on float32 [B, H, W, C]: per-image angle θ [B] in
    [0, π), k-tap line kernel, edge padding; a cross-correlation written as
    k² shifted multiply-adds in float32 (no cuDNN, so no TF32)."""
    k = ksize
    B, H, W, C = imgs.shape
    kern = _motion_kernels(theta.to(device=imgs.device, dtype=torch.float32), k)
    lo, hi = (k - 1) // 2, k // 2
    x = torch.nn.functional.pad(imgs.permute(0, 3, 1, 2), (lo, hi, lo, hi), mode="replicate")
    out = torch.zeros((B, C, H, W), dtype=torch.float32, device=imgs.device)
    for i in range(k):
        for j in range(k):
            out = out + x[:, :, i : i + H, j : j + W] * kern[:, i, j, None, None, None]
    return out.permute(0, 2, 3, 1)


@functools.cache
def _gauss_band(n: int, sigma: float, radius: int) -> torch.Tensor:
    """[n, n] banded Gaussian smoothing matrix with the edge clamp folded in
    (out = M @ f is the replicate-padded (2·radius+1)-tap correlation);
    weights computed in float64, then float32, as the JAX package does."""
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    kk = np.exp(-(xs**2) / (2 * sigma**2))
    kk = (kk / kk.sum()).astype(np.float32)
    i = np.arange(n)
    m = np.zeros((n, n), np.float32)
    for d in range(-radius, radius + 1):  # (i, j) pairs are distinct within one d
        m[i, np.clip(i + d, 0, n - 1)] += kk[d + radius]
    return torch.from_numpy(m)


def elastic(imgs: torch.Tensor, fields: torch.Tensor, alpha: float = 10.0, sigma: float = 5.0):
    """ElasticTransform(α, σ): raw uniform(−1, 1) displacement fields
    ``fields`` [B, 2, H, W] (dx, dy) smoothed by a separable Gaussian, scaled
    by α; the two axes are shifted in turn through kernel K6 (a separable
    stand-in for joint bilinear sampling, as in the JAX package), then a
    constant zero border. u8 stays u8."""
    B, H, W, C = imgs.shape
    radius = int(3 * sigma)
    my = _gauss_band(H, sigma, radius).to(imgs.device)
    mx = _gauss_band(W, sigma, radius).to(imgs.device)
    f = fields.to(device=imgs.device, dtype=torch.float32)
    smooth = lambda g: torch.matmul(torch.matmul(my, g), mx.T)
    dx = smooth(f[:, 0]) * alpha
    dy = smooth(f[:, 1]) * alpha
    win = int(math.ceil(alpha)) + 1
    out = shift_axis_windowed(imgs, dy, win, axis=1)
    out = shift_axis_windowed(out, dx, win, axis=2)
    ys = torch.arange(H, dtype=torch.float32, device=imgs.device)[None, :, None] + dy
    xs = torch.arange(W, dtype=torch.float32, device=imgs.device)[None, None, :] + dx
    inside = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
    return torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


# -- geometric members ---------------------------------------------------------


def perspective3(s: torch.Tensor, jitter: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """4-corner-jitter homographies [B, 3, 3] (A.Perspective analog): corner
    i moves by jitter[b, i]·s[b]·(W, H) (jitter: standard normals [B, 4, 2]);
    solved by DLT."""
    B = s.shape[0]
    src = torch.tensor([[0.0, 0.0], [W - 1.0, 0.0], [W - 1.0, H - 1.0], [0.0, H - 1.0]])
    dst = src + jitter * s[:, None, None] * torch.tensor([float(W), float(H)])
    A = torch.zeros(B, 8, 8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[:, i, 0], dst[:, i, 1]
        A[:, 2 * i, :3] = torch.tensor([x, y, 1.0])
        A[:, 2 * i, 6], A[:, 2 * i, 7] = -u * x, -u * y
        A[:, 2 * i + 1, 3:6] = torch.tensor([x, y, 1.0])
        A[:, 2 * i + 1, 6], A[:, 2 * i + 1, 7] = -v * x, -v * y
    h = torch.linalg.solve(A, dst.reshape(B, 8))
    return torch.cat([h, torch.ones(B, 1)], dim=1).reshape(B, 3, 3)


def ssr3(ang: torch.Tensor, sc: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor, H: int, W: int):
    """ShiftScaleRotate [B, 3, 3]: rotation by ``ang`` degrees and scale
    ``sc`` about the centre, then a translation by (tx, ty) pixels."""
    m = _to_3x3(rotation_matrix(ang, ((W - 1) / 2.0, (H - 1) / 2.0), sc))
    return mat3(translate3(tx, ty), m)


# -- the legacy preset's draws ---------------------------------------------------

# One vector of uniforms per image, by slot. The gates and ranges are those
# of the JAX draw structure (legacy_geo_mats, photometric_params_legacy,
# legacy_photometrics); its key splits are replaced by these slots.
_SLOTS = (
    "hflip", "vflip", "ssr", "ssr_ang", "ssr_scale", "ssr_tx", "ssr_ty",
    "persp", "persp_s", *(f"persp_j{i}" for i in range(8)),
    "oneof", "oneof_which", "bright", "contrast", "dh", "ds", "dv",
    "noise", "noise_var", "noise_seed", "dropout", "dropout_y0", "dropout_x0",
    "blur", "blur_theta", "elastic",
)
_U = {name: i for i, name in enumerate(_SLOTS)}
LEGACY_GATES = {
    "hflip": 0.5, "vflip": 0.05, "ssr": 0.9, "persp": 0.2, "oneof": 0.5,
    "noise": 0.2, "dropout": 0.1, "blur": 0.1, "elastic": 0.1,
}


def draw_uniforms(gens: list[torch.Generator]) -> torch.Tensor:
    """[B, len(_SLOTS)] float64 uniforms in [0, 1): one vector call on each
    image's generator."""
    return torch.stack([torch.rand(len(_SLOTS), generator=g, dtype=torch.float64) for g in gens])


def legacy_gates(u: torch.Tensor) -> dict[str, torch.Tensor]:
    """Which members fired per image ([B] bool each), from the uniforms;
    the OneOf gate is split into its three branches."""
    g = {k: u[:, _U[k]] < p for k, p in LEGACY_GATES.items()}
    which = torch.floor(u[:, _U["oneof_which"]] * 3.0)
    g["clahe"], g["bc"], g["hsv"] = (g["oneof"] & (which == w) for w in range(3))
    return g


def _range(u: torch.Tensor, slot: str, lo: float, hi: float) -> torch.Tensor:
    """uniform(lo, hi) in float32 from a slot, as jax.random.uniform scales."""
    return u[:, _U[slot]].float() * (hi - lo) + lo


def _box_muller(u: torch.Tensor) -> torch.Tensor:
    """[B, 2k] uniforms → [B, 2k] standard normals (float64 Box–Muller)."""
    a, b = u[:, 0::2], u[:, 1::2]
    rad = torch.sqrt(-2.0 * torch.log1p(-a))
    return torch.stack([rad * torch.cos(2 * math.pi * b), rad * torch.sin(2 * math.pi * b)], dim=-1).reshape(u.shape)


def legacy_geo_mats(u: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, 3, 3] composite forward maps of the preset's geometric members for
    an [H, W] frame: hflip → vflip → ShiftScaleRotate → perspective
    (affine-ised at the centre, so the composite stays affine)."""
    g = legacy_gates(u)
    B = u.shape[0]
    m = torch.eye(3).expand(B, 3, 3)
    gate = lambda k, t: torch.where(g[k][:, None, None], mat3(t, m), m)
    m = gate("hflip", hflip3(float(W)))
    m = gate("vflip", vflip3(float(H)))
    ssr = ssr3(
        _range(u, "ssr_ang", -12.0, 12.0), 1.0 + _range(u, "ssr_scale", -0.10, 0.10),
        _range(u, "ssr_tx", -0.05, 0.05) * W, _range(u, "ssr_ty", -0.05, 0.05) * H, H, W,
    )
    m = gate("ssr", ssr)
    jitter = _box_muller(u[:, _U["persp_j0"] : _U["persp_j7"] + 1]).float().view(B, 4, 2)
    persp = perspective3(_range(u, "persp_s", 0.02, 0.05), jitter, H, W)
    m = gate("persp", affineize_homography(persp, (W - 1) / 2.0, (H - 1) / 2.0))
    return m.contiguous()


def photometric_params_legacy(u: torch.Tensor, H: int, W: int, hole: int):
    """(params [B, 10] float32 in K5's column layout, noise seeds [B] int32,
    use_clahe [B] bool) of the preset's pointwise members."""
    g = legacy_gates(u)
    zero = torch.zeros(u.shape[0])
    on = lambda k, v: torch.where(g[k], v, zero)
    sigma = torch.sqrt(_range(u, "noise_var", 5.0, 15.0)) * g["noise"].float()
    params = torch.stack([
        on("bc", _range(u, "bright", -0.15, 0.15)),
        on("bc", _range(u, "contrast", -0.15, 0.15)),
        on("hsv", _range(u, "dh", -5.0, 5.0)),
        on("hsv", _range(u, "ds", -12.0, 12.0)),
        on("hsv", _range(u, "dv", -8.0, 8.0)),
        g["hsv"].float(),
        sigma,
        g["dropout"].float(),
        torch.floor(u[:, _U["dropout_y0"]] * (H - hole)).float(),
        torch.floor(u[:, _U["dropout_x0"]] * (W - hole)).float(),
    ], dim=1)
    bits = torch.floor(u[:, _U["noise_seed"]] * 2.0**32).long()
    seeds = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return params, seeds, g["clahe"]


@dataclasses.dataclass
class LegacyDraws:
    """Every per-image random quantity of the ``legacy`` preset, for B images
    of H × W:

    - ``mats`` f32 [B, 3, 3]: the geometric forward map;
    - ``params`` f32 [B, 10]: the pointwise members (K5's column layout);
    - ``seeds`` i32 [B]: K5's noise seeds;
    - ``use_clahe`` bool [B]: the OneOf's CLAHE branch;
    - ``blur_on`` bool [B] and ``blur_theta`` f32 [B]: motion blur and its angle;
    - ``elastic_on`` bool [B] and ``elastic_fields`` f32 [n, 2, H, W]: the
      raw uniform(−1, 1) (dx, dy) fields of the n firing images, in batch
      order."""

    mats: torch.Tensor
    params: torch.Tensor
    seeds: torch.Tensor
    use_clahe: torch.Tensor
    blur_on: torch.Tensor
    blur_theta: torch.Tensor
    elastic_on: torch.Tensor
    elastic_fields: torch.Tensor

    def __post_init__(self):
        B = self.mats.shape[0]
        want = {
            "mats": ((B, 3, 3), torch.float32), "params": ((B, N_PARAMS), torch.float32),
            "seeds": ((B,), torch.int32), "use_clahe": ((B,), torch.bool),
            "blur_on": ((B,), torch.bool), "blur_theta": ((B,), torch.float32),
            "elastic_on": ((B,), torch.bool),
        }
        for name, (shape, dtype) in want.items():
            t = getattr(self, name)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"LegacyDraws.{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        n = int(self.elastic_on.sum())
        f = self.elastic_fields
        if f.dtype != torch.float32 or f.dim() != 4 or f.shape[:2] != (n, 2):
            raise ValueError(f"LegacyDraws.elastic_fields: want f32 [{n}, 2, H, W], got {f.dtype} {tuple(f.shape)}")

    @classmethod
    def from_numpy(cls, mats, params, seeds, use_clahe, blur_on, blur_theta, elastic_on, elastic_fields):
        """From numpy arrays (e.g. the JAX package's own draws); dtypes are
        cast to the fields' ones. ``mats`` may be [B, 2, 3]."""
        t = lambda a, dt: torch.from_numpy(np.array(a)).to(dt)  # a copy: JAX arrays are read-only
        return cls(
            _to_3x3(t(mats, torch.float32)), t(params, torch.float32), t(seeds, torch.int32),
            t(use_clahe, torch.bool), t(blur_on, torch.bool), t(blur_theta, torch.float32),
            t(elastic_on, torch.bool), t(elastic_fields, torch.float32),
        )

    @property
    def batch(self) -> int:
        return self.mats.shape[0]

    def to(self, device) -> "LegacyDraws":
        return LegacyDraws(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))

    def take(self, idx) -> "LegacyDraws":
        """The draws of images ``idx`` (a 1-d index), in that order."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.mats.device)
        rank = torch.cumsum(self.elastic_on.long(), 0) - 1  # row of each image's field
        sel = idx[self.elastic_on[idx]]
        per_image = [getattr(self, f.name)[idx] for f in dataclasses.fields(self)[:-1]]
        return LegacyDraws(*per_image, self.elastic_fields[rank[sel]])


def draw_legacy(seed: int, origin_ids, aug_idxs, H: int, W: int, img_size: int = 512) -> LegacyDraws:
    """The ``legacy`` preset's draws for a batch of lineages, on the host.
    Each image's draws come from its own generator (one vector of uniforms,
    then its elastic fields only if that gate fired), so they depend on the
    lineage alone. ``img_size`` sets the dropout hole (max(1, img_size // 24))."""
    gens = generators_for_batch(seed, origin_ids, aug_idxs)
    u = draw_uniforms(gens)
    g = legacy_gates(u)
    hole = max(1, img_size // 24)
    params, seeds, use_clahe = photometric_params_legacy(u, H, W, hole)
    fields = [torch.rand((2, H, W), generator=gen) * 2.0 - 1.0
              for gen, fired in zip(gens, g["elastic"].tolist()) if fired]
    return LegacyDraws(
        mats=legacy_geo_mats(u, H, W),
        params=params,
        seeds=seeds,
        use_clahe=use_clahe,
        blur_on=g["blur"],
        blur_theta=_range(u, "blur_theta", 0.0, math.pi),
        elastic_on=g["elastic"],
        elastic_fields=torch.stack(fields) if fields else torch.zeros((0, 2, H, W)),
    )


# -- applying the preset -----------------------------------------------------------


def legacy_photometrics(out: torch.Tensor, draws: LegacyDraws, img_size: int = 512) -> torch.Tensor:
    """Everything after the geometric warp of the ``legacy`` preset: the
    pointwise pass (K5: OneOf's brightness/contrast and HSV branches, noise,
    dropout), then on the images whose gate fired the OneOf's CLAHE branch
    (K1/K2, clip 2.0), motion blur and the elastic shift (K6). Noise and
    dropout run before CLAHE, blur and elastic, as in the JAX package.
    Returns u8: a non-u8 input is quantised once on entry."""
    hole = max(1, img_size // 24)
    d = draws.to(out.device)
    if out.dtype != torch.uint8:
        out = quantize_u8(out)
    out = photometric(out.contiguous(), d.params, d.seeds, hole)
    out = subset_apply(lambda s: clahe_lab_fused(s, clip=2.0, tiles=(8, 8)), out, d.use_clahe)
    out = subset_apply(
        lambda s, th: quantize_u8(motion_blur(s.float(), th, ksize=5)), out, d.blur_on, d.blur_theta
    )
    # the fields are already compacted to the firing images, in batch order
    return subset_apply(lambda s: elastic(s, d.elastic_fields, 10.0, 5.0), out, d.elastic_on)


def augment_legacy(imgs: torch.Tensor, draws: LegacyDraws, img_size: int = 512) -> torch.Tensor:
    """The ``legacy`` pipeline on a batch [B, H, W, 3]: one affine warp with a
    constant zero border (K4), then :func:`legacy_photometrics`. → u8."""
    out = warp_affine_shear(imgs, draws.mats, border="constant", cval=0.0)
    return legacy_photometrics(out, draws, img_size)


def augment_batch(imgs: torch.Tensor, draws: LegacyDraws | None, preset: str, img_size: int = 512):
    """Dispatch by preset name (get_augmenter parity, augment_records.py:335-362)."""
    if preset == "none":
        return imgs
    if preset == "legacy":
        return augment_legacy(imgs, draws, img_size=img_size)
    if preset in ("ten", "simple", "randaug"):
        raise NotImplementedError(
            f"preset {preset!r} is not ported to mmtrs_tpu_torch yet (ROADMAP.md, Queue 1)"
        )
    raise ValueError(f"unknown preset: {preset}")
