"""Batched augmentation presets (port of mmtrs_tpu/ops/augment.py).

- ``legacy`` (augment_records.py:94-130 _legacy_compose): HFlip .5, VFlip
  .05, ShiftScaleRotate (.05/.10/12°) p.9, Perspective .02-.05 p.2,
  OneOf{CLAHE(2.0), BrightnessContrast ±.15, HSV 5/12/8} p.5, GaussNoise var
  5-15 p.2, MotionBlur(5) p.1, Elastic α10 σ5 p.1, CoarseDropout one hole of
  size/24 p.1;
- ``ten`` (:216-332 fixed_ten_variants): one fixed transform per aug_idx %
  10 — hflip, vflip, translate 3-7 %, scale ±10 %, rotate ±25°,
  brightness/contrast, HSV, noise, motion blur, elastic;
- ``simple`` (:170-213): the gentler PIL-approximation set;
- ``randaug``: the MM trainer's timm RandAugment-equivalent (RRC + flip +
  RandAugment(2, m9 ± 0.5, inc1) + RandomErasing .2);
- ``none``.

Drawing and applying are separate. ``draw_<preset>`` makes every per-image
random quantity of a preset on the host, from one CPU generator per (seed,
origin_id, aug_idx) lineage (utils/rng.py), into a ``<Preset>Draws``;
``augment_<preset>`` applies them on the batch's device. The gates, ranges
and distributions are the JAX package's draw structure; its threefry bits
are not reproduced, so a test hands JAX's own draws in through
``<Preset>Draws.from_numpy``. Gaussian noise outside ``legacy``'s kernel K5
is made on the device from one int32 seed per image with K5's counter hash
(:func:`seeded_normals`).

All geometric members compose into one affine warp (kernel K4). ``legacy``
runs its pointwise members as one pass (kernel K5) and stores u8 after every
stage, as the TPU main path does; ``ten``, ``simple`` and ``randaug`` stay
f32 after the warp, as in the JAX package. The p-gated members run on the
images whose gate fired and are written back by kernel K7: inside a chain,
into the buffer the chain itself made (:func:`subset_apply_`); the public
entry points never mutate a tensor their caller passed in.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from mmtrs_tpu_torch.ops.clahe import clahe_rgb, quantize_u8
from mmtrs_tpu_torch.ops.color import hsv_shift, rgb_to_gray, sqrt_rn
from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused
from mmtrs_tpu_torch.ops.kernels.clahe_lab import supports as lab_supports
from mmtrs_tpu_torch.ops.kernels.photometric import (
    N_PARAMS,
    noise_normals_ref,
    photometric,
    photometric_ref as photometrics_pointwise_ref,  # noqa: F401  (the JAX package's name for it)
    supports as photometric_supports,
)
from mmtrs_tpu_torch.ops.kernels.scatter import scatter_rows_
from mmtrs_tpu_torch.ops.warp import (
    _matrix,
    _to_3x3,
    affineize_homography,
    hflip3,
    mat3,
    rotate3,
    rotation_matrix,
    scale3,
    shift_axis_windowed,
    translate3,
    vflip3,
    warp_affine_shear,
)
from mmtrs_tpu_torch.utils.rng import generators_for_batch


def row_ids(on: torch.Tensor, device: torch.device) -> torch.Tensor:
    """int64 ids [n] on ``device`` of the rows where ``on`` [B] bool.

    Gates drawn on the host (every preset's) are indexed on the host, and the
    ids go to the card from pinned memory without a sync; gates that live on
    the card (deskew's) are indexed there, which syncs once, as
    ``index_select`` needs the count anyway."""
    return host_row_ids(on, device) if on.device.type == "cpu" else device_row_ids(on, device)


def host_row_ids(on: torch.Tensor, device: torch.device) -> torch.Tensor:
    idx = torch.nonzero(on.cpu()).flatten()
    if device.type == "cuda":
        idx = idx.pin_memory().to(device, non_blocking=True)
    return idx


def device_row_ids(on: torch.Tensor, device: torch.device) -> torch.Tensor:
    return torch.nonzero(on.to(device)).flatten()


def _apply_rows(op, imgs: torch.Tensor, idx: torch.Tensor, extras) -> torch.Tensor:
    sub_out = op(imgs.index_select(0, idx), *[e.index_select(0, idx) for e in extras])
    if sub_out.dtype != imgs.dtype:
        raise TypeError(
            f"subset_apply: op returned {sub_out.dtype} for a {imgs.dtype} batch; "
            "quantise inside op instead of relying on a cast"
        )
    return sub_out.contiguous()


def subset_apply(op, imgs: torch.Tensor, on: torch.Tensor, *extras: torch.Tensor):
    """Apply a per-image-independent batch op only where ``on[b]``.

    Selects the rows (:func:`row_ids`), runs ``op(sub_imgs, *sub_extras)``
    on them and writes the results back with kernel K7 (``scatter_rows_``)
    into a copy of ``imgs``: the caller's ``imgs`` is never mutated, and
    untouched rows pass through bit-exact. Eager PyTorch has no static
    shapes, so the JAX version's static capacity and full-batch fallback are
    not needed: the output is the same. ``op`` must keep the batch's dtype
    (a u8 chain quantises inside ``op``); otherwise this raises rather than
    cast."""
    idx = row_ids(on, imgs.device)
    if idx.numel() == 0:
        return imgs
    sub_out = _apply_rows(op, imgs, idx, extras)
    return scatter_rows_(imgs.clone(memory_format=torch.contiguous_format), sub_out, idx)


def subset_apply_(op, imgs: torch.Tensor, on: torch.Tensor, *extras: torch.Tensor):
    """:func:`subset_apply` written back by K7 into ``imgs`` itself, with no
    copy of the batch; returns ``imgs``. Only for a contiguous tensor that
    the calling chain made itself and no caller holds: ``op`` reads a copy
    of the selected rows, so writing them back in place is safe."""
    if not imgs.is_contiguous():
        raise ValueError("subset_apply_: needs a contiguous batch to write into")
    idx = row_ids(on, imgs.device)
    if idx.numel() == 0:
        return imgs
    return scatter_rows_(imgs, _apply_rows(op, imgs, idx, extras), idx)


# -- primitives --------------------------------------------------------------


def brightness_contrast(imgs, brightness, contrast):
    """albumentations RandomBrightnessContrast (brightness_by_max):
    out = clip(img·(1 + c) + b·255); brightness, contrast: [B]."""
    col = lambda v: v[:, None, None, None]
    return torch.clamp(imgs * (1.0 + col(contrast)) + col(brightness) * 255.0, 0.0, 255.0)


def seeded_normals(seeds: torch.Tensor, shape) -> torch.Tensor:
    """Standard normals ``shape`` = [B, ...] on the seeds' device, image b's
    from seeds[b] (int32) by K5's counter hash over the element index, so
    kernel K5 and these draw the same stream for the same seed."""
    return noise_normals_ref(seeds, math.prod(shape[1:])).view(tuple(shape))


def gauss_noise(imgs, noise, var):
    """Additive white Gaussian noise: ``noise`` standard normals shaped like
    ``imgs``, ``var`` [B] per image; clipped to 0..255."""
    return torch.clamp(imgs + noise * torch.sqrt(var)[:, None, None, None], 0.0, 255.0)


def _separable_blur(imgs: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Depthwise separable blur of f32 [B, H, W, C] with a 1-d kernel
    (normalised), edge padding; the taps summed in order, first along H."""
    k = k1d / k1d.sum()
    r = (k.shape[0] - 1) // 2
    out = imgs
    for axis in (1, 2):
        n = out.shape[axis]
        src = torch.clamp(torch.arange(-r, n + r, device=imgs.device), 0, n - 1)
        x = out.index_select(axis, src)
        out = sum(x.narrow(axis, i, n) * k[i] for i in range(k.shape[0]))
    return out


def gaussian_blur3(imgs: torch.Tensor) -> torch.Tensor:
    """3×3 Gaussian (cv2's default σ for k = 3)."""
    return _separable_blur(imgs, torch.tensor([0.25, 0.5, 0.25], device=imgs.device))


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


def elastic_offsets(fields: torch.Tensor, alpha: float = 10.0, sigma: float = 5.0):
    """ElasticTransform(α, σ)'s per-pixel offsets from raw uniform(−1, 1)
    fields [B, 2, H, W] (dx, dy) on their device: each smoothed by a
    separable Gaussian and scaled by α, f32 [B, H, W] each; and the window
    ⌈α⌉ + 1 that bounds them (a normalised Gaussian of values in (−1, 1)
    stays in (−1, 1))."""
    _, _, H, W = fields.shape
    radius = int(3 * sigma)
    my = _gauss_band(H, sigma, radius).to(fields.device)
    mx = _gauss_band(W, sigma, radius).to(fields.device)
    f = fields.float()
    smooth = lambda g: torch.matmul(torch.matmul(my, g), mx.T)
    return smooth(f[:, 0]) * alpha, smooth(f[:, 1]) * alpha, int(math.ceil(alpha)) + 1


def elastic(imgs: torch.Tensor, fields: torch.Tensor, alpha: float = 10.0, sigma: float = 5.0):
    """ElasticTransform(α, σ): raw uniform(−1, 1) displacement fields
    ``fields`` [B, 2, H, W] (dx, dy) smoothed by a separable Gaussian, scaled
    by α; the two axes are shifted in turn through kernel K6 (a separable
    stand-in for joint bilinear sampling, as in the JAX package), then a
    constant zero border. u8 stays u8."""
    B, H, W, C = imgs.shape
    dx, dy, win = elastic_offsets(fields.to(imgs.device), alpha, sigma)
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


def _pick(mats: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """mats [B, K, 3, 3], which [B] → [B, 3, 3]: image b's matrix
    ``which[b]`` for which[b] < K, the identity beyond."""
    B, K = mats.shape[:2]
    sel = mats[torch.arange(B), torch.clamp(which, max=K - 1)]
    return torch.where((which < K)[:, None, None], sel, torch.eye(3).expand(B, 3, 3)).contiguous()


# -- host draws -------------------------------------------------------------------


def _slots(*names: str) -> dict[str, int]:
    """Column of each named uniform in a preset's per-image vector."""
    return {name: i for i, name in enumerate(names)}


def draw_uniforms(gens: list[torch.Generator], n: int | None = None) -> torch.Tensor:
    """[B, n] float64 uniforms in [0, 1): one vector call on each image's
    generator (n defaults to the ``legacy`` slots)."""
    n = len(_U) if n is None else n
    return torch.stack([torch.rand(n, generator=g, dtype=torch.float64) for g in gens])


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """uniform(lo, hi) in float32 from a column of uniforms, as
    jax.random.uniform scales."""
    return u.float() * (hi - lo) + lo


def _sign(u: torch.Tensor) -> torch.Tensor:
    """+1 where a bernoulli(0.5) fires (u < 0.5), −1 elsewhere."""
    return torch.where(u < 0.5, 1.0, -1.0)


def _seed_bits(u: torch.Tensor) -> torch.Tensor:
    """int32 seeds from a column of uniforms (32 random bits each)."""
    bits = torch.floor(u * 2.0**32).long()
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def _box_muller(u: torch.Tensor) -> torch.Tensor:
    """[B, 2k] uniforms → [B, 2k] standard normals (float64 Box–Muller)."""
    a, b = u[:, 0::2], u[:, 1::2]
    rad = torch.sqrt(-2.0 * torch.log1p(-a))
    return torch.stack([rad * torch.cos(2 * math.pi * b), rad * torch.sin(2 * math.pi * b)], dim=-1).reshape(u.shape)


def _elastic_fields(gens, on: list[bool], H: int, W: int) -> torch.Tensor:
    """[n, 2, H, W] raw uniform(−1, 1) (dx, dy) fields of the images whose
    elastic member fires, each from its own generator after its uniforms."""
    fields = [torch.rand((2, H, W), generator=g) * 2.0 - 1.0 for g, fired in zip(gens, on) if fired]
    return torch.stack(fields) if fields else torch.zeros((0, 2, H, W))


def _field(dtype: torch.dtype, *trailing: int):
    """A draws field of ``dtype``: per image, [B, *trailing]."""
    return dataclasses.field(metadata={"dtype": dtype, "trailing": trailing})


@dataclasses.dataclass
class _Draws:
    """Base of the presets' draws. Every field is per image ([B, ...]),
    ``mats`` (the f32 [B, 3, 3] forward map of the warp) first, except
    ``elastic_fields`` where a preset has it: the raw uniform(−1, 1)
    (dx, dy) fields f32 [n, 2, H, W] of the n images whose ``elastic_on`` is
    set, in batch order."""

    def __post_init__(self):
        B = self.batch
        for f in dataclasses.fields(self):
            t, dtype = getattr(self, f.name), f.metadata["dtype"]
            if f.name == "elastic_fields":
                n = int(self.elastic_on.sum())
                ok, want = t.dim() == 4 and tuple(t.shape[:2]) == (n, 2), f"[{n}, 2, H, W]"
            else:
                shape = (B, *f.metadata["trailing"])
                ok, want = tuple(t.shape) == shape, list(shape)
            if not ok or t.dtype != dtype:
                raise ValueError(f"{type(self).__name__}.{f.name}: want {dtype} {want}, got {t.dtype} {tuple(t.shape)}")

    @property
    def batch(self) -> int:
        return self.mats.shape[0]

    @classmethod
    def from_numpy(cls, *args, **kwargs):
        """From numpy arrays (e.g. the JAX package's own draws), by field
        order or name; dtypes are cast to the fields' ones, and ``mats`` may
        be [B, 2, 3]."""
        vals = dict(zip((f.name for f in dataclasses.fields(cls)), args), **kwargs)

        def conv(f):
            t = torch.from_numpy(np.array(vals[f.name])).to(f.metadata["dtype"])  # a copy: JAX arrays are read-only
            return _to_3x3(t) if f.name == "mats" else t

        return cls(**{f.name: conv(f) for f in dataclasses.fields(cls)})

    def to(self, device):
        return type(self)(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})

    def take(self, idx):
        """The draws of images ``idx`` (a 1-d index), in that order."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.mats.device)
        out = {}
        for f in dataclasses.fields(self):
            t = getattr(self, f.name)
            if f.name == "elastic_fields":
                on = self.elastic_on
                rank = torch.cumsum(on.long(), 0) - 1  # row of each image's field
                out[f.name] = t[rank[idx[on[idx]]]]
            else:
                out[f.name] = t[idx]
        return type(self)(**out)


# -- the legacy preset ---------------------------------------------------------------

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
_U = _slots(*_SLOTS)
LEGACY_GATES = {
    "hflip": 0.5, "vflip": 0.05, "ssr": 0.9, "persp": 0.2, "oneof": 0.5,
    "noise": 0.2, "dropout": 0.1, "blur": 0.1, "elastic": 0.1,
}


def legacy_gates(u: torch.Tensor) -> dict[str, torch.Tensor]:
    """Which members fired per image ([B] bool each), from the uniforms;
    the OneOf gate is split into its three branches."""
    g = {k: u[:, _U[k]] < p for k, p in LEGACY_GATES.items()}
    which = torch.floor(u[:, _U["oneof_which"]] * 3.0)
    g["clahe"], g["bc"], g["hsv"] = (g["oneof"] & (which == w) for w in range(3))
    return g


def _range(u: torch.Tensor, slot: str, lo: float, hi: float) -> torch.Tensor:
    """uniform(lo, hi) in float32 from a ``legacy`` slot."""
    return _scaled(u[:, _U[slot]], lo, hi)


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
    return params, _seed_bits(u[:, _U["noise_seed"]]), g["clahe"]


@dataclasses.dataclass
class LegacyDraws(_Draws):
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

    mats: torch.Tensor = _field(torch.float32, 3, 3)
    params: torch.Tensor = _field(torch.float32, N_PARAMS)
    seeds: torch.Tensor = _field(torch.int32)
    use_clahe: torch.Tensor = _field(torch.bool)
    blur_on: torch.Tensor = _field(torch.bool)
    blur_theta: torch.Tensor = _field(torch.float32)
    elastic_on: torch.Tensor = _field(torch.bool)
    elastic_fields: torch.Tensor = _field(torch.float32)


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
    return LegacyDraws(
        mats=legacy_geo_mats(u, H, W),
        params=params,
        seeds=seeds,
        use_clahe=use_clahe,
        blur_on=g["blur"],
        blur_theta=_range(u, "blur_theta", 0.0, math.pi),
        elastic_on=g["elastic"],
        elastic_fields=_elastic_fields(gens, g["elastic"].tolist(), H, W),
    )


def legacy_clahe_member(H: int, W: int):
    """The OneOf's CLAHE branch (clip 2.0, 8 × 8 tiles) for H × W images, u8
    in and out, on the route the JAX package's ``_clahe_sub`` takes on a TPU
    (mmtrs_tpu/ops/augment.py:543-558): the fused LAB kernels K1/K2 where
    both its fused photometric pass and those kernels take the shape; else
    CLAHE on the rounded LAB's L plane with a u8 L′ store (``clahe_rgb``,
    K8/K9 on the card), stored u8."""
    if photometric_supports(H, W) and lab_supports(H, W):
        return lambda s: clahe_lab_fused(s, clip=2.0, tiles=(8, 8))
    return lambda s: quantize_u8(clahe_rgb(s.float(), clip=2.0, tiles=(8, 8), quant_l=True))


def legacy_photometrics(out: torch.Tensor, draws: LegacyDraws, img_size: int = 512) -> torch.Tensor:
    """Everything after the geometric warp of the ``legacy`` preset: the
    pointwise pass (K5: OneOf's brightness/contrast and HSV branches, noise,
    dropout), then on the images whose gate fired the OneOf's CLAHE branch
    (:func:`legacy_clahe_member`), motion blur and the elastic shift (K6).
    Noise and dropout run before CLAHE, blur and elastic, as in the JAX
    package. Returns u8: a non-u8 input is quantised once on entry. ``out``
    is never mutated."""
    hole = max(1, img_size // 24)
    d = draws.to(out.device)
    if out.dtype != torch.uint8:
        out = quantize_u8(out)
    out = photometric(out.contiguous(), d.params, d.seeds, hole)
    # K5 made ``out``: the gated members write back into it, with the gates
    # of the caller's draws (on the host when drawn there)
    out = subset_apply_(legacy_clahe_member(out.shape[1], out.shape[2]), out, draws.use_clahe)
    out = subset_apply_(
        lambda s, th: quantize_u8(motion_blur(s.float(), th, ksize=5)), out, draws.blur_on, d.blur_theta
    )
    # the fields are already compacted to the firing images, in batch order
    return subset_apply_(lambda s: elastic(s, d.elastic_fields, 10.0, 5.0), out, draws.elastic_on)


def augment_legacy(imgs: torch.Tensor, draws: LegacyDraws, img_size: int = 512) -> torch.Tensor:
    """The ``legacy`` pipeline on a batch [B, H, W, 3]: one affine warp with a
    constant zero border (K4), then :func:`legacy_photometrics`. → u8."""
    out = warp_affine_shear(imgs, draws.mats, border="constant", cval=0.0)
    return legacy_photometrics(out, draws, img_size)


# -- the ten and simple presets ---------------------------------------------------------


def _variants(aug_idx, n: int | None = None) -> torch.Tensor:
    """The fixed variant aug_idx % 10 of each image, int64 on the host;
    raises unless there are ``n`` of them (when given)."""
    t = aug_idx.cpu() if isinstance(aug_idx, torch.Tensor) else torch.as_tensor(np.asarray(aug_idx))
    if n is not None and t.shape != (n,):
        raise ValueError(f"{n} lineages but aug_idx of shape {tuple(t.shape)}")
    return t.long() % 10


def _check_variants(draws, aug_idx) -> None:
    if not torch.equal(_variants(aug_idx), draws.which.cpu()):
        raise ValueError(f"{type(draws).__name__} were drawn for other variants than aug_idx % 10")


_TEN = _slots(
    "tx", "tx_sign", "ty", "ty_sign", "scale", "angle", "bright", "contrast",
    "dh", "ds", "dv", "noise_var", "noise_seed", "blur_theta",
)


@dataclasses.dataclass
class TenDraws(_Draws):
    """Every per-image random quantity of the ``ten`` preset, for B images
    of H × W, selected by each image's variant as the JAX preset selects:

    - ``mats`` f32 [B, 3, 3]: the warp of variants 0-4, identity for 5-9;
    - ``which`` i64 [B]: the variant, aug_idx % 10;
    - ``params`` f32 [B, 6]: brightness, contrast (variant 5), dh, ds, dv
      (6), noise variance (7), zero elsewhere;
    - ``seeds`` i32 [B]: the noise seeds (:func:`seeded_normals`);
    - ``blur_theta`` f32 [B]: the motion-blur angle (variant 8);
    - ``elastic_fields`` f32 [n, 2, H, W]: the raw fields of the n images of
      variant 9, in batch order."""

    mats: torch.Tensor = _field(torch.float32, 3, 3)
    which: torch.Tensor = _field(torch.int64)
    params: torch.Tensor = _field(torch.float32, 6)
    seeds: torch.Tensor = _field(torch.int32)
    blur_theta: torch.Tensor = _field(torch.float32)
    elastic_fields: torch.Tensor = _field(torch.float32)

    @property
    def elastic_on(self) -> torch.Tensor:
        return self.which == 9


def draw_ten(seed: int, origin_ids, aug_idxs, H: int, W: int, variants) -> TenDraws:
    """The ``ten`` preset's draws on the host, one generator per (seed,
    origin_id, aug_idx) lineage. ``variants`` is the aug_idx that
    :func:`augment_batch` will get (the table builder passes aug_idx − 1);
    the elastic fields are drawn only for the images of variant 9."""
    gens = generators_for_batch(seed, origin_ids, aug_idxs)
    u = draw_uniforms(gens, len(_TEN))
    col = lambda k: u[:, _TEN[k]]
    which = _variants(variants, len(gens))
    c = ((W - 1) / 2.0, (H - 1) / 2.0)
    B = len(gens)
    tx = _scaled(col("tx"), 0.03, 0.07) * _sign(col("tx_sign")) * W
    ty = _scaled(col("ty"), 0.03, 0.07) * _sign(col("ty_sign")) * H
    sc = _scaled(col("scale"), 0.9, 1.1)
    geo = torch.stack([
        hflip3(float(W)).expand(B, 3, 3), vflip3(float(H)).expand(B, 3, 3),
        translate3(tx, ty), scale3(sc, sc, c), rotate3(_scaled(col("angle"), -25.0, 25.0), c),
    ], dim=1)
    on = lambda w, v: torch.where(which == w, v, torch.zeros(B))
    params = torch.stack([
        on(5, _scaled(col("bright"), -0.15, 0.15)), on(5, _scaled(col("contrast"), -0.15, 0.15)),
        on(6, _scaled(col("dh"), -5.0, 5.0)), on(6, _scaled(col("ds"), -12.0, 12.0)),
        on(6, _scaled(col("dv"), -8.0, 8.0)), on(7, _scaled(col("noise_var"), 5.0, 15.0)),
    ], dim=1)
    return TenDraws(
        mats=_pick(geo, which),
        which=which,
        params=params,
        seeds=_seed_bits(col("noise_seed")),
        blur_theta=_scaled(col("blur_theta"), 0.0, math.pi),
        elastic_fields=_elastic_fields(gens, (which == 9).tolist(), H, W),
    )


def _noise_stage(out, on, var, seeds):
    """Gaussian noise of variance ``var`` on the images where ``on``, its
    normals made on the device from ``seeds``; written into ``out``, which
    its callers made themselves."""
    return subset_apply_(lambda s, v, sd: gauss_noise(s, seeded_normals(sd, s.shape), v), out, on, var, seeds)


def ten_photometrics(out: torch.Tensor, draws: TenDraws) -> torch.Tensor:
    """Everything after the warp of the ``ten`` preset, in f32: brightness/
    contrast on every image, then HSV (variant 6), noise (7), motion blur
    (8) and the elastic shift (9) on the images of that variant; clipped to
    0..255."""
    d = draws.to(out.device)
    b, c, dh, ds, dv, var = d.params.unbind(1)
    w = draws.which  # the gates on the host when drawn there
    # brightness_contrast makes the batch the gated members write back into
    out = brightness_contrast(out.float(), b, c).contiguous()
    out = subset_apply_(hsv_shift, out, w == 6, dh, ds, dv)
    out = _noise_stage(out, w == 7, var, d.seeds)
    out = subset_apply_(lambda s, th: motion_blur(s, th, 5), out, w == 8, d.blur_theta)
    out = subset_apply_(lambda s: elastic(s, d.elastic_fields, 10.0, 5.0), out, w == 9)
    return torch.clamp(out, 0.0, 255.0)


def augment_ten(imgs: torch.Tensor, draws: TenDraws, aug_idx) -> torch.Tensor:
    """The ``ten`` preset: variant aug_idx % 10 per image (fixed_ten_variants,
    augment_records.py:216-332). One warp with a constant zero border (K4; a
    u8 batch gives a u8 warp), then :func:`ten_photometrics`. → f32."""
    _check_variants(draws, aug_idx)
    return ten_photometrics(warp_affine_shear(imgs, draws.mats.to(imgs.device), border="constant", cval=0.0), draws)


_SIMPLE = _slots("tx", "ty", "scale", "angle", "pad", "bright", "contrast", "ds", "noise_seed")


@dataclasses.dataclass
class SimpleDraws(_Draws):
    """Every per-image random quantity of the ``simple`` preset, selected by
    variant: ``mats`` f32 [B, 3, 3] (hflip, vflip, translate ±7 %, scale
    ±10 %, rotate ±25°, identity for 5-8, the crop-and-resize zoom of 9),
    ``which`` i64 [B], ``params`` f32 [B, 4] (brightness, contrast of variant
    5; saturation shift of 6; noise variance 64 of 7) and the noise
    ``seeds`` i32 [B]."""

    mats: torch.Tensor = _field(torch.float32, 3, 3)
    which: torch.Tensor = _field(torch.int64)
    params: torch.Tensor = _field(torch.float32, 4)
    seeds: torch.Tensor = _field(torch.int32)


def draw_simple(seed: int, origin_ids, aug_idxs, H: int, W: int, variants) -> SimpleDraws:
    """The ``simple`` preset's draws on the host (see :func:`draw_ten` for
    ``variants``)."""
    gens = generators_for_batch(seed, origin_ids, aug_idxs)
    u = draw_uniforms(gens, len(_SIMPLE))
    col = lambda k: u[:, _SIMPLE[k]]
    which = _variants(variants, len(gens))
    B = len(gens)
    c = ((W - 1) / 2.0, (H - 1) / 2.0)
    sc = _scaled(col("scale"), 0.9, 1.1)
    pad = 2.0 + torch.floor(col("pad") * 5.0).float()  # randint(2, 7)
    zoom = W / (W - 2.0 * pad)
    eye = torch.eye(3).expand(B, 3, 3)
    geo = torch.stack([
        hflip3(float(W)).expand(B, 3, 3), vflip3(float(H)).expand(B, 3, 3),
        translate3(_scaled(col("tx"), -0.07, 0.07) * W, _scaled(col("ty"), -0.07, 0.07) * H),
        scale3(sc, sc, c), rotate3(_scaled(col("angle"), -25.0, 25.0), c),
        eye, eye, eye, eye, scale3(zoom, zoom, c),
    ], dim=1)
    on = lambda w, v: torch.where(which == w, v, torch.zeros(B))
    params = torch.stack([
        on(5, _scaled(col("bright"), -0.1, 0.1)), on(5, _scaled(col("contrast"), -0.1, 0.1)),
        on(6, _scaled(col("ds"), -25.0, 25.0)), on(7, torch.full((B,), 64.0)),  # σ = 8 noise
    ], dim=1)
    return SimpleDraws(mats=_pick(geo, which), which=which, params=params, seeds=_seed_bits(col("noise_seed")))


def simple_photometrics(out: torch.Tensor, draws: SimpleDraws) -> torch.Tensor:
    """Everything after the warp of the ``simple`` preset, in f32:
    brightness/contrast on every image, then a saturation-only HSV shift
    (variant 6), noise σ = 8 (7) and a 3×3 Gaussian blur (8); clipped."""
    d = draws.to(out.device)
    b, c, ds, var = d.params.unbind(1)
    w = draws.which  # the gates on the host when drawn there
    # brightness_contrast makes the batch the gated members write back into
    out = brightness_contrast(out.float(), b, c).contiguous()
    out = subset_apply_(lambda s, sa: hsv_shift(s, torch.zeros_like(sa), sa, torch.zeros_like(sa)), out, w == 6, ds)
    out = _noise_stage(out, w == 7, var, d.seeds)
    out = subset_apply_(gaussian_blur3, out, w == 8)
    return torch.clamp(out, 0.0, 255.0)


def augment_simple(imgs: torch.Tensor, draws: SimpleDraws, aug_idx) -> torch.Tensor:
    """The ``simple`` preset (augment_records.py:170-213), variant aug_idx %
    10: 0 hflip, 1 vflip, 2 translate, 3 scale, 4 rotate, 5 brightness/
    contrast, 6 colour, 7 noise σ 8, 8 Gaussian blur, 9 crop + resize ≈
    centre zoom. → f32."""
    _check_variants(draws, aug_idx)
    return simple_photometrics(warp_affine_shear(imgs, draws.mats.to(imgs.device), border="constant", cval=0.0), draws)


# -- the randaug preset (the MM trainer's regulariser) -----------------------------------
#
# The reference's strongest stream trains under timm create_transform(
# input_size=380, is_training=True, auto_augment="rand-m9-mstd0.5-inc1",
# re_prob=0.2) (train_mm_joint_dualtask.py:72-93): RandomResizedCrop +
# HFlip(.5) + RandAugment(2 ops, each gated Bernoulli(.5) per timm
# AugmentOp(prob=0.5), magnitude N(9, .5) of 10, increasing severity) +
# RandomErasing(p=.2, mode='pixel'). As in the JAX package: RRC, flip and the
# geometric ops compose into ONE affine warp; the photometric ops apply in a
# fixed order with no-op parameters where not drawn; Equalize is left out of
# the pool and RRC clamps its box once instead of torchvision's 10 tries.

_RANDAUG_N_OPS = 14  # 0-4 geometric (into the warp), 5-13 photometric
_RANDAUG_DRAWS = 2
_RANDAUG_MAG, _RANDAUG_MAG_STD = 9.0, 0.5
_RANDAUG_ERASE_P = 0.2
RANDAUG_SLOTS = _slots(
    "rrc_area", "rrc_logr", "rrc_i", "rrc_j", "rrc_flip",
    *(f"{k}{d}" for d in range(_RANDAUG_DRAWS) for k in ("op", "apply", "sign", "mag_a", "mag_b")),
    "erase", "erase_area", "erase_logr", "erase_i", "erase_j", "erase_seed",
)
RANDAUG_PHOT = ("invert", "autoc", "post_step", "solar_thr", "solar_add",
                "color_f", "contrast_f", "bright_f", "sharp_f")


def _rrc_hflip3(u: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """RandomResizedCrop(0.08-1, ratio 3/4-4/3, resized back to [H, W]) +
    HFlip(.5) as one forward affine [B, 3, 3] (torchvision semantics, one
    clamped attempt)."""
    col = lambda k: u[:, RANDAUG_SLOTS[k]]
    area = _scaled(col("rrc_area"), 0.08, 1.0) * (H * W)
    r = torch.exp(_scaled(col("rrc_logr"), math.log(3.0 / 4.0), math.log(4.0 / 3.0)))
    w = torch.clamp(sqrt_rn(area * r), 8.0, float(W))
    h = torch.clamp(sqrt_rn(area / r), 8.0, float(H))
    i = col("rrc_i").float() * (H - h)
    j = col("rrc_j").float() * (W - w)
    # dst→src is axis-aligned: src = s·dst + t (half-pixel centres)
    sx, sy = w / W, h / H
    tx, ty = 0.5 * sx - 0.5 + j, 0.5 * sy - 0.5 + i
    m = _matrix([[1.0 / sx, 0.0, -tx / sx], [0.0, 1.0 / sy, -ty / sy], [0.0, 0.0, 1.0]])
    return torch.where((col("rrc_flip") < 0.5)[:, None, None], mat3(hflip3(float(W)), m), m)


def randaug_ops(u: torch.Tensor) -> torch.Tensor:
    """[B, 2] int64: the op (0-13) each RandAugment draw applies, or 14
    where timm's AugmentOp(prob=0.5) gate did not fire."""
    ops = [torch.floor(u[:, RANDAUG_SLOTS[f"op{d}"]] * _RANDAUG_N_OPS).long() for d in range(_RANDAUG_DRAWS)]
    on = [u[:, RANDAUG_SLOTS[f"apply{d}"]] < 0.5 for d in range(_RANDAUG_DRAWS)]
    return torch.stack([torch.where(g, op, _RANDAUG_N_OPS) for op, g in zip(ops, on)], dim=1)


def randaug_gates(u: torch.Tensor) -> dict[str, torch.Tensor]:
    """Which members fired per image ([B] bool each): ``op0``..``op13``
    (applied by either draw) and ``erase``."""
    ops = randaug_ops(u)
    g = {f"op{k}": (ops == k).any(dim=1) for k in range(_RANDAUG_N_OPS)}
    g["erase"] = u[:, RANDAUG_SLOTS["erase"]] < _RANDAUG_ERASE_P
    return g


def _randaug_params(u: torch.Tensor, H: int, W: int):
    """(geometric forward map [B, 3, 3], photometric params {name: [B]}) of
    the RandAugment draws: each of the 2 draws picks one of 14 ops and
    applies it with p 0.5, magnitude clip(N(9, 0.5), 0, 10)/10 and a random
    sign, with timm's increasing (inc1) severity maps."""
    col = lambda k: u[:, RANDAUG_SLOTS[k]]
    B = u.shape[0]
    c = ((W - 1) / 2.0, (H - 1) / 2.0)
    cx, cy = c
    zero, one = torch.zeros(B), torch.ones(B)
    m_geo = torch.eye(3).expand(B, 3, 3)
    phot = {
        "invert": torch.zeros(B, dtype=torch.bool), "autoc": torch.zeros(B, dtype=torch.bool),
        "post_step": one, "solar_thr": torch.full((B,), 256.0), "solar_add": zero,
        "color_f": one, "contrast_f": one, "bright_f": one, "sharp_f": one,
    }
    about_c = lambda s: mat3(mat3(translate3(cx, cy), s), translate3(-cx, -cy))
    # an op whose gate did not fire is the out-of-range index 14, so every
    # op == k test below is false
    for d, op in enumerate(randaug_ops(u).unbind(1)):
        z = _box_muller(torch.stack([col(f"mag_a{d}"), col(f"mag_b{d}")], dim=1))[:, 0].float()
        m = torch.clamp(_RANDAUG_MAG + z * _RANDAUG_MAG_STD, 0.0, 10.0) / 10.0
        sign = _sign(col(f"sign{d}"))
        shear, t_amt = sign * 0.3 * m, sign * 0.45 * m
        geo = torch.stack([
            rotate3(sign * 30.0 * m, c),
            about_c(_matrix([[one, shear, zero], [zero, one, zero], [zero, zero, one]])),
            about_c(_matrix([[one, zero, zero], [shear, one, zero], [zero, zero, one]])),
            translate3(t_amt * W, zero),
            translate3(zero, t_amt * H),
        ], dim=1)
        m_geo = mat3(_pick(geo, op), m_geo)
        enh = 1.0 + sign * 0.9 * m  # PIL enhance factor, inc1
        yes = torch.ones(B, dtype=torch.bool)
        applied = {  # op → (param, its value where that op applies)
            5: ("invert", yes),
            6: ("autoc", yes),
            # timm PosterizeIncreasing keeps 4 − int(4m) bits: step
            # 2^(4 + int(4m)), at most 128 (one bit kept)
            7: ("post_step", torch.clamp_max(phot["post_step"] * 2.0 ** (4.0 + torch.floor(4.0 * m)), 128.0)),
            8: ("solar_thr", torch.minimum(phot["solar_thr"], 255.0 * (1.0 - m))),
            9: ("solar_add", phot["solar_add"] + 110.0 * m),
            10: ("color_f", phot["color_f"] * enh),
            11: ("contrast_f", phot["contrast_f"] * enh),
            12: ("bright_f", phot["bright_f"] * enh),
            13: ("sharp_f", phot["sharp_f"] * enh),
        }
        for k, (name, v) in applied.items():
            phot[name] = torch.where(op == k, v, phot[name])
    return m_geo, phot


def randaug_geo_mats(u: torch.Tensor, H: int, W: int):
    """([B, 3, 3] composite forward maps — RRC + flip, then the geometric
    ops —, photometric params) from the preset's uniforms."""
    m_ops, phot = _randaug_params(u, H, W)
    return mat3(m_ops, _rrc_hflip3(u, H, W)).contiguous(), phot


@dataclasses.dataclass
class RandaugDraws(_Draws):
    """Every per-image random quantity of the ``randaug`` preset:

    - ``mats`` f32 [B, 3, 3]: RRC + flip + the geometric ops;
    - the photometric params of :data:`RANDAUG_PHOT`, [B] each: ``invert``,
      ``autoc`` bool; ``post_step`` (1 = off), ``solar_thr`` (256 = off),
      ``solar_add``, ``color_f``, ``contrast_f``, ``bright_f``, ``sharp_f``
      (1 = off) f32;
    - ``erase_on`` bool [B] and ``erase_box`` f32 [B, 4] (top, left,
      height, width): RandomErasing's gate and box;
    - ``seeds`` i32 [B]: the erasing fill's normals (:func:`seeded_normals`)."""

    mats: torch.Tensor = _field(torch.float32, 3, 3)
    invert: torch.Tensor = _field(torch.bool)
    autoc: torch.Tensor = _field(torch.bool)
    post_step: torch.Tensor = _field(torch.float32)
    solar_thr: torch.Tensor = _field(torch.float32)
    solar_add: torch.Tensor = _field(torch.float32)
    color_f: torch.Tensor = _field(torch.float32)
    contrast_f: torch.Tensor = _field(torch.float32)
    bright_f: torch.Tensor = _field(torch.float32)
    sharp_f: torch.Tensor = _field(torch.float32)
    erase_on: torch.Tensor = _field(torch.bool)
    erase_box: torch.Tensor = _field(torch.float32, 4)
    seeds: torch.Tensor = _field(torch.int32)


def draw_randaug(seed: int, origin_ids, aug_idxs, H: int, W: int) -> RandaugDraws:
    """The ``randaug`` preset's draws on the host, one generator per
    lineage (the MM trainer's is (seed, dataset row, epoch))."""
    gens = generators_for_batch(seed, origin_ids, aug_idxs)
    u = draw_uniforms(gens, len(RANDAUG_SLOTS))
    col = lambda k: u[:, RANDAUG_SLOTS[k]]
    mats, phot = randaug_geo_mats(u, H, W)
    # RandomErasing(p=.2, scale .02-1/3, ratio .3-3.3), one clamped attempt
    area = _scaled(col("erase_area"), 0.02, 1.0 / 3.0) * (H * W)
    r = torch.exp(_scaled(col("erase_logr"), math.log(0.3), math.log(3.3)))
    w = torch.clamp(sqrt_rn(area * r), 1.0, float(W))
    h = torch.clamp(sqrt_rn(area / r), 1.0, float(H))
    box = torch.stack([col("erase_i").float() * (H - h), col("erase_j").float() * (W - w), h, w], dim=1)
    return RandaugDraws(
        mats=mats, **phot, erase_on=randaug_gates(u)["erase"], erase_box=box,
        seeds=_seed_bits(col("erase_seed")),
    )


def randaug_photometrics(out: torch.Tensor, draws: RandaugDraws) -> torch.Tensor:
    """The drawn photometric ops in f32, with no-op parameters where not
    drawn, in fixed order: invert → autocontrast (per image and channel) →
    posterize → solarize (+ add) → colour → contrast → brightness →
    sharpness (against :func:`gaussian_blur3`)."""
    d = draws.to(out.device)
    col = lambda v: v[:, None, None, None]
    out = out.float()
    out = torch.where(col(d.invert), 255.0 - out, out)
    lo = out.amin(dim=(1, 2), keepdim=True)
    span = torch.clamp_min(out.amax(dim=(1, 2), keepdim=True) - lo, 1.0)
    # 255 / span as a true division (a Python numerator would be a reciprocal multiply)
    stretched = (out - lo) * (torch.full_like(span, 255.0) / span)
    out = torch.where(col(d.autoc), stretched, out)
    step = col(d.post_step)
    out = torch.floor(out / step) * step
    out = torch.where(out >= col(d.solar_thr), 255.0 - out, out)
    out = torch.clamp(torch.where(out < 128.0, out + col(d.solar_add), out), 0.0, 255.0)
    gray = rgb_to_gray(out)[..., None]
    out = torch.clamp(gray + (out - gray) * col(d.color_f), 0.0, 255.0)
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.clamp(mean + (out - mean) * col(d.contrast_f), 0.0, 255.0)
    out = torch.clamp(out * col(d.bright_f), 0.0, 255.0)
    blur = gaussian_blur3(out)
    return torch.clamp(blur + (out - blur) * col(d.sharp_f), 0.0, 255.0)


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def random_erasing(imgs: torch.Tensor, box: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """timm RandomErasing(mode='pixel') on f32 [B, H, W, 3] in 0..255: the
    box [B, 4] (top, left, height, width) of each image is filled with
    clip(mean·255 + N(0, 1)·std·255) per channel (ImageNet statistics, the
    pre-normalisation equivalent of timm's N(0, 1) fill), its normals made
    on the device from ``seeds``. The gate is the caller's."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    top, left, h, w = (v[:, None, None] for v in box.unbind(1))
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    inside = (yy >= top) & (yy < top + h) & (xx >= left) & (xx < left + w)
    mean = torch.tensor(_IMAGENET_MEAN, device=dev) * 255.0
    std = torch.tensor(_IMAGENET_STD, device=dev) * 255.0
    fill = torch.clamp(mean + seeded_normals(seeds, imgs.shape) * std, 0.0, 255.0)
    return torch.where(inside[..., None], fill, imgs)


def augment_randaug(imgs: torch.Tensor, draws: RandaugDraws) -> torch.Tensor:
    """RRC + flip + RandAugment(2, m9 ± 0.5, inc1) + RandomErasing(.2): one
    warp with a grey (128) constant border (K4; timm fills its geometric ops
    with grey, and RRC never leaves the frame), :func:`randaug_photometrics`,
    then the erasing on the images whose gate fired. → f32."""
    d = draws.to(imgs.device)
    out = warp_affine_shear(imgs, d.mats, border="constant", cval=128.0)
    # randaug_photometrics made ``out``: the erasing writes back into it
    out = randaug_photometrics(out, d).contiguous()
    return subset_apply_(random_erasing, out, draws.erase_on, d.erase_box, d.seeds)


# -- dispatch ---------------------------------------------------------------------------


def draw_batch(preset: str, seed: int, origin_ids, aug_idxs, H: int, W: int, aug_idx=None, img_size: int = 512):
    """The host draws that :func:`augment_batch` needs for ``preset`` on a
    batch of (seed, origin_id, aug_idx) lineages of H × W images; ``aug_idx``
    is the one ``ten`` and ``simple`` will be given (None for the others)."""
    if preset == "none":
        return None
    if preset == "legacy":
        return draw_legacy(seed, origin_ids, aug_idxs, H, W, img_size=img_size)
    if preset == "randaug":
        return draw_randaug(seed, origin_ids, aug_idxs, H, W)
    if preset in ("ten", "simple"):
        if aug_idx is None:
            raise ValueError(f"preset {preset!r} needs aug_idx")
        return (draw_ten if preset == "ten" else draw_simple)(seed, origin_ids, aug_idxs, H, W, aug_idx)
    raise ValueError(f"unknown preset: {preset}")


def augment_batch(imgs: torch.Tensor, draws, preset: str, aug_idx=None, img_size: int = 512):
    """Dispatch by preset name (get_augmenter parity, augment_records.py:335-362).
    ``draws`` is the preset's draws type (:func:`draw_batch`); ``ten`` and
    ``simple`` also take ``aug_idx`` [B] (variant aug_idx % 10), as in the
    JAX package. ``legacy`` returns u8, ``ten``/``simple``/``randaug`` f32."""
    if preset == "none":
        return imgs
    if preset == "legacy":
        return augment_legacy(imgs, draws, img_size=img_size)
    if preset == "randaug":
        return augment_randaug(imgs, draws)
    if preset in ("ten", "simple"):
        if aug_idx is None:
            raise ValueError(f"preset {preset!r} needs aug_idx")
        return (augment_ten if preset == "ten" else augment_simple)(imgs, draws, aug_idx)
    raise ValueError(f"unknown preset: {preset}")
