"""Static-shape detection ops of the Mask R-CNN (port of
mmtrs_tpu/models/detection/ops.py).

They compute the JAX package's functions, not torchvision's: fixed top-k
proposal counts, padded detections with validity masks, greedy NMS as a
fixed-length loop over a precomputed suppression matrix, RoIAlign with each
tap's coordinate clipped to [0, n − 1] before its hat weights, and the
continuous bilinear mask paste. Where the JAX package ``vmap``s over the
batch these take a leading batch axis.

What differs from the JAX package is the form, never the function:

- ``topk_static`` is a stable descending sort, so equal scores keep the
  lower index first as ``jax.lax.top_k`` does (``torch.topk`` promises no
  order); ``torch.argmax`` takes the first maximum as ``jnp.argmax`` does,
  and an all −inf row gives index 0 with ``valid`` false;
- ``static_nms`` runs its ``k_out`` steps without a host sync: no
  ``.item()``, ``nonzero`` or Python branch on a tensor's value;
- RoIAlign gathers each output's 4 × 4 taps (two samples an axis, two
  taps a sample) from the one FPN level its RoI maps to, where the JAX
  package contracts full hat matrices on every level and picks one after;
- ``paste_mask`` keeps the JAX package's two matmuls, in f32 with TF32 off
  (``Precision.HIGHEST`` there).

Boxes are (x0, y0, x1, y1) in image pixels.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from mmtrs_tpu_torch.ops.color import sqrt_rn

# torchvision BoxCoder clamp: log(1000/16)
_BBOX_XFORM_CLIP = float(np.log(1000.0 / 16.0))


# ---------------------------------------------------------------------------
# Anchors (a copy of the JAX package's numpy function)
# ---------------------------------------------------------------------------


def make_anchors_per_level(
    feat_hw: tuple[int, int],
    stride: int,
    size: float,
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """[H*W*A, 4] anchors for one FPN level (torchvision AnchorGenerator
    semantics: zero-centered cell anchors of `size`, rounded, shifted by
    stride grid)."""
    h, w = feat_hw
    ratios = np.asarray(aspect_ratios, np.float64)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = w_ratios * size
    hs = h_ratios * size
    # torchvision AnchorGenerator.generate_anchors rounds AFTER halving
    base = np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0)  # [A,4]

    shifts_x = np.arange(w, dtype=np.float32) * stride
    shifts_y = np.arange(h, dtype=np.float32) * stride
    sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # [HW,1,4]
    return (shifts + base[None]).reshape(-1, 4).astype(np.float32)


# ---------------------------------------------------------------------------
# Box coding (torchvision BoxCoder, weights per stage)
# ---------------------------------------------------------------------------


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """deltas [..., 4] + anchors [..., 4] → boxes [..., 4]; dw and dh
    clipped at log(1000/16) before the exp."""
    wx, wy, ww, wh = weights
    ax0, ay0, ax1, ay1 = anchors.unbind(-1)
    aw = ax1 - ax0
    ah = ay1 - ay0
    acx = ax0 + 0.5 * aw
    acy = ay0 + 0.5 * ah
    dx, dy, dw, dh = deltas.unbind(-1)
    dx, dy, dw, dh = dx / wx, dy / wy, dw / ww, dh / wh
    dw = torch.clamp_max(dw, _BBOX_XFORM_CLIP)
    dh = torch.clamp_max(dh, _BBOX_XFORM_CLIP)
    cx = dx * aw + acx
    cy = dy * ah + acy
    bw = torch.exp(dw) * aw
    bh = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * bw, cy - 0.5 * bh, cx + 0.5 * bw, cy + 0.5 * bh], dim=-1)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Inverse of decode_boxes (widths and heights floored at 1e-6)."""
    wx, wy, ww, wh = weights
    ax0, ay0, ax1, ay1 = anchors.unbind(-1)
    aw = torch.clamp_min(ax1 - ax0, 1e-6)
    ah = torch.clamp_min(ay1 - ay0, 1e-6)
    acx = ax0 + 0.5 * aw
    acy = ay0 + 0.5 * ah
    bx0, by0, bx1, by1 = boxes.unbind(-1)
    bw = torch.clamp_min(bx1 - bx0, 1e-6)
    bh = torch.clamp_min(by1 - by0, 1e-6)
    bcx = bx0 + 0.5 * bw
    bcy = by0 + 0.5 * bh
    return torch.stack(
        [wx * (bcx - acx) / aw, wy * (bcy - acy) / ah, ww * torch.log(bw / aw), wh * torch.log(bh / ah)], dim=-1
    )


def clip_boxes(boxes: torch.Tensor, img_hw: tuple[int, int]) -> torch.Tensor:
    h, w = img_hw
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack(
        [torch.clamp(x0, 0, w), torch.clamp(y0, 0, h), torch.clamp(x1, 0, w), torch.clamp(y1, 0, h)], dim=-1
    )


# ---------------------------------------------------------------------------
# IoU + static NMS
# ---------------------------------------------------------------------------


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N, 4], b [..., M, 4] → [..., N, M]."""
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0) * torch.clamp_min(a[..., 3] - a[..., 1], 0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0) * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    x0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def static_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float,
    k_out: int,
    groups: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of a batch, fixed output length.

    boxes [B, N, 4], scores [B, N] → (keep_idx [B, k_out] int64, keep_valid
    [B, k_out] bool). With ``groups`` (int [B, N]) boxes of different groups
    never suppress each other (the IoU matrix is masked, as in the JAX
    package). Each step takes the first maximum of the live scores, is
    valid when it is above −inf, kills every box whose IoU with it exceeds
    ``iou_thresh``, then the box itself."""
    B, N = scores.shape
    iou = pairwise_iou(boxes, boxes)
    if groups is not None:
        iou = torch.where(groups[:, :, None] == groups[:, None, :], iou, 0.0)
    suppress = iou > iou_thresh  # [B, N, N]
    live = scores.clone()
    rows = torch.arange(B, device=scores.device)
    neg_inf = torch.full((), -math.inf, dtype=scores.dtype, device=scores.device)
    idx, valid = [], []
    for _ in range(k_out):
        i = torch.argmax(live, dim=1)
        valid.append(live[rows, i] > -math.inf)
        live = torch.where(suppress[rows, i], neg_inf, live)
        live[rows, i] = neg_inf
        idx.append(i)
    return torch.stack(idx, dim=1), torch.stack(valid, dim=1)


def topk_static(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """top-k along the last axis with k clamped statically to the size;
    equal scores keep the lower index first (``jax.lax.top_k``'s order)."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# RoIAlign as a 16-tap gather from each RoI's level
# ---------------------------------------------------------------------------


def _axis_taps(starts: torch.Tensor, ends: torch.Tensor, n_out: int, n_src: int, sampling: int):
    """Per-RoI taps of one axis: starts/ends [...] in feature coordinates →
    (indices [..., n_out, 2·sampling] int64, weights [..., n_out,
    2·sampling]). Sample s of bin i sits at start + (i + (s + 0.5)/sampling)
    · bin size, clipped to [0, n_src − 1]; its two hat taps floor(c) and
    floor(c) + 1 (held in range; the second weighs 0 there) carry
    (1 − f)/sampling and f/sampling."""
    size = (ends - starts) / n_out
    dev = starts.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    s = (torch.arange(sampling, dtype=torch.float32, device=dev) + 0.5) / sampling
    c = starts[..., None, None] + (i[:, None] + s[None, :]) * size[..., None, None]
    c = torch.clamp(c, 0.0, n_src - 1)
    i0 = torch.floor(c)
    f = c - i0
    i0 = i0.long()
    i1 = torch.clamp_max(i0 + 1, n_src - 1)
    idx = torch.cat([i0, i1], dim=-1)
    w = torch.cat([1.0 - f, f], dim=-1) / sampling
    return idx, w


def _gather_taps(table: torch.Tensor, base, iy, wy, ix, wx, row_w) -> torch.Tensor:
    """table [T, C] (every level's positions of every image, row-major);
    base, row_w [B, R] (the RoI's first row and row width in the table);
    iy/wy [B, R, P, Ty], ix/wx [B, R, Q, Tx] → [B, R, P, Q, C] f32, the
    weighted sum of the Ty × Tx taps."""
    B, R, P, Ty = iy.shape
    Q, Tx = ix.shape[2], ix.shape[3]
    C = table.shape[1]
    acc = torch.promote_types(torch.promote_types(table.dtype, wy.dtype), torch.float32)
    out = torch.zeros((B, R, P, Q, C), dtype=acc, device=table.device)
    rows = base[:, :, None, None] + iy * row_w[:, :, None, None]  # [B, R, P, Ty]
    for a in range(Ty):
        for b in range(Tx):
            flat = rows[:, :, :, a, None] + ix[:, :, None, :, b]  # [B, R, P, Q]
            w = wy[:, :, :, a, None] * wx[:, :, None, :, b]
            out += w[..., None] * table.index_select(0, flat.reshape(-1)).to(acc).view(B, R, P, Q, C)
    return out


def _feature_table(feats: list[torch.Tensor]) -> tuple[torch.Tensor, list[int]]:
    """NCHW levels [B, C, H_l, W_l] → ([B·Σ H_l W_l, C] rows, image by
    image and level by level; each level's first row within an image)."""
    B, C = feats[0].shape[:2]
    per_image, offsets, n = [], [], 0
    for f in feats:
        offsets.append(n)
        n += f.shape[2] * f.shape[3]
        per_image.append(f.permute(0, 2, 3, 1).reshape(B, -1, C))
    return torch.cat(per_image, dim=1).reshape(B * n, C), offsets + [n]


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int, spatial_scale: float,
              sampling: int = 2) -> torch.Tensor:
    """feat [B, C, H, W], boxes [B, R, 4] (x0, y0, x1, y1 image coords) →
    [B, R, C, out, out] f32 (torchvision RoIAlign aligned=False with the
    JAX package's tap clip)."""
    B, C, H, W = feat.shape
    R = boxes.shape[1]
    table, (_, n) = _feature_table([feat])
    iy, wy = _axis_taps(boxes[..., 1] * spatial_scale, boxes[..., 3] * spatial_scale, out_size, H, sampling)
    ix, wx = _axis_taps(boxes[..., 0] * spatial_scale, boxes[..., 2] * spatial_scale, out_size, W, sampling)
    base = (torch.arange(B, device=feat.device) * n)[:, None].expand(B, R)
    row_w = torch.full((B, R), W, dtype=torch.long, device=feat.device)
    return _gather_taps(table, base, iy, wy, ix, wx, row_w).permute(0, 1, 4, 2, 3)


def roi_levels(boxes: torch.Tensor, n_levels: int, canonical_size: float = 224.0,
               canonical_level: int = 4) -> torch.Tensor:
    """FPN level of each box (FPN paper eq. 1, torchvision LevelMapper):
    floor(k0 + log2(sqrt(area)/224 + 1e-6)) clamped to [2, 2 + L − 1],
    0-based, int64."""
    areas = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0)
    k = torch.floor(canonical_level + torch.log2(sqrt_rn(areas) / canonical_size + 1e-6))
    return (torch.clamp(k, 2, 2 + n_levels - 1) - 2).long()


def roi_align_multilevel(
    feats: list[torch.Tensor],
    strides: list[int],
    boxes: torch.Tensor,
    out_size: int,
    sampling: int = 2,
    canonical_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """NCHW levels [B, C, H_l, W_l], boxes [B, R, 4] → [B, R, C, out, out]
    f32: each RoI aligned on its own level only (roi_levels), one gather
    from a table of every level."""
    B = boxes.shape[0]
    k = roi_levels(boxes, len(feats), canonical_size, canonical_level)  # [B, R]
    table, offsets = _feature_table(feats)
    taps = []
    for f, s in zip(feats, strides):
        H, W = f.shape[2], f.shape[3]
        sc = 1.0 / s
        taps.append((*_axis_taps(boxes[..., 1] * sc, boxes[..., 3] * sc, out_size, H, sampling),
                     *_axis_taps(boxes[..., 0] * sc, boxes[..., 2] * sc, out_size, W, sampling)))
    sel = [torch.stack(t, dim=0) for t in zip(*taps)]  # iy, wy, ix, wx: [L, B, R, n, T]
    pick = k[None, :, :, None, None]
    iy, wy, ix, wx = (t.gather(0, pick.expand(1, *t.shape[1:]))[0] for t in sel)
    # each RoI's level start and row width, chosen on the device (no copy
    # from the host)
    start, width = torch.zeros_like(k), torch.zeros_like(k)
    for lvl, f in enumerate(feats):
        start = torch.where(k == lvl, offsets[lvl], start)
        width = torch.where(k == lvl, f.shape[3], width)
    base = torch.arange(B, device=boxes.device)[:, None] * offsets[-1] + start
    return _gather_taps(table, base, iy, wy, ix, wx, width).permute(0, 1, 4, 2, 3)


# ---------------------------------------------------------------------------
# Mask pasting (28×28 ROI mask → full-image grid) via two matmuls
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _fp32_matmul():
    """cuBLAS matmuls in full f32 (TF32 off) inside the block, the JAX
    package's ``Precision.HIGHEST``; the flag is restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def paste_mask(mask: torch.Tensor, box: torch.Tensor, img_hw: tuple[int, int]) -> torch.Tensor:
    """mask [..., M, M] probabilities, box [..., 4] (x0, y0, x1, y1) →
    [..., H, W]: the continuous bilinear field of the mask at every image
    pixel centre (torchvision's paste without its integer-box rounding)."""
    M = mask.shape[-1]
    H, W = img_hw
    dev = mask.device
    x0, y0, x1, y1 = box.unbind(-1)
    bw = torch.clamp_min(x1 - x0, 1e-3)
    bh = torch.clamp_min(y1 - y0, 1e-3)
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5 - y0[..., None]) / bh[..., None] * M - 0.5
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 - x0[..., None]) / bw[..., None] * M - 0.5
    src = torch.arange(M, dtype=torch.float32, device=dev)
    wy = torch.clamp_min(1.0 - torch.abs(ys[..., :, None] - src), 0.0)  # [..., H, M]
    wx = torch.clamp_min(1.0 - torch.abs(xs[..., :, None] - src), 0.0)  # [..., W, M]
    with _fp32_matmul():
        return torch.matmul(torch.matmul(wy, mask.to(wy.dtype)), wx.transpose(-1, -2))


def mask_bbox(mask_bool: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool → (y0, x0, y1, x1) f32 [..., 4]; an all-false mask
    gives an empty box (y0 = H > y1 = 0) that the caller gates on."""
    H, W = mask_bool.shape[-2:]
    dev = mask_bool.device
    ridx = torch.arange(H, dtype=torch.float32, device=dev)
    cidx = torch.arange(W, dtype=torch.float32, device=dev)
    rows = mask_bool.any(dim=-1)
    cols = mask_bool.any(dim=-2)
    y0 = torch.where(rows, ridx, float(H)).amin(dim=-1)
    y1 = torch.where(rows, ridx, -1.0).amax(dim=-1) + 1.0
    x0 = torch.where(cols, cidx, float(W)).amin(dim=-1)
    x1 = torch.where(cols, cidx, -1.0).amax(dim=-1) + 1.0
    return torch.stack([y0, x0, y1, x1], dim=-1)
