"""Molar saliency proposer → crop box, batched (port of
mmtrs_tpu/models/segmenter.py ``SaliencySegmenter.propose_boxes``).

"Toothness" = Rec.601 brightness × a centre prior; the seed is the top
(1 − quantile) of a 4×4-pooled bf16 saliency map (threshold by 16-step
bisection), grown to the bright object inside a 25%-dilated seed window,
gated by the reference's mean-saturation ≥ 40 metal filter and a minimum
area; invalid proposals fall back to the centre square.
"""

from __future__ import annotations

from typing import Protocol

import torch

from mmtrs_tpu_torch.ops.color import fdiv


class Segmenter(Protocol):
    def propose_boxes(self, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """imgs [B, H, W, 3] 0..255 → (boxes [B, 4] (y0, x0, y1, x1), valid [B] bool)."""
        ...


class SaliencySegmenter:
    """Classical tooth proposer with the reference's mask-selection gates."""

    def __init__(
        self,
        min_saturation: float = 40.0,
        min_area_frac: float = 0.005,
        centre_sigma_frac: float = 0.5,
        quantile: float = 0.80,
    ):
        self.min_saturation = min_saturation
        self.min_area_frac = min_area_frac
        self.centre_sigma_frac = centre_sigma_frac
        self.quantile = quantile

    def propose_boxes(self, imgs: torch.Tensor):
        x = imgs.float()
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        B, H, W = r.shape
        dev = x.device
        l = 0.299 * r + 0.587 * g + 0.114 * b
        cmax = torch.maximum(torch.maximum(r, g), b)
        cmin = torch.minimum(torch.minimum(r, g), b)
        sat = torch.where(
            cmax > 0, (cmax - cmin) / torch.clamp_min(cmax, 1e-6), torch.zeros_like(cmax)
        ) * 255.0

        yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        sy = H * self.centre_sigma_frac
        sx = W * self.centre_sigma_frac
        ty = fdiv(yy - H / 2, sy)
        tx = fdiv(xx - W / 2, sx)
        centre_prior = torch.exp(-(ty * ty + tx * tx))
        sal = l * centre_prior  # bright AND central

        # per-image quantile by 16 bisection steps on a 4×4-pooled bf16 map
        h4, w4 = (H // 4) * 4, (W // 4) * 4
        pooled = sal[:, :h4, :w4].reshape(B, h4 // 4, 4, w4 // 4, 4).mean(dim=(2, 4))
        flat = pooled.reshape(B, -1).to(torch.bfloat16).float()
        lo = flat.min(dim=1).values
        hi = flat.max(dim=1).values
        target = 1.0 - self.quantile  # fraction above the threshold
        for _ in range(16):
            mid = 0.5 * (lo + hi)
            frac_above = fdiv((flat > mid[:, None]).sum(dim=1).float(), flat.shape[1])
            above = frac_above > target
            lo = torch.where(above, mid, lo)
            hi = torch.where(above, hi, mid)
        thr = 0.5 * (lo + hi)
        seed = sal >= thr[:, None, None]

        ridx = torch.arange(H, dtype=torch.float32, device=dev)
        cidx = torch.arange(W, dtype=torch.float32, device=dev)

        def mask_bbox(mask):
            rows = mask.any(dim=2)
            cols = mask.any(dim=1)
            y0 = torch.where(rows, ridx, float(H)).min(dim=1).values
            y1 = torch.where(rows, ridx, -1.0).max(dim=1).values + 1.0
            x0 = torch.where(cols, cidx, float(W)).min(dim=1).values
            x1 = torch.where(cols, cidx, -1.0).max(dim=1).values + 1.0
            return y0, x0, y1, x1

        # grow the seed to the full bright object: threshold brightness at the
        # midpoint of seed and background means, inside a 25%-dilated seed bbox
        sf = seed.float()
        n_seed = torch.clamp_min(sf.sum(dim=(1, 2)), 1.0)
        mean_seed = (l * sf).sum(dim=(1, 2)) / n_seed
        n_rest = torch.clamp_min((1.0 - sf).sum(dim=(1, 2)), 1.0)
        mean_rest = (l * (1.0 - sf)).sum(dim=(1, 2)) / n_rest
        thr_l = 0.5 * (mean_seed + mean_rest)

        sy0, sx0, sy1, sx1 = mask_bbox(seed)
        my = 0.25 * (sy1 - sy0)
        mx = 0.25 * (sx1 - sx0)
        yy1 = ridx[None, :, None]
        xx1 = cidx[None, None, :]
        window = (
            (yy1 >= (sy0 - my)[:, None, None])
            & (yy1 < (sy1 + my)[:, None, None])
            & (xx1 >= (sx0 - mx)[:, None, None])
            & (xx1 < (sx1 + mx)[:, None, None])
        )
        mask = (l >= thr_l[:, None, None]) & window
        # degenerate extent (flat image) → fall back to the seed
        has_ext = mask.any(dim=2).any(dim=1)
        mask = torch.where(has_ext[:, None, None], mask, seed)

        # metal filter: mean saturation over the proposed mask must be ≥ 40
        m = mask.float()
        n = torch.clamp_min(m.sum(dim=(1, 2)), 1.0)
        mean_sat = (sat * m).sum(dim=(1, 2)) / n
        valid = (mean_sat >= self.min_saturation) & (n >= self.min_area_frac * H * W)

        boxes = torch.stack(mask_bbox(mask), dim=1)
        # centre-crop fallback geometry for invalid proposals
        side = float(min(H, W))
        cy0, cx0 = (H - side) / 2.0, (W - side) / 2.0
        centre_box = torch.tensor(
            [cy0, cx0, cy0 + side, cx0 + side], dtype=torch.float32, device=dev
        )
        boxes = torch.where(valid[:, None], boxes, centre_box[None, :])
        return boxes, valid
