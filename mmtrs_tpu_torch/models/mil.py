"""Gated-attention MIL model, stream 3 of the final system (port of
mmtrs_tpu/models/mil.py: ``AttentionMIL``, ``MILNet``, ``make_bags``,
``make_eval_bag``).

``A = softmax(w·(tanh(V·H) ⊙ σ(U·H)))``, ``M = Σ A·H`` (Ilse et al. 2018);
an EfficientNet encoder runs on the flattened [B·K, H, W, 3] bag batch.
``module.train()`` is Flax's ``train=True``: the encoder's drop-path (0.1,
the factory's) and a dropout of ``drop_rate`` on the pooled feature, their
bits drawn from the ``generator`` passed to ``forward``.

Training bags are K RandomResizedCrop(scale 0.4–1.0) instances of each
image (+ a random horizontal flip), made by :func:`make_bags` from
:class:`BagDraws`. The crop is axis-aligned, so an instance is a separable
bilinear resample whose hat weights ``max(0, 1 − |c − i|)`` have at most two
non-zero taps per axis: the port gathers those two rows and two columns of
the u8 image (the JAX package contracts full [out, H] and [out, W] hat
matrices, mostly zeros, in two einsums).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from mmtrs_tpu_torch.models.backbones.efficientnet import dropout
from mmtrs_tpu_torch.models.backbones.factory import create_model, feature_dim
from mmtrs_tpu_torch.ops.color import fdiv
from mmtrs_tpu_torch.ops.resize import resize_bilinear
from mmtrs_tpu_torch.utils.rng import generator_for_origin


class AttentionMIL(nn.Module):
    """Gated attention pooling over instance features [B, K, D] → ([B, D], [B, K])."""

    def __init__(self, dim: int, attn_dim: int = 128):
        super().__init__()
        self.V = nn.Linear(dim, attn_dim)
        self.U = nn.Linear(dim, attn_dim)
        self.w = nn.Linear(attn_dim, 1, bias=False)

    def forward(self, h: torch.Tensor):
        v = torch.tanh(self.V(h))
        u = torch.sigmoid(self.U(h))
        a = torch.softmax(self.w(v * u)[..., 0], dim=-1)  # [B, K]
        return torch.einsum("bk,bkd->bd", a, h), a


class MILNet(nn.Module):
    def __init__(self, model_name: str = "efficientnet_b0", attn_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16, drop_rate: float = 0.2, drop_path: float = 0.1):
        """The JAX module's rates by default: dropout ``drop_rate`` on the
        pooled feature, the encoder's drop-path ``drop_path``."""
        super().__init__()
        self.model_name, self.attn_dim, self.drop_rate = model_name, attn_dim, drop_rate
        self.encoder = create_model(model_name, num_classes=0, drop_rate=drop_rate, drop_path=drop_path,
                                    dtype=dtype)
        d = feature_dim(model_name)
        self.mil = AttentionMIL(d, attn_dim)
        self.head = nn.Linear(d, 1)

    def forward(self, bags: torch.Tensor, generator: torch.Generator | None = None):
        """bags: [B, K, H, W, 3] → (logit [B], attention [B, K]).
        ``generator`` draws the train-mode dropout and drop-path bits."""
        B, K = bags.shape[:2]
        h = self.encoder(bags.reshape((B * K,) + bags.shape[2:]), generator)  # [B·K, D] f32
        m, a = self.mil(h.reshape(B, K, -1))
        if self.training and self.drop_rate > 0.0:
            m = dropout(m, self.drop_rate, generator)
        return self.head(m)[..., 0], a


@dataclass
class BagDraws:
    """Per [B, K] instance: the crop's area fraction, its top and left as
    unit draws, and whether it is flipped."""

    area: torch.Tensor  # [B, K] float32 in scale_range
    y0: torch.Tensor  # [B, K] float32 in [0, 1)
    x0: torch.Tensor  # [B, K] float32 in [0, 1)
    flip: torch.Tensor  # [B, K] bool

    @staticmethod
    def draw(seed: int, origin_ids, bag_size: int = 12, scale_range=(0.4, 1.0),
             hflip_p: float = 0.5) -> "BagDraws":
        """Four uniforms per instance from each image's (seed, origin_id, 0)
        generator (``utils.rng``): area = lo + (hi − lo)·u₀, y0 = u₁,
        x0 = u₂, flip = u₃ < hflip_p. Not the JAX package's bits."""
        lo, hi = scale_range
        u = torch.stack([torch.rand((bag_size, 4), generator=generator_for_origin(seed, int(o), 0))
                         for o in origin_ids])
        return BagDraws(lo + (hi - lo) * u[..., 0], u[..., 1].contiguous(), u[..., 2].contiguous(),
                        u[..., 3] < hflip_p)

    def to(self, device: str | torch.device) -> "BagDraws":
        """The draws on ``device``; to the card from pinned memory, so the
        host does not wait for it."""
        dev = torch.device(device)
        move = (lambda t: t.pin_memory().to(dev, non_blocking=True)) if dev.type == "cuda" else (lambda t: t.to(dev))
        return BagDraws(*(move(t) for t in (self.area, self.y0, self.x0, self.flip)))

    @staticmethod
    def from_numpy(area, y0, x0, flip) -> "BagDraws":
        """Draws made elsewhere (the tests feed in the JAX package's)."""
        f = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
        return BagDraws(f(area), f(y0), f(x0), torch.from_numpy(np.array(flip, dtype=bool)))


def _taps(c: torch.Tensor, n: int):
    """The two non-zero taps of the hat max(0, 1 − |c − i|) at coordinates
    ``c`` clipped to [0, n − 1]: (i0, i1, w0, w1), the second tap's index
    held in range (its weight is 0 where it would leave it)."""
    c = torch.clamp(c, 0.0, n - 1.0)
    f = torch.floor(c)
    w0 = torch.clamp_min(1.0 - torch.abs(c - f), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(c - (f + 1.0)), 0.0)
    i0 = f.long()
    return i0, torch.clamp_max(i0 + 1, n - 1), w0, w1


def make_bags(imgs: torch.Tensor, draws: BagDraws, out_size: int = 320) -> torch.Tensor:
    """u8 (or float) [B, H, W, C] → f32 0..255 bags [B, K, out, out, C]
    (TeethMILBag parity, train_mil_attention_v1.py:78-115): per instance
    side = √area, crop ch, cw = side·H, side·W at y0·(H − ch), x0·(W − cw);
    src = dst·(crop / out) + origin (no half-pixel offset), the flip
    reversing the output column; bilinear by the two row taps, then the two
    column taps, of each output pixel."""
    B, H, W, C = imgs.shape
    K = draws.area.shape[1]
    dev = imgs.device
    area, y0u, x0u, flip = (t.to(dev) for t in (draws.area, draws.y0, draws.x0, draws.flip))
    side = torch.sqrt(area)
    ch, cw = side * H, side * W
    y0, x0 = y0u * (H - ch), x0u * (W - cw)
    u = torch.arange(out_size, dtype=torch.float32, device=dev)
    ux = torch.where(flip[..., None], (out_size - 1.0) - u, u)
    # true divisions: CUDA PyTorch multiplies by the reciprocal of a
    # Python scalar, which moves a coordinate by an ulp against the CPU's
    sy = u * fdiv(ch, out_size)[..., None] + y0[..., None]  # [B, K, out]
    sx = ux * fdiv(cw, out_size)[..., None] + x0[..., None]
    iy0, iy1, wy0, wy1 = _taps(sy, H)
    ix0, ix1, wx0, wx1 = _taps(sx, W)
    rows = imgs.reshape(B * H, W, C)
    base = (torch.arange(B, device=dev) * H)[:, None, None]
    # the two source rows of every output row, u8: [B·K, out, W, C]
    R = [rows.index_select(0, (base + iy).reshape(-1)).view(B * K, out_size, W, C) for iy in (iy0, iy1)]
    wy0, wy1 = (w.reshape(B * K, out_size, 1, 1) for w in (wy0, wy1))
    cols = []
    for ix in (ix0, ix1):
        idx = ix.reshape(B * K, 1, out_size, 1).expand(B * K, out_size, out_size, C)
        g0, g1 = (torch.gather(r, 2, idx).float() for r in R)
        cols.append(wy0 * g0 + wy1 * g1)  # rows first, as the JAX package's first einsum
    wx0, wx1 = (w.reshape(B * K, 1, out_size, 1) for w in (wx0, wx1))
    return (wx0 * cols[0] + wx1 * cols[1]).view(B, K, out_size, out_size, C)


def make_eval_bag(imgs: torch.Tensor, out_size: int = 480) -> torch.Tensor:
    """Serving-time bag: resize 512 → centre-crop ``out_size`` per image, all
    images of a case forming one bag (infer_mil.py:116-149)."""
    r = resize_bilinear(imgs, (512, 512))
    off = (512 - out_size) // 2
    return r[:, off : off + out_size, off : off + out_size, :]
