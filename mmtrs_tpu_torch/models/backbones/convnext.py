"""ConvNeXt / ConvNeXtV2 (port of mmtrs_tpu/models/backbones/convnext.py).

Layer for layer the Flax module: a 4×4/4 stem convolution and LayerNorm, four
stages of (tiny 3-3-9-3, small and base 3-3-27-3) blocks with a LayerNorm and
a 2×2/2 convolution before each stage but the first, a mean pool, the f32
``head_norm`` and, with classes, dropout and the classifier. A block is a 7×7
depthwise convolution, LayerNorm, Dense ×4, GELU, then GRN (v2) or nothing,
Dense back, LayerScale (v1) and drop-path on the residual branch.

The Flax arithmetic, kept where it differs from PyTorch's defaults:

- every convolution pads TF/Flax "SAME" (``ConvSame``), asymmetric where a
  stride does not divide the size;
- ``LayerNorm`` takes its statistics in f32 over the channels as Flax 0.12's
  fast variance, mean(x²) − mean(x)² clipped at 0, normalises in f32 with
  ``rsqrt(var + 1e-6)·scale`` and casts to the block's dtype
  (``F.layer_norm`` takes the two-pass variance);
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- GRN sums x² over H and W in f32 with 1e-12 inside the root, divides by the
  channel mean + 1e-6 and returns ``gamma·(x·nx) + beta + x`` in f32 before
  the cast;
- the drop-path rate of block b is ``rate·b / max(blocks − 1, 1)``
  (EfficientNet's divides by the block count).

Public input is NHWC ``[B, H, W, 3]``. The blocks run NHWC, so LayerNorm,
the Dense layers and GRN act on the last axis, and the depthwise and
downsampling convolutions on its channels-last NCHW view, in the compute
``dtype`` (bf16 by default); parameters stay f32. Parameter names follow the
Flax tree (``models/convert.py``), the blocks under ``blocks``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmtrs_tpu_torch.models.backbones.efficientnet import ConvSame, drop_path, dropout, head

_CONFIGS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon)`` over the last axis (see the module
    docstring), cast to ``dtype`` (None: the input's)."""

    def __init__(self, c: int, eps: float = 1e-6, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype or x.dtype)


class Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to the
    input's dtype, f32 parameters kept."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _conv_nhwc(conv: ConvSame, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on NHWC ``x`` through its channels-last NCHW view."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXtV2) on NHWC ``x``."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt((xf * xf).sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (x * nx.to(x.dtype)) + self.beta + xf).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float, v2: bool, layer_scale_init: float = 1e-6):
        super().__init__()
        self.drop_path = drop_path
        self.dwconv = ConvSame(dim, dim, 7, groups=dim, bias=True)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.grn = GRN(4 * dim) if v2 else None
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = None if v2 else nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.norm(_conv_nhwc(self.dwconv, x))
        h = gelu_tanh(self.pwconv1(h))
        if self.grn is not None:
            h = self.grn(h)
        h = self.pwconv2(h)
        if self.gamma is not None:
            h = h * self.gamma.to(h.dtype)
        if self.training and self.drop_path > 0.0:
            h = drop_path(h, self.drop_path, generator)
        return x + h


class ConvNeXt(nn.Module):
    """Returns the f32 ``head_norm`` features [B, dims[-1]] (num_classes=0)
    or logits."""

    def __init__(self, variant: str = "tiny", v2: bool = False, num_classes: int = 0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 head_bias_init: float = 0.0):
        super().__init__()
        depths, dims = _CONFIGS[variant]
        self.variant, self.v2, self.dtype = variant, v2, dtype
        self.drop_rate, self.head_bias_init = drop_rate, head_bias_init
        self.stem_conv = ConvSame(3, dims[0], 4, stride=4, bias=True)
        self.stem_norm = LayerNorm(dims[0], dtype=dtype)
        total, blocks = sum(depths), {}
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si > 0:
                setattr(self, f"down{si}_norm", LayerNorm(dims[si - 1], dtype=dtype))
                setattr(self, f"down{si}_conv", ConvSame(dims[si - 1], dim, 2, stride=2, bias=True))
            for j in range(depth):
                dp = drop_path_rate * len(blocks) / max(total - 1, 1)
                blocks[f"stage{si}_block{j}"] = ConvNeXtBlock(dim, dp, v2)
        self.blocks = nn.ModuleDict(blocks)
        self.stages = [[n for n in blocks if n.startswith(f"stage{si}_")] for si in range(len(depths))]
        self.num_features = dims[-1]
        self.head_norm = LayerNorm(dims[-1])
        self.classifier = head(dims[-1], num_classes, head_bias_init)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] (ImageNet-normalised float); ``generator``
        draws the drop-path and dropout bits in train mode."""
        x = self.stem_norm(_conv_nhwc(self.stem_conv, x.to(self.dtype)))
        for si, names in enumerate(self.stages):
            if si > 0:
                x = _conv_nhwc(getattr(self, f"down{si}_conv"), getattr(self, f"down{si}_norm")(x))
            for n in names:
                x = self.blocks[n](x, generator)
        x = self.head_norm(x.mean(dim=(1, 2)).float())
        if self.classifier is None:
            return x
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, generator)
        return self.classifier(x)


def feature_dim(variant: str) -> int:
    return _CONFIGS[variant][1][-1]
