"""EfficientNet B0–B5 (port of mmtrs_tpu/models/backbones/efficientnet.py).

Layer-for-layer the Flax module: the same block table and width/depth
scaling, BatchNorm ε = 1e-3 computed in f32 as Flax does, SE width
``max(1, block_in_ch // 4)``, TF "SAME" padding (asymmetric at stride 2:
lo = total // 2, hi = the rest, so it is padded explicitly). Public input is
NHWC ``[B, H, W, 3]``; convolutions run on a channels-last NCHW view in the
compute ``dtype`` (bf16 by default), parameters stay f32, and pooled
features come out f32. Parameter names follow the Flax tree (see
models/convert.py).

``module.eval()`` normalises with the running statistics and drops nothing.
``module.train()`` is Flax's ``train=True``: each BatchNorm normalises with
its batch's mean and biased variance (f32, E[x²] − E[x]² clipped at 0, as
Flax's fast variance) and moves its running statistics to
``0.9·running + 0.1·batch``; residual branches are dropped per sample at
``drop_path_rate·block/blocks`` (stochastic depth) and the classifier's
input at ``drop_rate``, where there is a classifier. The random bits come
from the ``generator`` the caller passes to ``forward`` (on the module's
device); training with a rate above 0 and no generator raises.

Under ``parallel.mesh.sharded(group)`` a rank's forward is its shard's part
of the global batch's: train-mode BatchNorm takes Σx and Σx² over the
group (the gradient flowing back through the sum), and a dropout or
drop-path mask is the rank's rows of the global batch's, drawn from the
generator state every rank shares. Outside such a block nothing changes.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmtrs_tpu_torch.parallel.mesh import active_group

# (expand_ratio, channels, num_blocks, stride, kernel)
_BASE_BLOCKS = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# (width_mult, depth_mult, resolution, dropout)
_SCALING = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
}


def _round_channels(c: float, divisor: int = 8) -> int:
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return new


def _round_repeats(r: float) -> int:
    return int(math.ceil(r))


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ConvSame(nn.Module):
    """Conv with TF/Flax "SAME" padding; weight OIHW f32, run in the input dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = (_same_pads(n, self.k, self.stride) for n in x.shape[-2:])
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, 0, 1, self.groups)


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 (NCHW maps, or [B, C] rows) with Flax's
    arithmetic: (x − mean)·(rsqrt(var + ε)·scale) + bias in f32, cast back
    to the input dtype. Eval: the running statistics. Train: the batch's
    mean and biased variance over every axis but 1, computed in f32 as
    E[x²] − E[x]² clipped at 0, and the running statistics updated to
    ``0.9·running + 0.1·batch`` (Flax's default momentum and convention,
    the biased variance in both; ``F.batch_norm`` keeps the unbiased one)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            group = active_group()
            if group is None:
                mean = xf.mean(dim=dims)
                var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
            else:  # the global batch's moments: Σx and Σx² over the group's equal shards
                c = xf.shape[1]
                sums = group.all_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
                count = xf.numel() // c * group.size
                mean = sums[:c] / count
                var = torch.clamp_min(sums[c:] / count - mean * mean, 0.0)
            with torch.no_grad():
                m = 0.9  # Flax BatchNorm's default momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def _keep_mask(shape, rate: float, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    if generator is None:
        raise ValueError("training with dropout or drop-path needs a torch.Generator (forward(..., generator=g))")
    group = active_group()
    if group is None:
        return torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    # the global batch's mask from the generator state every rank shares; this rank's rows
    full = torch.rand((shape[0] * group.size,) + tuple(shape[1:]), generator=generator, device=x.device)
    return full[group.rows(full.shape[0])] < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``DropPath``: each sample kept with probability 1 − rate, the
    kept ones scaled by 1/keep."""
    keep = 1.0 - rate
    mask = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), rate, x, generator)
    return x * mask.to(x.dtype) / keep


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.Dropout``: each element kept with probability 1 − rate and
    scaled by 1/keep, the others 0."""
    keep = 1.0 - rate
    return torch.where(_keep_mask(x.shape, rate, x, generator), x / keep, torch.zeros_like(x))


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.reduce = ConvSame(c, reduced, 1, bias=True)
        self.expand = ConvSame(reduced, c, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int, kernel: int,
                 drop_path: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.drop_path = drop_path
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.pw_expand = ConvSame(in_ch, mid, 1)
            self.bn0 = BatchNorm(mid)
        self.dw = ConvSame(mid, mid, kernel, stride=stride, groups=mid)
        self.bn1 = BatchNorm(mid)
        self.se = SqueezeExcite(mid, max(1, in_ch // 4))
        self.pw_project = ConvSame(mid, out_ch, 1)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = x
        if hasattr(self, "pw_expand"):
            h = F.silu(self.bn0(self.pw_expand(h)))
        h = F.silu(self.bn1(self.dw(h)))
        h = self.bn2(self.pw_project(self.se(h)))
        if not self.residual:
            return h
        if self.training and self.drop_path > 0.0:
            h = drop_path(h, self.drop_path, generator)
        return h + x


class EfficientNet(nn.Module):
    """Returns pooled f32 features [B, num_features] (num_classes=0) or logits."""

    def __init__(self, variant: str = "b0", num_classes: int = 0, drop_rate: float = 0.2,
                 drop_path_rate: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 head_bias_init: float = 0.0):
        super().__init__()
        wm, dm, _, _ = _SCALING[variant]
        self.variant, self.dtype, self.drop_rate = variant, dtype, drop_rate
        self.head_bias_init = head_bias_init
        stem = _round_channels(32 * wm)
        self.conv_stem = ConvSame(3, stem, 3, stride=2)
        self.bn_stem = BatchNorm(stem)
        blocks, cin = {}, stem
        total = sum(_round_repeats(r * dm) for _, _, r, _, _ in _BASE_BLOCKS)
        for si, (e, c, r, s, k) in enumerate(_BASE_BLOCKS):
            out_ch = _round_channels(c * wm)
            for j in range(_round_repeats(r * dm)):
                dp = drop_path_rate * len(blocks) / max(total, 1)
                blocks[f"stage{si}_block{j}"] = MBConv(cin, out_ch, e, s if j == 0 else 1, k, dp)
                cin = out_ch
        self.blocks = nn.ModuleDict(blocks)
        self.num_features = _round_channels(1280 * wm)
        self.conv_head = ConvSame(cin, self.num_features, 1)
        self.bn_head = BatchNorm(self.num_features)
        self.classifier = head(self.num_features, num_classes, head_bias_init)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] (ImageNet-normalised float); ``generator``
        draws the drop-path and dropout bits in train mode."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.silu(self.bn_stem(self.conv_stem(x)))
        for blk in self.blocks.values():
            x = blk(x, generator)
        x = F.silu(self.bn_head(self.conv_head(x)))
        x = x.mean(dim=(2, 3)).float()  # global average pool
        if self.classifier is None:
            return x
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, generator)
        return self.classifier(x)


def feature_dim(variant: str) -> int:
    return _round_channels(1280 * _SCALING[variant][0])


def head(features: int, num_classes: int, bias_init: float = 0.0) -> nn.Linear | None:
    """The classifier Dense of the backbones (None for num_classes 0), its
    bias filled with ``bias_init`` as Flax's ``bias_init`` makes it."""
    if not num_classes:
        return None
    fc = nn.Linear(features, num_classes)
    with torch.no_grad():
        fc.bias.fill_(bias_init)
    return fc


@torch.no_grad()
def lecun_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation, drawn from ``generator``: LeCun-normal
    conv/dense weights (std 1/sqrt(fan_in)), zero biases (a backbone's
    classifier bias its ``head_bias_init``), BatchNorm as the identity
    (scale 1, bias 0, mean 0, var 1); the other parameters (LayerNorm,
    LayerScale, GRN) keep their constructors' Flax values."""
    for m in module.modules():
        if isinstance(m, (ConvSame, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
    for m in module.modules():
        if getattr(m, "classifier", None) is not None and hasattr(m, "head_bias_init"):
            m.classifier.bias.fill_(m.head_bias_init)
    return module


@torch.no_grad()
def calibrate_batchnorm_(module: nn.Module, x: torch.Tensor) -> nn.Module:
    """Set every BatchNorm's running statistics to those of its input on the
    batch ``x`` (one eval-mode forward pass in which each layer normalises
    by its batch statistics), so a randomly initialised network keeps
    unit-scale activations the way a trained one does; with identity
    BatchNorms the pooled features of a random B0 fade to ~1e-7. The
    module's train/eval mode is restored afterwards."""

    def hook(bn, args):
        a = args[0].float()
        dims = (0,) + tuple(range(2, a.ndim))  # every axis but the channels'
        bn.running_mean.copy_(a.mean(dim=dims))
        bn.running_var.copy_(a.var(dim=dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in module.modules()
               if isinstance(m, BatchNorm)]
    was_training = module.training
    module.eval()
    try:
        module(x)
    finally:
        for h in handles:
            h.remove()
        module.train(was_training)
    return module
