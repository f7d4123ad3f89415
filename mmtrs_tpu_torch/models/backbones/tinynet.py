"""TinyNet, the minimal conv backbone of the tests (port of
mmtrs_tpu/models/backbones/tinynet.py): three stride-2 3×3 convs, each with
BatchNorm and ReLU, then a global mean pool.

Not part of the reference model zoo; the JAX package's serving fixture
trains its tiny fold models with it, so the port's tests can hold it to
trained weights. BatchNorm ε is Flax's default 1e-5 (EfficientNet's is
1e-3). Convolutions and BatchNorm run in the compute ``dtype``; the pooled
features come out f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmtrs_tpu_torch.models.backbones.efficientnet import BatchNorm, ConvSame, dropout, head


class TinyNet(nn.Module):
    """Returns pooled f32 features [B, 4·width] (num_classes=0) or logits."""

    def __init__(self, num_classes: int = 0, width: int = 16, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, head_bias_init: float = 0.0):
        super().__init__()
        self.dtype, self.drop_rate, self.head_bias_init = dtype, drop_rate, head_bias_init
        cin = 3
        for i, mult in enumerate((1, 2, 4)):
            setattr(self, f"conv{i}", ConvSame(cin, width * mult, 3, stride=2))
            setattr(self, f"bn{i}", BatchNorm(width * mult, eps=1e-5))
            cin = width * mult
        self.classifier = head(cin, num_classes, head_bias_init)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] (ImageNet-normalised float)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = x.mean(dim=(2, 3)).float()
        if self.classifier is None:
            return x
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, generator)
        return self.classifier(x)


def feature_dim(width: int = 16) -> int:
    return width * 4
