"""Joint image + tabular dual-task model, stream 2 of the final system (port
of mmtrs_tpu/models/mm_joint.py: ``TabMLP``, ``MMJointDualHead``).

A backbone's pooled features (``create_model(model_name, num_classes=0)``,
bf16 by default as the serving ensemble builds it) ⊕ a tabular MLP
9→64→64 (Dense → BatchNorm → ReLU → dropout, twice, always f32) →
dropout → two f32 linear heads: the hard classification logit and the soft
regression logit. The MLP's BatchNorm has Flax's default ε 1e-5 and
momentum 0.9. ``module.eval()`` drops nothing and normalises with the
running statistics; ``module.train()`` is Flax's ``train=True`` (batch
statistics, ``tab_dropout`` after each ReLU, ``head_dropout`` on the
concatenated features, the backbone's drop-path), its bits drawn from the
``generator`` passed to ``forward``. Parameter names follow the Flax tree
(see models/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmtrs_tpu_torch.models.backbones.efficientnet import BatchNorm, dropout
from mmtrs_tpu_torch.models.backbones.factory import create_model, feature_dim


def _drop(x: torch.Tensor, rate: float, training: bool, generator) -> torch.Tensor:
    return dropout(x, rate, generator) if training and rate > 0.0 else x


class TabMLP(nn.Module):
    def __init__(self, in_features: int = 9, hidden: int = 64, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.fc0 = nn.Linear(in_features, hidden)
        self.bn0 = BatchNorm(hidden, eps=1e-5)
        self.fc1 = nn.Linear(hidden, hidden)
        self.bn1 = BatchNorm(hidden, eps=1e-5)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = _drop(F.relu(self.bn0(self.fc0(x))), self.dropout, self.training, generator)
        return _drop(F.relu(self.bn1(self.fc1(x))), self.dropout, self.training, generator)


class MMJointDualHead(nn.Module):
    def __init__(self, model_name: str = "efficientnet_b4", tab_hidden: int = 64,
                 tab_dropout: float = 0.2, head_dropout: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16):
        """The JAX module's rates by default; the backbone's drop-path is
        the factory's 0.1, as in the JAX module."""
        super().__init__()
        self.head_dropout = head_dropout
        self.backbone = create_model(model_name, num_classes=0, dtype=dtype)
        self.tab_mlp = TabMLP(9, tab_hidden, tab_dropout)
        d = feature_dim(model_name) + tab_hidden
        self.head_cls = nn.Linear(d, 1)
        self.head_reg = nn.Linear(d, 1)

    def forward(self, x_img: torch.Tensor, x_tab: torch.Tensor,
                generator: torch.Generator | None = None):
        """x_img: [B, H, W, 3] ImageNet-normalised; x_tab: [B, 9]
        standardised features → (logit_cls [B], logit_reg [B]), f32.
        ``generator`` draws the train-mode dropout and drop-path bits."""
        f = torch.cat([self.backbone(x_img, generator), self.tab_mlp(x_tab.float(), generator)], dim=-1)
        f = _drop(f, self.head_dropout, self.training, generator)
        return self.head_cls(f)[..., 0], self.head_reg(f)[..., 0]
