"""Joint image + tabular dual-task model, stream 2 of the final system (port
of mmtrs_tpu/models/mm_joint.py: ``TabMLP``, ``MMJointDualHead``).

A backbone's pooled features (``create_model(model_name, num_classes=0)``,
bf16 by default as the serving ensemble builds it) ⊕ a tabular MLP
9→64→64 (Dense → BatchNorm → ReLU, twice, always f32) → two f32 linear
heads: the hard classification logit and the soft regression logit. The
MLP's BatchNorm has Flax's default ε 1e-5. Eval only: dropout is off and
training comes with the training slice. Parameter names follow the Flax
tree (see models/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmtrs_tpu_torch.models.backbones.efficientnet import BatchNorm
from mmtrs_tpu_torch.models.backbones.factory import create_model, feature_dim


class TabMLP(nn.Module):
    def __init__(self, in_features: int = 9, hidden: int = 64):
        super().__init__()
        self.fc0 = nn.Linear(in_features, hidden)
        self.bn0 = BatchNorm(hidden, eps=1e-5)
        self.fc1 = nn.Linear(hidden, hidden)
        self.bn1 = BatchNorm(hidden, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.fc0(x)))
        return F.relu(self.bn1(self.fc1(x)))


class MMJointDualHead(nn.Module):
    def __init__(self, model_name: str = "efficientnet_b4", tab_hidden: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = create_model(model_name, num_classes=0, dtype=dtype)
        self.tab_mlp = TabMLP(9, tab_hidden)
        d = feature_dim(model_name) + tab_hidden
        self.head_cls = nn.Linear(d, 1)
        self.head_reg = nn.Linear(d, 1)

    def forward(self, x_img: torch.Tensor, x_tab: torch.Tensor):
        """x_img: [B, H, W, 3] ImageNet-normalised; x_tab: [B, 9]
        standardised features → (logit_cls [B], logit_reg [B]), f32."""
        f = torch.cat([self.backbone(x_img), self.tab_mlp(x_tab.float())], dim=-1)
        return self.head_cls(f)[..., 0], self.head_reg(f)[..., 0]
