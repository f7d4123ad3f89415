"""Gated-attention MIL model, stream 3 of the final system (port of
mmtrs_tpu/models/mil.py: ``AttentionMIL``, ``MILNet``, ``make_eval_bag``).

``A = softmax(w·(tanh(V·H) ⊙ σ(U·H)))``, ``M = Σ A·H`` (Ilse et al. 2018);
an EfficientNet encoder runs on the flattened [B·K, H, W, 3] bag batch.
Bag construction for training (``make_bags``) comes with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mmtrs_tpu_torch.models.backbones.factory import create_model, feature_dim
from mmtrs_tpu_torch.ops.resize import resize_bilinear


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
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.model_name, self.attn_dim = model_name, attn_dim
        self.encoder = create_model(model_name, num_classes=0, dtype=dtype)
        d = feature_dim(model_name)
        self.mil = AttentionMIL(d, attn_dim)
        self.head = nn.Linear(d, 1)

    def forward(self, bags: torch.Tensor):
        """bags: [B, K, H, W, 3] → (logit [B], attention [B, K])."""
        B, K = bags.shape[:2]
        h = self.encoder(bags.reshape((B * K,) + bags.shape[2:]))  # [B·K, D] f32
        m, a = self.mil(h.reshape(B, K, -1))
        return self.head(m)[..., 0], a


def make_eval_bag(imgs: torch.Tensor, out_size: int = 480) -> torch.Tensor:
    """Serving-time bag: resize 512 → centre-crop ``out_size`` per image, all
    images of a case forming one bag (infer_mil.py:116-149)."""
    r = resize_bilinear(imgs, (512, 512))
    off = (512 - out_size) // 2
    return r[:, off : off + out_size, off : off + out_size, :]
