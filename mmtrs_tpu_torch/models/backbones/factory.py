"""Model factory (port of mmtrs_tpu/models/backbones/factory.py) — name →
backbone module: EfficientNet B0–B5, ConvNeXt tiny/small/base (v1) and
ConvNeXtV2 tiny/base, and the test net ``test_cnn`` (TinyNet)."""

from __future__ import annotations

import torch
import torch.nn as nn

from mmtrs_tpu_torch.models.backbones import convnext as _cn
from mmtrs_tpu_torch.models.backbones import efficientnet as _en
from mmtrs_tpu_torch.models.backbones import tinynet as _tn

MODEL_REGISTRY: dict[str, dict] = {
    **{
        f"efficientnet_{v}": {"family": "efficientnet", "variant": v}
        for v in ("b0", "b1", "b2", "b3", "b4", "b5")
    },
    **{
        f"tf_efficientnet_{v}_ns": {"family": "efficientnet", "variant": v}
        for v in ("b0", "b1", "b2", "b3", "b4", "b5")
    },
    "convnext_tiny": {"family": "convnext", "variant": "tiny", "v2": False},
    "convnext_small": {"family": "convnext", "variant": "small", "v2": False},
    "convnext_base": {"family": "convnext", "variant": "base", "v2": False},
    "convnextv2_tiny": {"family": "convnext", "variant": "tiny", "v2": True},
    "convnextv2_base": {"family": "convnext", "variant": "base", "v2": True},
    # test/CI-only minimal backbone (see tinynet.py)
    "test_cnn": {"family": "tinynet"},
}


def _spec(model_name: str) -> dict:
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model '{model_name}'; available: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[model_name]


def create_model(
    model_name: str, num_classes: int = 2, drop_rate: float = 0.2, drop_path: float = 0.1,
    dtype: torch.dtype = torch.bfloat16, head_bias_init: float = 0.0,
) -> nn.Module:
    """The JAX factory's defaults: dropout 0.2 before a classifier,
    drop-path 0.1 (TinyNet has no residual branch), the classifier's bias
    at ``head_bias_init``."""
    spec = _spec(model_name)
    if spec["family"] == "tinynet":
        return _tn.TinyNet(num_classes=num_classes, drop_rate=drop_rate, dtype=dtype,
                           head_bias_init=head_bias_init)
    if spec["family"] == "efficientnet":
        return _en.EfficientNet(spec["variant"], num_classes=num_classes, drop_rate=drop_rate,
                                drop_path_rate=drop_path, dtype=dtype, head_bias_init=head_bias_init)
    return _cn.ConvNeXt(spec["variant"], v2=spec["v2"], num_classes=num_classes, drop_rate=drop_rate,
                        drop_path_rate=drop_path, dtype=dtype, head_bias_init=head_bias_init)


def feature_dim(model_name: str) -> int:
    spec = _spec(model_name)
    if spec["family"] == "tinynet":
        return _tn.feature_dim()
    if spec["family"] == "efficientnet":
        return _en.feature_dim(spec["variant"])
    return _cn.feature_dim(spec["variant"])
