"""Flax variables → port state dicts (the inverse of
mmtrs_tpu/models/backbones/convert.py's layout mapping).

Input is the JAX package's variables with every leaf already a numpy array
(``jax.tree.map(np.asarray, variables)``), so this module imports no JAX.
Layouts: conv HWIO → OIHW, depthwise (kh, kw, 1, C) → (C, 1, kh, kw) (the
same transpose), Dense [in, out] → Linear [out, in], BatchNorm
scale/bias/mean/var → weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch


_PARAM_NAMES = {"scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _convert_param(path: str, leaf) -> tuple[str, torch.Tensor]:
    parts = path.split("/")
    name, mod = parts[-1], ".".join(parts[:-1])
    a = np.asarray(leaf)
    if name == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        return f"{mod}.weight", _tensor(a)
    return f"{mod}.{_PARAM_NAMES[name]}", _tensor(a)


def _convert_stat(path: str, leaf) -> tuple[str, torch.Tensor]:
    parts = path.split("/")
    mod = ".".join(parts[:-1])
    return f"{mod}.{_STAT_NAMES[parts[-1]]}", _tensor(leaf)


def _efficientnet_key(key: str, prefix: str) -> str:
    # Flax names the blocks stage{i}_block{j} at the top level; the port
    # keeps them in the ``blocks`` ModuleDict
    head = key.split(".", 1)[0]
    return prefix + ("blocks." + key if head.startswith("stage") else key)


def efficientnet_from_flax(variables: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of Flax ``EfficientNet`` (numpy leaves) →
    state dict of the port's ``EfficientNet``."""
    sd = {}
    for path, leaf in _flatten(variables["params"]).items():
        k, t = _convert_param(path, leaf)
        sd[_efficientnet_key(k, prefix)] = t
    for path, leaf in _flatten(variables["batch_stats"]).items():
        k, t = _convert_stat(path, leaf)
        sd[_efficientnet_key(k, prefix)] = t
    return sd


def milnet_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of Flax ``MILNet`` (numpy leaves) → state
    dict of the port's ``MILNet``."""
    params = dict(variables["params"])
    enc_name = next(k for k in params if k.startswith("EfficientNet"))
    enc = {"params": params.pop(enc_name), "batch_stats": variables["batch_stats"][enc_name]}
    sd = efficientnet_from_flax(enc, prefix="encoder.")
    for path, leaf in _flatten(params).items():
        k, t = _convert_param(path, leaf)
        sd[k] = t
    return sd
