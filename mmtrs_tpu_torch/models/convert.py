"""Flax variables ↔ port state dicts (the inverse of
mmtrs_tpu/models/backbones/convert.py's layout mapping, and back).

Input is the JAX package's variables with every leaf already a numpy array
(``jax.tree.map(np.asarray, variables)``, or a checkpoint read by
utils/checkpoint.py), so this module imports no JAX. Layouts: conv HWIO →
OIHW, depthwise (kh, kw, 1, C) → (C, 1, kh, kw) (the same transpose), Dense
[in, out] → Linear [out, in], BatchNorm scale/bias/mean/var →
weight/bias/running_mean/running_var, LayerNorm scale/bias →
weight/bias, and ConvNeXt's LayerScale ``gamma`` and GRN ``gamma``/``beta``
by their own names. ``*_to_flax`` undoes each step, so a round trip gives
the Flax tree back bit for bit.

Flax names a backbone built inside a compact module after its class
(``EfficientNet_0``, ``ConvNeXt_0``, ``TinyNet_0``); the port keeps it under
one attribute (``encoder`` in MILNet, ``backbone`` in MMJointDualHead), and
EfficientNet's and ConvNeXt's ``stage{i}_block{j}`` blocks under ``blocks``.
A vision model (``VisionTrainer``'s) is the backbone itself, its classifier
at the top level.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_NAMES = {"scale": "weight", "bias": "bias", "gamma": "gamma", "beta": "beta"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_BACKBONES = ("EfficientNet", "ConvNeXt", "TinyNet")


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


def _backbone_key(key: str, prefix: str) -> str:
    # Flax names EfficientNet's blocks stage{i}_block{j} at the top level;
    # the port keeps them in the ``blocks`` ModuleDict
    head = key.split(".", 1)[0]
    return prefix + ("blocks." + key if head.startswith("stage") else key)


def _from_flax(variables: dict, backbone_attr: str | None = None) -> dict[str, torch.Tensor]:
    """Every leaf of ``params`` and ``batch_stats``; with ``backbone_attr``
    the auto-named backbone's leaves go under that attribute."""
    sd = {}
    for coll, convert in (("params", _convert_param), ("batch_stats", _convert_stat)):
        for path, leaf in _flatten(variables.get(coll, {})).items():
            head, _, rest = path.partition("/")
            if backbone_attr is not None and head.startswith(_BACKBONES):
                k, t = convert(rest, leaf)
                sd[_backbone_key(k, backbone_attr + ".")] = t
            else:
                k, t = convert(path, leaf)
                sd[_backbone_key(k, "") if backbone_attr is None else k] = t
    return sd


def efficientnet_from_flax(variables: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of Flax ``EfficientNet`` or ``TinyNet``
    (numpy leaves) → state dict of the port's module."""
    return {prefix + k: t for k, t in _from_flax(variables).items()}


# TinyNet's Flax tree has the port's names and no blocks to regroup, so
# the EfficientNet conversion serves it unchanged
tinynet_from_flax = efficientnet_from_flax


def milnet_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of Flax ``MILNet`` (numpy leaves) → state
    dict of the port's ``MILNet``."""
    return _from_flax(variables, "encoder")


def mm_joint_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of Flax ``MMJointDualHead`` (numpy leaves)
    → state dict of the port's ``MMJointDualHead``."""
    return _from_flax(variables, "backbone")


def _backbone_name(sd: dict, prefix: str) -> str:
    if f"{prefix}conv_stem.weight" in sd:
        return "EfficientNet_0"
    return "ConvNeXt_0" if f"{prefix}stem_conv.weight" in sd else "TinyNet_0"


def _to_flax(sd: dict[str, torch.Tensor], backbone_attr: str | None) -> dict:
    """``backbone_attr`` None: the model is the backbone (a vision model)."""
    name = None if backbone_attr is None else _backbone_name(sd, backbone_attr + ".")
    tree: dict = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        if backbone_attr is None:
            mods = mods[1:] if mods[0] == "blocks" else mods
        elif mods[0] == backbone_attr:
            mods = [name] + mods[2:] if mods[1] == "blocks" else [name] + mods[1:]
        a = t.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and a.ndim > 1:
            coll, leaf = "params", "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        else:
            coll, leaf = "params", "scale" if leaf == "weight" else leaf
        node = tree[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def milnet_to_flax(sd: dict[str, torch.Tensor]) -> dict:
    """State dict of the port's ``MILNet`` → {"params", "batch_stats"} of
    Flax ``MILNet`` with numpy leaves (the inverse of milnet_from_flax)."""
    return _to_flax(sd, "encoder")


def mm_joint_to_flax(sd: dict[str, torch.Tensor]) -> dict:
    """State dict of the port's ``MMJointDualHead`` → {"params",
    "batch_stats"} of Flax ``MMJointDualHead`` with numpy leaves."""
    return _to_flax(sd, "backbone")


def vision_from_flax(variables: dict, model_name: str) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of the JAX factory's ``create_model(model_name,
    num_classes)`` (numpy leaves; ConvNeXt has no batch_stats) → state dict
    of the port's ``create_model(model_name, num_classes)``."""
    from mmtrs_tpu_torch.models.backbones.factory import MODEL_REGISTRY

    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model '{model_name}'")
    return _from_flax(variables)


def vision_to_flax(sd: dict[str, torch.Tensor]) -> dict:
    """State dict of a port vision model → {"params", "batch_stats"} of the
    Flax one with numpy leaves (the inverse of vision_from_flax)."""
    return _to_flax(sd, None)


def merge_pretrained(state: dict[str, torch.Tensor], pretrained: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The JAX package's ``merge_pretrained`` on port state dicts: every
    leaf of ``pretrained`` (backbone weights, port names) replaces the one of
    the same name in ``state`` (a fresh init), the others (the head) are
    kept. A leaf that ``state`` lacks, or one of another shape, raises."""
    bad = sorted(k for k, v in pretrained.items() if k not in state or tuple(state[k].shape) != tuple(v.shape))
    if bad:
        raise ValueError(f"pretrained weights do not fit the model: {bad[:5]}{' ...' if len(bad) > 5 else ''}")
    out = dict(state)
    out.update({k: v.to(state[k].dtype) for k, v in pretrained.items()})
    return out
