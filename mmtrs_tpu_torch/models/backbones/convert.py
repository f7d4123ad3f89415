"""HuggingFace-transformers backbone checkpoints → the port's state dicts
(the twin of mmtrs_tpu/models/backbones/convert.py).

The reference trains timm ``tf_efficientnet_bX_ns`` / ``convnext*``
backbones; deployment parity needs their pretrained weights. These map a
``transformers`` ``EfficientNetModel`` / ``ConvNextModel`` /
``ConvNextV2Model`` state dict straight onto the port's names, which
``models.convert.merge_pretrained`` and the trainers' ``pretrained=`` take:

- :func:`efficientnet_from_hf` → ``create_model("efficientnet_bX", ...)``'s
  backbone leaves (the blocks under ``blocks.stage{i}_block{j}``);
- :func:`convnext_from_hf` → ``create_model("convnext_*" /
  "convnextv2_*", ...)``'s.

Both are the JAX converter followed by ``models.convert.vision_from_flax``
without the detour: HF already holds PyTorch's layouts, so each leaf is a
rename (dtype kept). Besides, ``convnext_from_hf(..., v2=True)`` carries the
GRN ``weight``/``bias`` (HF shape [1, 1, 1, C]) into ``grn.gamma`` /
``grn.beta``, which the JAX converter leaves out (its GRN keeps its zero
init). This module imports no ``transformers``.

The port's ConvNeXt follows the Flax module, whose GELU is the tanh
approximation and whose final LayerNorm takes eps 1e-6; HF's ConvNeXt
takes the erf GELU and eps 1e-12 there, so a converted ConvNeXt matches
HF's forward only to that residue (tests/test_torch_hf_convert.py measures
it).
"""

from __future__ import annotations

import numpy as np
import torch

from mmtrs_tpu_torch.models.backbones.convnext import _CONFIGS
from mmtrs_tpu_torch.models.backbones.efficientnet import _BASE_BLOCKS, _SCALING, _round_repeats


def _t(w) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.detach().clone()
    return torch.from_numpy(np.array(w))


def _bn(sd: dict, src: str, dst: str) -> dict[str, torch.Tensor]:
    return {f"{dst}.{n}": _t(sd[f"{src}.{n}"]) for n in ("weight", "bias", "running_mean", "running_var")}


def efficientnet_from_hf(state_dict: dict, variant: str = "b0") -> dict[str, torch.Tensor]:
    """HF EfficientNetModel state dict → the port's EfficientNet(variant)
    backbone leaves (no classifier)."""
    sd = state_dict
    _, dm, _, _ = _SCALING[variant]
    out = {"conv_stem.weight": _t(sd["embeddings.convolution.weight"])}
    out.update(_bn(sd, "embeddings.batchnorm", "bn_stem"))
    flat = 0
    for si, (e, _, r, _, _) in enumerate(_BASE_BLOCKS):
        for j in range(_round_repeats(r * dm)):
            hf, me = f"encoder.blocks.{flat}", f"blocks.stage{si}_block{j}"
            if e != 1:
                out[f"{me}.pw_expand.weight"] = _t(sd[f"{hf}.expansion.expand_conv.weight"])
                out.update(_bn(sd, f"{hf}.expansion.expand_bn", f"{me}.bn0"))
            out[f"{me}.dw.weight"] = _t(sd[f"{hf}.depthwise_conv.depthwise_conv.weight"])
            out.update(_bn(sd, f"{hf}.depthwise_conv.depthwise_norm", f"{me}.bn1"))
            for part in ("reduce", "expand"):
                for n in ("weight", "bias"):
                    out[f"{me}.se.{part}.{n}"] = _t(sd[f"{hf}.squeeze_excite.{part}.{n}"])
            out[f"{me}.pw_project.weight"] = _t(sd[f"{hf}.projection.project_conv.weight"])
            out.update(_bn(sd, f"{hf}.projection.project_bn", f"{me}.bn2"))
            flat += 1
    out["conv_head.weight"] = _t(sd["encoder.top_conv.weight"])
    out.update(_bn(sd, "encoder.top_bn", "bn_head"))
    return out


def convnext_from_hf(state_dict: dict, variant: str = "tiny", v2: bool = False) -> dict[str, torch.Tensor]:
    """HF ConvNextModel (``v2``: ConvNextV2Model) state dict → the port's
    ConvNeXt(variant, v2) backbone leaves (no classifier)."""
    sd = state_dict

    def pair(src: str, dst: str) -> dict[str, torch.Tensor]:
        return {f"{dst}.{n}": _t(sd[f"{src}.{n}"]) for n in ("weight", "bias")}

    depths, _ = _CONFIGS[variant]
    out = {**pair("embeddings.patch_embeddings", "stem_conv"), **pair("embeddings.layernorm", "stem_norm")}
    for si, depth in enumerate(depths):
        if si > 0:
            out.update(pair(f"encoder.stages.{si}.downsampling_layer.0", f"down{si}_norm"))
            out.update(pair(f"encoder.stages.{si}.downsampling_layer.1", f"down{si}_conv"))
        for j in range(depth):
            hf, me = f"encoder.stages.{si}.layers.{j}", f"blocks.stage{si}_block{j}"
            for src, dst in (("dwconv", "dwconv"), ("layernorm", "norm"), ("pwconv1", "pwconv1"),
                             ("pwconv2", "pwconv2")):
                out.update(pair(f"{hf}.{src}", f"{me}.{dst}"))
            if v2:
                out[f"{me}.grn.gamma"] = _t(sd[f"{hf}.grn.weight"]).reshape(-1)
                out[f"{me}.grn.beta"] = _t(sd[f"{hf}.grn.bias"]).reshape(-1)
            else:
                out[f"{me}.gamma"] = _t(sd[f"{hf}.layer_scale_parameter"])
    # HF's final layernorm is the port's head_norm
    out.update(pair("layernorm", "head_norm"))
    return out
