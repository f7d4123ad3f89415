"""The Mask R-CNN's weights: torchvision state dicts, the JAX package's
Flax tree, and the port's module (the twin of
mmtrs_tpu/models/detection/convert_torchvision.py).

The port's ``MaskRCNN`` carries torchvision's module names, so a
torchvision ``maskrcnn_resnet50_fpn`` state dict is its state dict:
:func:`load_torchvision` loads one by name, strictly, after renaming the
newer torchvision era's keys (``backbone.fpn.inner_blocks.0.0.weight``,
``rpn.head.conv.0.0.weight``, ``roi_heads.mask_head.0.0.weight``) to the
classic ones, the alternatives the JAX converter's ``_pick`` accepts, and
dropping ``num_batches_tracked`` and anchor buffers as it does.

:func:`detector_from_flax` maps the JAX package's tree (what its
``convert_state_dict`` makes, and what ``download_weights.py --torch_ckpt``
saves) onto the port's names, :func:`detector_to_flax` maps back; kernels
HWIO → OIHW (the transposed convolution's (kh, kw, out, in) → (in, out, kh,
kw) is the same transpose), Dense [in, out] → Linear [out, in].

``expected_torch_keys`` and ``fake_state_dict`` are copies of the JAX
package's: one seed gives the same arrays bit for bit.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mmtrs_tpu_torch.models.detection.modules import DetectorConfig, MaskRCNN


def expected_torch_keys(cfg: DetectorConfig = DetectorConfig()) -> dict[str, tuple]:
    """Every torchvision parameter name → shape (classic naming era)."""
    w = cfg.base_width
    ks: dict[str, tuple] = {
        "backbone.body.conv1.weight": (w, 3, 7, 7),
    }
    for suf in ("weight", "bias", "running_mean", "running_var"):
        ks[f"backbone.body.bn1.{suf}"] = (w,)
    in_ch = w
    for li, blocks in enumerate(cfg.layers):
        width = w * (2 ** li)
        for bi in range(blocks):
            t = f"backbone.body.layer{li + 1}.{bi}"
            ks[f"{t}.conv1.weight"] = (width, in_ch if bi == 0 else width * 4, 1, 1)
            ks[f"{t}.conv2.weight"] = (width, width, 3, 3)
            ks[f"{t}.conv3.weight"] = (width * 4, width, 1, 1)
            for j, ww in (("1", width), ("2", width), ("3", width * 4)):
                for suf in ("weight", "bias", "running_mean", "running_var"):
                    ks[f"{t}.bn{j}.{suf}"] = (ww,)
            if bi == 0:
                ks[f"{t}.downsample.0.weight"] = (width * 4, in_ch, 1, 1)
                for suf in ("weight", "bias", "running_mean", "running_var"):
                    ks[f"{t}.downsample.1.{suf}"] = (width * 4,)
        in_ch = width * 4

    C = cfg.fpn_channels
    for i in range(4):
        cin = w * (2 ** i) * 4
        ks[f"backbone.fpn.inner_blocks.{i}.weight"] = (C, cin, 1, 1)
        ks[f"backbone.fpn.inner_blocks.{i}.bias"] = (C,)
        ks[f"backbone.fpn.layer_blocks.{i}.weight"] = (C, C, 3, 3)
        ks[f"backbone.fpn.layer_blocks.{i}.bias"] = (C,)

    A = len(cfg.aspect_ratios)
    ks["rpn.head.conv.weight"] = (C, C, 3, 3)
    ks["rpn.head.conv.bias"] = (C,)
    ks["rpn.head.cls_logits.weight"] = (A, C, 1, 1)
    ks["rpn.head.cls_logits.bias"] = (A,)
    ks["rpn.head.bbox_pred.weight"] = (A * 4, C, 1, 1)
    ks["rpn.head.bbox_pred.bias"] = (A * 4,)

    R = 1024
    ks["roi_heads.box_head.fc6.weight"] = (R, C * 7 * 7)
    ks["roi_heads.box_head.fc6.bias"] = (R,)
    ks["roi_heads.box_head.fc7.weight"] = (R, R)
    ks["roi_heads.box_head.fc7.bias"] = (R,)
    ks["roi_heads.box_predictor.cls_score.weight"] = (cfg.num_classes, R)
    ks["roi_heads.box_predictor.cls_score.bias"] = (cfg.num_classes,)
    ks["roi_heads.box_predictor.bbox_pred.weight"] = (cfg.num_classes * 4, R)
    ks["roi_heads.box_predictor.bbox_pred.bias"] = (cfg.num_classes * 4,)

    for i in range(1, 5):
        ks[f"roi_heads.mask_head.mask_fcn{i}.weight"] = (C, C, 3, 3)
        ks[f"roi_heads.mask_head.mask_fcn{i}.bias"] = (C,)
    ks["roi_heads.mask_predictor.conv5_mask.weight"] = (C, C, 2, 2)
    ks["roi_heads.mask_predictor.conv5_mask.bias"] = (C,)
    ks["roi_heads.mask_predictor.mask_fcn_logits.weight"] = (cfg.num_classes, C, 1, 1)
    ks["roi_heads.mask_predictor.mask_fcn_logits.bias"] = (cfg.num_classes,)
    return ks


def fake_state_dict(cfg: DetectorConfig = DetectorConfig(), seed: int = 0) -> dict:
    """Synthetic checkpoint with torchvision's exact names/shapes (random
    values) — the hermetic stand-in for the real COCO download."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in expected_torch_keys(cfg).items():
        if k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[k] = rng.normal(0, 0.05, shape).astype(np.float32)
    return sd


# newer torchvision names → the classic ones (the JAX converter's _pick)
_ERA_RENAMES = (
    (re.compile(r"^backbone\.fpn\.(inner|layer)_blocks\.(\d+)\.0\.(weight|bias)$"), r"backbone.fpn.\1_blocks.\2.\3"),
    (re.compile(r"^rpn\.head\.conv\.0\.0\.(weight|bias)$"), r"rpn.head.conv.\1"),
    (re.compile(r"^roi_heads\.mask_head\.(\d)\.0\.(weight|bias)$"),
     lambda m: f"roi_heads.mask_head.mask_fcn{int(m.group(1)) + 1}.{m.group(2)}"),
)


def classic_names(sd: dict) -> dict:
    """A torchvision state dict under the classic era's names, without
    ``num_batches_tracked`` and anchor entries."""
    out = {}
    for k, v in sd.items():
        if "num_batches_tracked" in k or "anchor" in k:
            continue
        for pat, rep in _ERA_RENAMES:
            k = pat.sub(rep, k)
        out[k] = v
    return out


def _tensor(a) -> torch.Tensor:
    return a.detach().clone() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def load_torchvision(model: MaskRCNN, sd: dict) -> MaskRCNN:
    """Load a torchvision ``maskrcnn_resnet50_fpn`` state dict (tensors or
    arrays, either naming era) into ``model`` by name, strictly; a missing
    or unexpected key raises. Returns ``model``."""
    model.load_state_dict({k: _tensor(v) for k, v in classic_names(sd).items()}, strict=True)
    return model


# (Flax path prefix, port prefix); the first match maps a leaf's module
_FLAX_MODULES = (
    (re.compile(r"^body/layer(\d+)_(\d+)/downsample_conv$"), r"backbone.body.layer\1.\2.downsample.0"),
    (re.compile(r"^body/layer(\d+)_(\d+)/downsample_bn$"), r"backbone.body.layer\1.\2.downsample.1"),
    (re.compile(r"^body/layer(\d+)_(\d+)/(\w+)$"), r"backbone.body.layer\1.\2.\3"),
    (re.compile(r"^body/(\w+)$"), r"backbone.body.\1"),
    (re.compile(r"^fpn/inner(\d+)$"), r"backbone.fpn.inner_blocks.\1"),
    (re.compile(r"^fpn/layer(\d+)$"), r"backbone.fpn.layer_blocks.\1"),
    (re.compile(r"^rpn_head/(\w+)$"), r"rpn.head.\1"),
    (re.compile(r"^box_head/(fc6|fc7)$"), r"roi_heads.box_head.\1"),
    (re.compile(r"^box_head/(cls_score|bbox_pred)$"), r"roi_heads.box_predictor.\1"),
    (re.compile(r"^mask_head/(mask_fcn\d)$"), r"roi_heads.mask_head.\1"),
    (re.compile(r"^mask_head/(conv5_mask|mask_fcn_logits)$"), r"roi_heads.mask_predictor.\1"),
)
_PORT_MODULES = (
    (re.compile(r"^backbone\.body\.layer(\d+)\.(\d+)\.downsample\.0$"), r"body/layer\1_\2/downsample_conv"),
    (re.compile(r"^backbone\.body\.layer(\d+)\.(\d+)\.downsample\.1$"), r"body/layer\1_\2/downsample_bn"),
    (re.compile(r"^backbone\.body\.layer(\d+)\.(\d+)\.(\w+)$"), r"body/layer\1_\2/\3"),
    (re.compile(r"^backbone\.body\.(\w+)$"), r"body/\1"),
    (re.compile(r"^backbone\.fpn\.inner_blocks\.(\d+)$"), r"fpn/inner\1"),
    (re.compile(r"^backbone\.fpn\.layer_blocks\.(\d+)$"), r"fpn/layer\1"),
    (re.compile(r"^rpn\.head\.(\w+)$"), r"rpn_head/\1"),
    (re.compile(r"^roi_heads\.box_(?:head|predictor)\.(\w+)$"), r"box_head/\1"),
    (re.compile(r"^roi_heads\.mask_(?:head|predictor)\.(\w+)$"), r"mask_head/\1"),
)


def _rename(name: str, table) -> str:
    for pat, rep in table:
        if pat.match(name):
            return pat.sub(rep, name)
    raise KeyError(f"no mapping for the detector's module {name!r}")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def detector_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """{"params": tree} of the JAX ``MaskRCNN`` (numpy leaves, e.g. its
    ``convert_state_dict`` or an npz checkpoint) → the port's state dict
    (torchvision names), dtypes kept."""
    sd = {}
    for path, leaf in _flatten(variables["params"]).items():
        mod, _, name = path.rpartition("/")
        a = np.asarray(leaf)
        if name == "kernel":
            a, name = (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T), "weight"
        sd[f"{_rename(mod, _FLAX_MODULES)}.{name}"] = torch.from_numpy(np.array(a))
    return sd


def detector_to_flax(sd: dict[str, torch.Tensor]) -> dict:
    """The port's state dict → {"params": tree} of the JAX ``MaskRCNN``
    with numpy leaves (the inverse of detector_from_flax)."""
    tree: dict = {}
    for key, t in sd.items():
        mod, _, name = key.rpartition(".")
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if name == "weight" and a.ndim > 1:
            a, name = (a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T), "kernel"
        node = tree
        for m in _rename(mod, _PORT_MODULES).split("/"):
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": tree}
