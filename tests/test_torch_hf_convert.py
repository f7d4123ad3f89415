"""The port's HF backbone converter (``models/backbones/convert.py``) held
against the JAX package's converter and against HF's own forward.

Random-init ``transformers`` models stand in for the pretrained downloads
(no checkpoint is in the repository). Forwards run in f64 on both sides;
the port's LayerNorms take their statistics in f32 (the Flax module's
arithmetic), so its f64 forward is f32-exact there and no better.

ConvNeXt is the one family whose converted forward is not HF's: the port
follows the Flax module, tanh GELU and a final LayerNorm eps of 1e-6,
where HF takes the erf GELU and 1e-12. With HF's config set to the tanh
GELU and eps 1e-6 the two agree to f32 rounding; with HF's defaults the
measured residue is held to its bar below.
"""

import os

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow too

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

SMALL_DEPTHS = (1, 1, 2, 1)
TINY_DIMS = (96, 192, 384, 768)
# measured on these random-init HF models at 64², batch 2, f64 (max |d|
# relative to the largest |feature|): EfficientNet-B0 4.4e-8; ConvNeXt with
# the tanh GELU and eps 1e-6 2.4e-7 (v1) and 1.2e-7 (v2); ConvNeXt at HF's
# defaults 1.0e-4 (v1) and 1.4e-4 (v2), the erf/tanh GELU gap through the
# 5 blocks
F32_BAR = 1e-5
GELU_GAP_BAR = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _hf_efficientnet():
    from transformers import EfficientNetConfig, EfficientNetModel

    torch.manual_seed(0)
    hf = EfficientNetModel(EfficientNetConfig(width_coefficient=1.0, depth_coefficient=1.0, hidden_dim=1280,
                                              image_size=64, drop_connect_rate=0.0)).eval()
    # HF's init (N(0, 0.02) kernels, identity BatchNorms) shrinks the
    # features to ~1e-63 over 16 blocks: He-scaled kernels and BatchNorm
    # statistics away from the identity keep them O(1)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, t in hf.state_dict().items():
            if t.dtype != torch.float32:
                continue
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5)
            elif n.endswith(("running_var", ".weight")):  # the 1-D weights are BatchNorm scales
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return hf


def _hf_convnext(v2: bool, tanh: bool):
    from transformers import ConvNextConfig, ConvNextModel, ConvNextV2Config, ConvNextV2Model

    torch.manual_seed(1)
    kw = dict(depths=list(SMALL_DEPTHS), hidden_sizes=list(TINY_DIMS), drop_path_rate=0.0)
    if tanh:
        kw.update(hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6)
    hf = (ConvNextV2Model(ConvNextV2Config(**kw)) if v2 else ConvNextModel(ConvNextConfig(**kw))).eval()
    with torch.no_grad():  # away from the near-identity init: LayerScale 1e-6, GRN zeros
        g = torch.Generator().manual_seed(2)
        for n, p in hf.named_parameters():
            if n.endswith("layer_scale_parameter") or ".grn." in n:
                p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype) * 0.5)
    return hf


@pytest.fixture(autouse=True)
def one_thread():
    """f64 convolutions take PyTorch's generic CPU path, whose OpenMP
    threads spin against the other test workers' (~400 s instead of ~1 s
    for B0 under a loaded run): one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_convnext(monkeypatch):
    """ConvNeXt-tiny's widths at depths 1-1-2-1, in both packages."""
    from mmtrs_tpu.models.backbones import convnext as jax_convnext
    from mmtrs_tpu_torch.models.backbones import convnext

    for mod in (jax_convnext, convnext):
        monkeypatch.setitem(mod._CONFIGS, "tiny", (SMALL_DEPTHS, TINY_DIMS))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_efficientnet_b0_from_hf_matches_hf_forward():
    """Pooled B0 features of the converted port model (f64) against HF's
    last hidden state averaged over H and W, within F32_BAR of the largest."""
    from mmtrs_tpu_torch.models.backbones.convert import efficientnet_from_hf
    from mmtrs_tpu_torch.models.backbones.factory import create_model

    hf = _hf_efficientnet().double()
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3))
    with torch.no_grad():
        want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state.mean(dim=(2, 3)).numpy()
        net = create_model("efficientnet_b0", num_classes=0, drop_rate=0.0, drop_path=0.0, dtype=torch.float64)
        net.load_state_dict(efficientnet_from_hf(hf.state_dict(), "b0"), strict=True)
        got = net.double().eval()(torch.from_numpy(x)).double().numpy()
    assert _rel(got, want) <= F32_BAR, _rel(got, want)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("tanh", [True, False], ids=["tanh_gelu", "hf_defaults"])
def test_convnext_from_hf_matches_hf_forward(small_convnext, v2, tanh):
    """The converted ConvNeXt (f64) against HF's pooler output: within
    F32_BAR with HF set to the tanh GELU and eps 1e-6, within GELU_GAP_BAR
    at HF's defaults (erf GELU, eps 1e-12), and not within F32_BAR there
    (the gap is the GELU's, pinned)."""
    from mmtrs_tpu_torch.models.backbones.convert import convnext_from_hf
    from mmtrs_tpu_torch.models.backbones.factory import create_model

    hf = _hf_convnext(v2, tanh).double()
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3))
    with torch.no_grad():
        want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).pooler_output.numpy()
        net = create_model("convnextv2_tiny" if v2 else "convnext_tiny", num_classes=0, drop_rate=0.0,
                           drop_path=0.0, dtype=torch.float64)
        net.load_state_dict(convnext_from_hf(hf.state_dict(), "tiny", v2=v2), strict=True)
        got = net.double().eval()(torch.from_numpy(x)).double().numpy()
    err = _rel(got, want)
    if tanh:
        assert err <= F32_BAR, err
    else:
        assert F32_BAR < err <= GELU_GAP_BAR, err


def test_efficientnet_from_hf_equals_jax_converter():
    """Array for array: the port's converter is the JAX converter followed
    by vision_from_flax (f32 HF weights, so the casts are exact)."""
    from mmtrs_tpu.models.backbones.convert import efficientnet_from_hf as jax_from_hf
    from mmtrs_tpu_torch.models.backbones.convert import efficientnet_from_hf
    from mmtrs_tpu_torch.models.convert import vision_from_flax

    sd = _hf_efficientnet().state_dict()
    want = vision_from_flax(jax_from_hf(sd, "b0"), "efficientnet_b0")
    got = efficientnet_from_hf(sd, "b0")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_convnext_from_hf_equals_jax_converter(small_convnext, v2):
    """The same for ConvNeXt; for v2 the JAX converter leaves GRN out (its
    tree keeps GRN's zero init, so a pretrained V2 loses its GRN weights:
    pinned here), and the port's converter adds exactly those leaves."""
    from mmtrs_tpu.models.backbones.convert import convnext_from_hf as jax_from_hf
    from mmtrs_tpu_torch.models.backbones.convert import convnext_from_hf
    from mmtrs_tpu_torch.models.convert import vision_from_flax

    sd = _hf_convnext(v2, tanh=False).state_dict()
    jax_tree = jax_from_hf(sd, "tiny", v2=v2)
    assert not any("grn" in k for k in _flat(jax_tree))
    want = vision_from_flax(jax_tree, "convnextv2_tiny" if v2 else "convnext_tiny")
    got = convnext_from_hf(sd, "tiny", v2=v2)
    grn = {k for k in got if ".grn." in k}
    assert set(got) - grn == set(want)
    assert len(grn) == (2 * sum(SMALL_DEPTHS) if v2 else 0)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in grn:
        stage, block = k.split(".")[1].split("_block")
        src = f"encoder.stages.{stage[len('stage'):]}.layers.{block}.grn.{'weight' if k.endswith('gamma') else 'bias'}"
        assert torch.equal(got[k], sd[src].reshape(-1)), k


def test_merge_pretrained_feeds_the_trainers():
    """Converted B0 weights load into VisionTrainer (the classifier keeps
    its init) and into the MM trainer's backbone, strictly."""
    from mmtrs_tpu_torch.config import MMJointConfig, VisionTrainConfig
    from mmtrs_tpu_torch.models.backbones.convert import efficientnet_from_hf
    from mmtrs_tpu_torch.train.mm import MMTrainer
    from mmtrs_tpu_torch.train.vision import VisionTrainer

    pre = efficientnet_from_hf(_hf_efficientnet().state_dict(), "b0")
    tr = VisionTrainer(VisionTrainConfig(model_name="efficientnet_b0", img_size=32, batch_size=2, epochs=1),
                       device="cpu")
    st = tr.init_state(2, pretrained=pre)
    for k, v in pre.items():
        assert torch.equal(st["model"][k], v), k
    assert torch.equal(st["model"]["classifier.weight"], tr._init["classifier.weight"])

    mm = MMTrainer(MMJointConfig(model_name="efficientnet_b0", img_size=32, batch_size=2), device="cpu")
    mm.init_state(1, pretrained=pre)
    got = mm.model.backbone.state_dict()
    for k, v in pre.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="pretrained"):
        mm.init_state(1, pretrained={k: v for k, v in pre.items() if "bn_head" not in k})
