"""The port's models (EfficientNet, MILNet) and the Flax → port converter,
held against the Flax modules of the JAX package on the CPU in float32.

Flax variables come from ``jax.eval_shape`` (no init compile) filled from a
numpy seed: LeCun-normal kernels, and BatchNorm statistics and affine terms
away from the identity so every layer's arithmetic shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _random_variables(module, x, seed=0, **kw):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, **kw))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(0, 1, s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("variant", ["b0", "b2", "b5"])
def test_efficientnet_converter_fills_every_tensor(variant):
    """Every Flax leaf lands in the port's state dict with the port's shape
    (strict load), and the layouts are the documented transposes."""
    from mmtrs_tpu.models.backbones.efficientnet import EfficientNet as FlaxEN
    from mmtrs_tpu_torch.models.backbones.efficientnet import EfficientNet
    from mmtrs_tpu_torch.models.convert import efficientnet_from_flax

    v = _random_variables(FlaxEN(variant, num_classes=0, dtype=jnp.float32),
                          jnp.zeros((1, 32, 32, 3)), train=False)
    sd = efficientnet_from_flax(v)
    net = EfficientNet(variant, dtype=torch.float32)
    net.load_state_dict(sd, strict=True)
    k = v["params"]["stage1_block0"]["dw"]["kernel"]  # (kh, kw, 1, C)
    np.testing.assert_array_equal(sd["blocks.stage1_block0.dw.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["bn_head.running_var"].numpy(), v["batch_stats"]["bn_head"]["var"]
    )


@pytest.mark.parametrize("num_classes", [0, 2])
def test_efficientnet_b0_features_match_flax(num_classes):
    """Full-width B0 (1280 pooled features, or 2 logits from the classifier)
    at 64² in f32: max-abs error ≤ 1e-4 × max|output| (XLA and PyTorch
    convolve in different orders)."""
    from mmtrs_tpu.models.backbones.efficientnet import EfficientNet as FlaxEN
    from mmtrs_tpu_torch.models.backbones.efficientnet import EfficientNet
    from mmtrs_tpu_torch.models.convert import efficientnet_from_flax

    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    flax_net = FlaxEN("b0", num_classes=num_classes, dtype=jnp.float32)
    v = _random_variables(flax_net, jnp.asarray(x), seed=1, train=False)
    want = np.asarray(flax_net.apply(v, jnp.asarray(x), train=False))

    net = EfficientNet("b0", num_classes=num_classes, dtype=torch.float32).eval()
    net.load_state_dict(efficientnet_from_flax(v), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, num_classes or 1280)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_milnet_matches_flax():
    """MILNet logit and attention on one 3-instance bag, f32: atol 1e-4."""
    from mmtrs_tpu.models.mil import MILNet as FlaxMIL
    from mmtrs_tpu_torch.models.convert import milnet_from_flax
    from mmtrs_tpu_torch.models.mil import MILNet

    bag = np.random.default_rng(2).normal(0, 1, (1, 3, 64, 64, 3)).astype(np.float32)
    flax_net = FlaxMIL("efficientnet_b0", attn_dim=128, dtype=jnp.float32)
    v = _random_variables(flax_net, jnp.asarray(bag), seed=2, train=False)
    logit, attn = flax_net.apply(v, jnp.asarray(bag), train=False)

    net = MILNet("efficientnet_b0", attn_dim=128, dtype=torch.float32).eval()
    net.load_state_dict(milnet_from_flax(v), strict=True)
    with torch.no_grad():
        got_logit, got_attn = net(torch.from_numpy(bag))
    np.testing.assert_allclose(got_logit.numpy(), np.asarray(logit), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(attn), atol=1e-4, rtol=0)
    assert got_attn.shape == (1, 3)


def test_make_eval_bag_and_normalize_match_jax():
    from mmtrs_tpu.models.mil import make_eval_bag as jbag
    from mmtrs_tpu.train.common import normalize_imagenet as jnorm
    from mmtrs_tpu_torch.models.mil import make_eval_bag
    from mmtrs_tpu_torch.train.common import normalize_imagenet

    imgs = np.random.default_rng(3).integers(0, 256, (2, 512, 512, 3)).astype(np.uint8)
    want = np.asarray(jnorm(jbag(jnp.asarray(imgs), 480)))
    got = normalize_imagenet(make_eval_bag(torch.from_numpy(imgs), 480)).numpy()
    assert got.shape == (2, 480, 480, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_random_init_keeps_feature_scale():
    """lecun_init_ + calibrate_batchnorm_ (the smoke run's random folds):
    features neither fade to zero nor blow up on the calibration input."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import (
        EfficientNet, calibrate_batchnorm_, lecun_init_,
    )

    gen = torch.Generator().manual_seed(0)
    net = lecun_init_(EfficientNet("b0", dtype=torch.float32), gen).eval()
    x = torch.randn((2, 96, 96, 3), generator=gen)
    with torch.no_grad():
        faded = net(x).std().item()
        calibrate_batchnorm_(net, x)
        kept = net(x).std().item()
    assert faded < 1e-3 < 0.05 < kept < 50.0, (faded, kept)
