"""The port's ConvNeXt and ConvNeXtV2 held against the JAX package's Flax
modules on the CPU, and the factory's new names.

Flax variables come from ``tests.test_torch_models._random_variables``:
LeCun-normal kernels, and every other leaf (biases, LayerNorm scales, the
LayerScale gammas, GRN's gamma and beta) drawn away from its init. At init
LayerScale (1e-6) and GRN (zeros) make each block nearly the identity, so a
comparison from a fresh init would not see the blocks' arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _random_variables


def _pair(name, size, seed, dtype=jnp.float32, num_classes=2):
    """The Flax module (no dropout or drop-path) with random variables and
    the port's module loaded with them."""
    from mmtrs_tpu.models.backbones.factory import create_model as jax_create
    from mmtrs_tpu_torch.models.backbones.factory import create_model
    from mmtrs_tpu_torch.models.convert import vision_from_flax

    flax_net = jax_create(name, num_classes=num_classes, drop_rate=0.0, drop_path=0.0, dtype=dtype)
    v = jax.tree.map(np.asarray, _random_variables(flax_net, jnp.zeros((1, size, size, 3)), seed=seed))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    net = create_model(name, num_classes=num_classes, drop_rate=0.0, drop_path=0.0, dtype=tdtype)
    net.load_state_dict(vision_from_flax(v, name), strict=True)
    return flax_net, v, net


@pytest.mark.parametrize("name", ["convnext_tiny", "convnextv2_tiny"])
def test_convnext_eval_logits_match_flax(name):
    """Eval logits of the full-width tiny variants at 64², batch 3, f32:
    within 1e-5 of the largest |logit|; the converter is one to one (a
    strict load, and the round trip gives the Flax tree back bit for bit).
    Measured 9.2e-7 (v1) and 3.9e-6 (v2)."""
    from mmtrs_tpu_torch.models.convert import vision_to_flax

    flax_net, v, net = _pair(name, 64, seed=11)
    x = np.random.default_rng(12).normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(flax_net.apply(v, x, train=False))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), np.abs(got - want).max()
    back = vision_to_flax(net.state_dict())
    assert back["batch_stats"] == {}
    flat = lambda t: {jax.tree_util.keystr(k): a for k, a in jax.tree_util.tree_leaves_with_path(t)}
    fb, fv = flat(back["params"]), flat(v["params"])
    assert set(fb) == set(fv)
    for k in fv:
        np.testing.assert_array_equal(fb[k], fv[k], err_msg=k)


@pytest.mark.parametrize("name", ["convnext_tiny", "convnextv2_tiny"])
def test_convnext_bf16_logits_match_flax(name):
    """The same at bf16 activations (f32 parameters) in both packages:
    within 5e-2 of the largest |logit|. Each package rounds to bf16 after
    every layer, the two round at other points of GELU and GRN, and the
    rounding compounds over 18 blocks (measured 1.7e-2 for v1, 9.2e-3 for v2)."""
    flax_net, v, net = _pair(name, 64, seed=13, dtype=jnp.bfloat16)
    x = np.random.default_rng(14).normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(flax_net.apply(v, x, train=False)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).float().numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", ["convnext_tiny", "convnextv2_tiny"])
def test_convnext_train_step_matches_flax(name):
    """One f32 train-mode forward and backward at 32², batch 2, dropout and
    drop-path 0, loss mean(logits · r): the loss within 1e-5 of mean|logits ·
    r| (the mean cancels most of its terms) and every gradient leaf within
    1e-4 of its leaf's max |g| (measured: loss 1.0e-6 and 1.1e-6, gradients
    1.9e-6 and 3.5e-6)."""
    from mmtrs_tpu_torch.models.convert import vision_to_flax

    flax_net, v, net = _pair(name, 32, seed=15)
    rng = np.random.default_rng(16)
    x = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    r = rng.normal(0, 1, (2, 2)).astype(np.float32)

    def jloss(params):
        return jnp.mean(flax_net.apply({"params": params}, x, train=True) * r)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(v["params"])
    net.train()
    terms = net(torch.from_numpy(x)) * torch.from_numpy(r)
    loss = torch.mean(terms)
    loss.backward()
    scale = float(terms.detach().abs().mean())
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * scale, abs(float(loss.detach()) - float(jl)) / scale
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(a) for k, a in jax.tree_util.tree_leaves_with_path(t)}
    pg = flat(vision_to_flax({k: p.grad for k, p in net.named_parameters()})["params"])
    want = flat(jg)
    assert set(pg) == set(want)
    gaps = {k: np.abs(pg[k] - g).max() / np.abs(g).max() for k, g in want.items()}
    for k, g in want.items():
        assert gaps[k] <= 1e-4, (k, gaps[k])


def test_gelu_and_layernorm_pin_the_flax_arithmetic():
    """GELU is jax.nn.gelu's tanh form (within 1e-6; erf GELU differs by
    more than 1e-4 on the same values). LayerNorm takes Flax's fast
    variance mean(x²) − mean²: on 8 channels of integers near 1000 every
    sum is exact in f32 in any order and only mean² rounds (its ulp is
    0.0625 against variances of ~2), so the port equals Flax within 1e-5
    while F.layer_norm's two-pass variance is more than 1e-3 off."""
    import flax.linen as fnn
    from mmtrs_tpu_torch.models.backbones.convnext import LayerNorm, gelu_tanh

    z = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(z)))
    got = gelu_tanh(torch.from_numpy(z)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(torch.nn.functional.gelu(torch.from_numpy(z)).numpy() - want).max() > 1e-4

    rng = np.random.default_rng(17)
    x = (1000 + rng.integers(-3, 4, (64, 8))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    want = np.asarray(fnn.LayerNorm(epsilon=1e-6).apply({"params": {"scale": scale, "bias": bias}}, x))
    mod = LayerNorm(8)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x)).numpy()
        two_pass = torch.nn.functional.layer_norm(torch.from_numpy(x), (8,), mod.weight, mod.bias, 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(two_pass - want).max() > 1e-3


def test_factory_names_head_bias_and_feature_dims():
    """Every name of the JAX registry builds in the port; feature_dim agrees
    with the JAX factory's; head_bias_init fills the classifier bias of each
    family (and survives lecun_init_); the drop-path schedule is
    rate·b / (blocks − 1)."""
    from mmtrs_tpu.models.backbones.factory import MODEL_REGISTRY as JAX_REGISTRY
    from mmtrs_tpu.models.backbones.factory import feature_dim as jax_feature_dim
    from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
    from mmtrs_tpu_torch.models.backbones.factory import MODEL_REGISTRY, create_model, feature_dim

    assert MODEL_REGISTRY == JAX_REGISTRY
    for name in MODEL_REGISTRY:
        assert feature_dim(name) == jax_feature_dim(name), name
    for name in ("test_cnn", "efficientnet_b0", "convnextv2_tiny"):
        net = create_model(name, num_classes=2, head_bias_init=-0.7)
        assert torch.all(net.classifier.bias == -0.7)
        lecun_init_(net, torch.Generator().manual_seed(0))
        assert torch.all(net.classifier.bias == -0.7)
        assert create_model(name, num_classes=0).classifier is None
    net = create_model("convnext_small", drop_path=0.3)
    rates = [b.drop_path for b in net.blocks.values()]
    assert len(rates) == 36 and rates[0] == 0.0 and rates[-1] == pytest.approx(0.3)
    assert rates[1] == pytest.approx(0.3 / 35)
    with pytest.raises(ValueError, match="unknown model"):
        create_model("convnext_huge")
