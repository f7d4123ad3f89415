"""The port's MM stream held against the JAX package on the CPU: TinyNet,
TabMLP + MMJointDualHead, their Flax ↔ port converters, and MMEnsemble.

Flax variables come from ``jax.eval_shape`` filled from a numpy seed
(tests/test_torch_models.py): LeCun-normal kernels, and BatchNorm statistics
and affine terms away from the identity so every layer's arithmetic shows.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _random_variables

ROOT = Path(__file__).resolve().parents[1]
MM_RECIPES = ROOT / "results" / "rehearsal_r5" / "mm"


def _mm_pair(model_name, seed, size=64):
    """(Flax MMJointDualHead in f32, its numpy variables)."""
    from mmtrs_tpu.models.mm_joint import MMJointDualHead as FlaxMM

    flax_net = FlaxMM(model_name=model_name, dtype=jnp.float32)
    v = _random_variables(flax_net, jnp.zeros((1, size, size, 3)), seed=seed,
                          x_tab=jnp.zeros((1, 9)), train=False)
    return flax_net, jax.tree.map(np.asarray, v)


@pytest.mark.parametrize("num_classes", [0, 2])
def test_tinynet_matches_flax(num_classes):
    """TinyNet (ε 1e-5) in f32 at 40² (odd sizes after each stride-2
    conv): features or logits within atol 1e-5."""
    from mmtrs_tpu.models.backbones.tinynet import TinyNet as FlaxTiny
    from mmtrs_tpu_torch.models.backbones.tinynet import TinyNet
    from mmtrs_tpu_torch.models.convert import tinynet_from_flax

    x = np.random.default_rng(3).normal(0, 1, (3, 40, 40, 3)).astype(np.float32)
    flax_net = FlaxTiny(num_classes=num_classes, dtype=jnp.float32)
    v = _random_variables(flax_net, jnp.asarray(x), seed=3, train=False)
    want = np.asarray(flax_net.apply(v, jnp.asarray(x), train=False))

    net = TinyNet(num_classes=num_classes, dtype=torch.float32).eval()
    net.load_state_dict(tinynet_from_flax(jax.tree.map(np.asarray, v)), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, num_classes or 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("model_name", ["test_cnn", "efficientnet_b0"])
def test_mm_joint_matches_flax(model_name):
    """MMJointDualHead in f32 at 64² with standardised tabular rows: both
    logits within atol 1e-4."""
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead

    rng = np.random.default_rng(4)
    img = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    tab = rng.normal(0, 1, (2, 9)).astype(np.float32)
    flax_net, v = _mm_pair(model_name, seed=4)
    want = flax_net.apply(v, jnp.asarray(img), jnp.asarray(tab), train=False)

    net = MMJointDualHead(model_name, dtype=torch.float32).eval()
    net.load_state_dict(mm_joint_from_flax(v), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(img), torch.from_numpy(tab))
    for g, w in zip(got, want):
        assert g.shape == (2,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_calibrate_batchnorm_on_tab_mlp_rows():
    """The shared BatchNorm on [B, C] rows: calibrate_batchnorm_ gives each
    of TabMLP's two BatchNorms the statistics of its input over the batch,
    after which it normalises that input to mean 0 and variance 1."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm_, lecun_init_
    from mmtrs_tpu_torch.models.mm_joint import TabMLP

    mlp = lecun_init_(TabMLP(), torch.Generator().manual_seed(6)).eval()
    t = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (64, 9)).astype(np.float32))
    calibrate_batchnorm_(mlp, t)
    with torch.no_grad():
        h = t
        for fc, bn in ((mlp.fc0, mlp.bn0), (mlp.fc1, mlp.bn1)):
            h = fc(h)
            torch.testing.assert_close(bn.running_mean, h.mean(dim=0), rtol=0, atol=1e-7)
            torch.testing.assert_close(bn.running_var, h.var(dim=0, unbiased=False), rtol=1e-6, atol=0)
            y = bn(h)
            assert y.shape == h.shape and float(y.mean(dim=0).abs().max()) < 1e-5
            assert float((y.var(dim=0, unbiased=False) - 1).abs().max()) < 1e-3
            h = torch.relu(y)


def _tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (pa, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), pa


def test_mm_joint_converters_fill_every_tensor_b4_and_round_trip():
    """efficientnet_b4's MM head: every Flax leaf fills the port's state
    dict (strict load), the tabular BatchNorm statistics land in place, and
    mm_joint_to_flax gives the Flax tree back bit for bit."""
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax, mm_joint_to_flax
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead

    _, v = _mm_pair("efficientnet_b4", seed=5, size=32)
    assert "EfficientNet_0" in v["params"]
    sd = mm_joint_from_flax(v)
    MMJointDualHead("efficientnet_b4").load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(sd["tab_mlp.bn1.running_var"].numpy(),
                                  v["batch_stats"]["tab_mlp"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["head_reg.weight"].numpy(), v["params"]["head_reg"]["kernel"].T)
    _tree_equal(mm_joint_to_flax(sd), v)


@pytest.mark.parametrize("model_name", ["efficientnet_b0", "test_cnn"])
def test_milnet_converters_round_trip(model_name):
    from mmtrs_tpu.models.mil import MILNet as FlaxMIL
    from mmtrs_tpu_torch.models.convert import milnet_from_flax, milnet_to_flax
    from mmtrs_tpu_torch.models.mil import MILNet

    flax_net = FlaxMIL(model_name, attn_dim=16, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, _random_variables(flax_net, jnp.zeros((1, 2, 32, 32, 3)),
                                                   seed=6, train=False))
    sd = milnet_from_flax(v)
    MILNet(model_name, attn_dim=16).load_state_dict(sd, strict=True)
    _tree_equal(milnet_to_flax(sd), v)


def _recipe_folds(pairs, img_size):
    folds = []
    for k, (_, v) in enumerate(pairs):
        r = json.loads((MM_RECIPES / f"mm_dualtask_fold{k}.recipe.json").read_text())
        folds.append({"variables": v, "T": float(r["T"]), "img_size": img_size,
                      "mean": np.asarray(r["scaler_mean"], np.float32),
                      "scale": np.asarray(r["scaler_scale"], np.float32)})
    return folds


def test_mm_ensemble_matches_jax():
    """Two f32 test_cnn folds with the T and scaler statistics of the repo's
    fold 0 and 1 recipes and img_size lowered to 64, on one processed 512²
    tooth (resized 512 → 64, 3 views), with tabular fields and without:
    |Δp| ≤ 1e-4 with p in (0.01, 0.99)."""
    from mmtrs_tpu.serve.ensembles import MMEnsemble as JaxMM
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.preprocess import preprocess_numpy
    from mmtrs_tpu_torch.serve.ensembles import MMEnsemble
    from mmtrs_tpu_torch.synth import synth_teeth

    pairs = [_mm_pair("test_cnn", seed=s) for s in (7, 8)]
    folds = _recipe_folds(pairs, 64)
    jens = JaxMM(folds, pairs[0][0])
    ens = MMEnsemble([{**{k: f[k] for k in ("T", "mean", "scale", "img_size")},
                       "state_dict": mm_joint_from_flax(f["variables"])} for f in folds],
                     MMJointDualHead("test_cnn", dtype=torch.float32), device="cpu")
    proc = preprocess_numpy(synth_teeth(1, 512, seed=9), device="cpu")[0][0]
    for tab9 in ([1.0, 0.0, 1.0, 1.0, -1.0, 3.0, 1.0, 1.0, 0.0], None):
        want = jens.predict(proc, tab9)
        got = ens.predict(proc, tab9)
        assert 0.01 < want < 0.99, want
        assert abs(got - want) <= 1e-4, (tab9, got, want)
