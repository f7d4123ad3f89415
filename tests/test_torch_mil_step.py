"""One train step of the port's MILNet held against the JAX package on the
CPU in float32, over the test net and over B0 (split from
tests/test_torch_train_mil.py, whose draws and f32 MILNet it shares, so
that the B0 step, the suite's longest test, runs in a file of its own).

The JAX trainer builds MILNet in bf16 with dropout 0.2 on the pooled
feature and the factory's drop-path 0.1; the test swaps in an f32 MILNet
without either, gives the port the same Flax init and the same rates, and
feeds the port JAX's bag draws. The bars are the MM step's (test_cnn:
gradients within 1e-4 of their leaf's max; B0: 3e-4, with the blocks' last
BatchNorm biases held as rounding noise, as tests/test_torch_train_mm.py
explains).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_mil import LR, _flax_milnet_f32, jax_bag_draws
from tests.test_torch_train_mm import _en_noise_leaf, _leaves


@pytest.fixture
def no_jax_drop_path(monkeypatch):
    """JAX's MILNet builds its encoder with the factory's drop-path 0.1;
    here 0."""
    import mmtrs_tpu.models.mil as jmil_model

    monkeypatch.setattr(jmil_model, "create_model",
                        functools.partial(jmil_model.create_model, drop_path=0.0))


# -- one train step -------------------------------------------------------------------


def _mil_tree(sd: dict, coll: str = "params") -> dict:
    from mmtrs_tpu_torch.models.convert import milnet_to_flax

    return milnet_to_flax(sd)[coll]


@pytest.mark.parametrize("model_name,size,gbar", [("test_cnn", 32, 1e-4), ("efficientnet_b0", 64, 3e-4)])
def test_mil_train_step_matches_jax(no_jax_drop_path, model_name, size, gbar):
    """MILNet in f32, dropouts 0, the Flax init converted, 2 bags of 3 from
    JAX's draws: the loss within 1e-5 relative, every gradient within
    ``gbar`` of its leaf's max |g| (B0's noise leaves ≤ 1e-6 of the largest
    in both), the parameters after the AdamW step within 1e-5 where both
    gradients exceed 1e-3 of their leaf's max and within 2·lr elsewhere, and
    the BatchNorm statistics within 1e-5 relative (+ 1e-6)."""
    import mmtrs_tpu.train.mil as jmil
    from mmtrs_tpu.config import MILConfig as JaxCfg
    from mmtrs_tpu.train.common import bce_logits as jax_bce
    from mmtrs_tpu_torch.config import MILConfig
    from mmtrs_tpu_torch.models.convert import milnet_from_flax
    from mmtrs_tpu_torch.models.mil import BagDraws, make_bags
    from mmtrs_tpu_torch.train.common import bce_logits, normalize_imagenet
    from mmtrs_tpu_torch.train.mil import MILTrainer

    kw = dict(model_name=model_name, bag_size=3, img_size=size, batch_size=2, lr=LR)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, size + 16, size + 8, 3)).astype(np.uint8)
    oid, y = np.array([4, 11]), np.array([1.0, 0.0], np.float32)
    orig = jmil.MILNet
    jmil.MILNet = _flax_milnet_f32()
    try:
        jt = jmil.MILTrainer(JaxCfg(**kw))
        st = jt.init_state(10)
        bags = np.asarray(jt._make_train_bags(imgs, 7, oid))
    finally:
        jmil.MILNet = orig
    v0 = jax.tree.map(np.asarray, {"params": st.params, "batch_stats": st.batch_stats})

    def jloss(params):
        (logit, _), mut = jt.model.apply({"params": params, "batch_stats": st.batch_stats}, bags,
                                         train=True, mutable=["batch_stats"])
        return jax_bce(logit, y), mut

    (jl0, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(st.params)
    jgrads = _leaves({"params": jg})
    st1, jl = jt._train_step(st, {"bags": jnp.asarray(bags), "y": jnp.asarray(y)})
    want = _leaves(jax.tree.map(np.asarray, {"params": st1.params, "batch_stats": st1.batch_stats}))

    make = lambda: MILTrainer(MILConfig(**kw), device="cpu", init=milnet_from_flax(v0), dtype=torch.float32,
                              drop_rate=0.0, drop_path=0.0)
    pt = make()
    pt.init_state(10)
    pbags = normalize_imagenet(make_bags(torch.from_numpy(imgs), BagDraws.from_numpy(*jax_bag_draws(7, oid, 3)),
                                         size))
    np.testing.assert_allclose(pbags.numpy(), bags, rtol=0, atol=1e-5)
    probe = make().model
    probe.train()
    bce_logits(probe(pbags)[0], torch.from_numpy(y)).backward()
    pgrads = _leaves({"params": _mil_tree({k: v.grad for k, v in probe.named_parameters()})})
    pl = pt.train_step(pbags, torch.from_numpy(y))

    noise = _en_noise_leaf if model_name != "test_cnn" else (lambda k: False)
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(pgrads) == set(jgrads)
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        if noise(k):
            assert np.abs(g).max() <= 1e-6 * gmax and np.abs(pgrads[k]).max() <= 1e-6 * gmax, k
        else:
            assert np.abs(pgrads[k] - g).max() <= gbar * np.abs(g).max(), k
    got = _leaves({"params": _mil_tree(pt.model.state_dict()),
                   "batch_stats": _mil_tree(pt.model.state_dict(), "batch_stats")})
    assert set(got) == set(want)
    for k, w in want.items():
        if "batch_stats" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
            continue
        g = np.minimum(np.abs(jgrads[k]), np.abs(pgrads[k]))
        firm = g > 1e-3 * np.abs(jgrads[k]).max()
        if noise(k):
            firm[...] = False
        np.testing.assert_allclose(got[k][firm], w[firm], rtol=0, atol=1e-5, err_msg=k)
        assert np.abs(got[k] - w).max() <= 2 * LR, k
