"""The port's MIL trainer held against the JAX package on the CPU in float32:
``make_bags`` on JAX's own bag draws, the whole ``run_mil_kfold`` on JAX's
bag draws, and its fold checkpoints read back by the port's
``MILEnsemble``. One train step of MILNet over the test net and over B0 is
held in tests/test_torch_mil_step.py.

The JAX trainer builds MILNet in bf16 with dropout 0.2 on the pooled
feature and the factory's drop-path 0.1; the tests swap in an f32 MILNet
without either (``functools.partial`` of MILNet and of the factory), give
the port the same Flax init and the same rates, and feed the port JAX's
bag draws (``BagDraws.from_numpy``), so both train the same network on the
same bags. The bars are the MM step's (test_cnn: gradients within 1e-4 of
their leaf's max; B0: 3e-4, with the blocks' last BatchNorm biases held as
rounding noise, as tests/test_torch_train_mm.py explains).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import synth_images, synth_standardized

LR = 1e-3


def jax_bag_draws(seed, origin_ids, bag_size, scale_range=(0.4, 1.0), hflip_p=0.5):
    """(area, y0, x0, flip) [B, K] as JAX's ``make_bags`` draws them from
    ``keys_for_batch(seed, origin_ids, 0)`` (mmtrs_tpu/models/mil.py)."""
    from mmtrs_tpu.utils.rng import keys_for_batch

    keys = keys_for_batch(seed, np.asarray(origin_ids), np.zeros(len(origin_ids)))

    def one(key):
        k1, k2, k3, k4, _ = jax.random.split(key, 5)
        return (jax.random.uniform(k1, (), minval=scale_range[0], maxval=scale_range[1]),
                jax.random.uniform(k2, (), minval=0.0, maxval=1.0),
                jax.random.uniform(k3, (), minval=0.0, maxval=1.0),
                jax.random.bernoulli(k4, hflip_p))

    bag_keys = jax.vmap(lambda k: jax.random.split(k, bag_size))(keys)
    return [np.asarray(a) for a in jax.vmap(jax.vmap(one))(bag_keys)]


class JaxBagDraws:
    """Stands in for the port's ``BagDraws`` in ``train.mil``: JAX's draws."""

    @staticmethod
    def draw(seed, origin_ids, bag_size=12, scale_range=(0.4, 1.0), hflip_p=0.5):
        from mmtrs_tpu_torch.models.mil import BagDraws

        return BagDraws.from_numpy(*jax_bag_draws(seed, origin_ids, bag_size, scale_range, hflip_p))


def _flax_milnet_f32():
    from mmtrs_tpu.models.mil import MILNet

    return functools.partial(MILNet, dtype=jnp.float32, drop_rate=0.0)


# -- bags ------------------------------------------------------------------------------


@pytest.mark.parametrize("hflip_p", [0.5, 0.0])
def test_make_bags_matches_jax(hflip_p):
    """[2, 64, 80, 3] u8, bag 3, out 32, JAX's draws fed in: within 1e-4
    (measured 0 with ``sqrt_rn``; 2.08e-3 with torch 2.13's CPU f32
    ``sqrt``, one ulp off on an area, which moves a bilinear tap)."""
    from mmtrs_tpu.models.mil import make_bags as jbags
    from mmtrs_tpu.utils.rng import keys_for_batch
    from mmtrs_tpu_torch.models.mil import BagDraws, make_bags

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 64, 80, 3)).astype(np.uint8)
    oid = np.array([3, 7])
    keys = keys_for_batch(5, oid, np.zeros(2))
    want = np.asarray(jbags(jnp.asarray(imgs), keys, 3, 32, (0.4, 1.0), hflip_p=hflip_p))
    draws = BagDraws.from_numpy(*jax_bag_draws(5, oid, 3, hflip_p=hflip_p))
    got = make_bags(torch.from_numpy(imgs), draws, 32).numpy()
    assert got.shape == want.shape == (2, 3, 32, 32, 3)
    assert np.abs(got - want).max() <= 1e-4


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` equals numpy's IEEE ``sqrt`` bit for bit on 1e6 f32
    values spread over every exponent: 0, subnormals, powers of 4 (exact
    roots), 1e6 − 260 random bit patterns below infinity."""
    from mmtrs_tpu_torch.ops.color import sqrt_rn

    rng = np.random.default_rng(0)
    pow4 = np.ldexp(1.0, np.arange(-148, 127, 2)).astype(np.float32)
    sub = np.array([1, 2, 3, 0x7FFFFF, 0x400000], np.uint32).view(np.float32)
    fixed = np.concatenate([[0.0, np.float32(np.finfo(np.float32).max)], pow4, sub]).astype(np.float32)
    bits = rng.integers(0, 0x7F800000, 10**6 - fixed.size, dtype=np.int64).astype(np.uint32)
    x = np.concatenate([fixed, bits.view(np.float32)])
    assert x.size == 10**6 and np.isfinite(x).all() and (x[5:] < np.float32(1.2e-38)).any()
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), np.sqrt(x).view(np.uint32))


def test_make_bags_on_an_area_where_torch_cpu_sqrt_is_an_ulp_off(monkeypatch):
    """An area searched from seeded draws in [0.4, 1): torch's CPU f32
    ``sqrt`` is one ulp from numpy's there and, used for ``side``, moves a
    bag pixel by more than 1e-4; ``make_bags`` (``sqrt_rn``) is within 1e-4
    of JAX's on it (JAX's draws pinned to that area by a zero-width scale
    range). On a torch whose CPU ``sqrt`` is IEEE no area is off, and the
    first draw is used."""
    import mmtrs_tpu_torch.models.mil as pmil
    from mmtrs_tpu.models.mil import make_bags as jbags
    from mmtrs_tpu.utils.rng import keys_for_batch
    from mmtrs_tpu_torch.models.mil import BagDraws, make_bags

    imgs = np.random.default_rng(2).integers(0, 256, (1, 64, 80, 3)).astype(np.uint8)
    cand = np.random.default_rng(3).uniform(0.4, 1.0, 4096).astype(np.float32)
    off = cand[torch.sqrt(torch.from_numpy(cand)).numpy() != np.sqrt(cand)]
    oid = np.array([4])

    _, y0, x0, flip = jax_bag_draws(5, oid, 1)  # independent of the scale range

    def bags(area):
        d = BagDraws.from_numpy(np.full((1, 1), area, np.float32), y0, x0, flip)
        return make_bags(torch.from_numpy(imgs), d, 32).numpy()

    area = cand[0]
    for a in off[:64]:
        right = bags(a)
        with monkeypatch.context() as m:
            m.setattr(pmil, "sqrt_rn", torch.sqrt)
            naive = bags(a)
        if np.abs(naive - right).max() > 1e-4:
            area = a
            break
    else:
        assert off.size == 0, "no off-ulp area moves a tap"
    keys = keys_for_batch(5, oid, np.zeros(1))
    want = np.asarray(jbags(jnp.asarray(imgs), keys, 1, 32, (float(area), float(area))))
    assert np.abs(bags(area) - want).max() <= 1e-4


def test_make_bags_full_crop_is_the_image_and_flip_reverses_columns():
    """Area 1 at origin 0 with out = H = W samples every pixel once; the
    flip gives the same rows reversed."""
    from mmtrs_tpu_torch.models.mil import BagDraws, make_bags

    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 16, 16, 3)).astype(np.uint8))
    d = BagDraws(torch.ones(1, 2), torch.zeros(1, 2), torch.zeros(1, 2), torch.tensor([[False, True]]))
    out = make_bags(img, d, 16)
    assert torch.equal(out[0, 0], img[0].float())
    assert torch.equal(out[0, 1], img[0].flip(1).float())


def test_bag_draws_are_seeded_per_origin():
    """The same (seed, origin) gives the same instances whatever the batch;
    areas in the scale range; no flip at hflip_p 0."""
    from mmtrs_tpu_torch.models.mil import BagDraws

    a = BagDraws.draw(3, [5, 9], 12)
    b = BagDraws.draw(3, [9], 12)
    assert torch.equal(a.area[1], b.area[0]) and torch.equal(a.flip[1], b.flip[0])
    assert float(a.area.min()) >= 0.4 and float(a.area.max()) <= 1.0
    assert not BagDraws.draw(999, [5, 9], 12, hflip_p=0.0).flip.any()
    assert not torch.equal(a.area, BagDraws.draw(4, [5, 9], 12).area)


def test_train_mode_needs_a_generator_and_eval_does_not():
    """MILNet with its JAX rates: train mode raises without a generator and
    repeats itself per seed; eval mode takes none."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
    from mmtrs_tpu_torch.models.mil import MILNet

    net = lecun_init_(MILNet("test_cnn", dtype=torch.float32), torch.Generator().manual_seed(0))
    bags = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 3, 32, 32, 3)).astype(np.float32))
    net.train()
    with pytest.raises(ValueError, match="Generator"):
        net(bags)
    sd = {k: v.clone() for k, v in net.state_dict().items()}

    def logit(seed):
        net.load_state_dict(sd)
        return net(bags, generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(logit(1), logit(1)) and not torch.equal(logit(1), logit(2))
    net.eval()
    with torch.no_grad():
        assert torch.isfinite(net(bags)[0]).all()


# -- the slice: run_mil_kfold in both packages ------------------------------------------


KW = dict(model_name="test_cnn", bag_size=3, img_size=32, batch_size=8, lr=LR, n_folds=2, epochs=2)


@pytest.fixture(scope="module")
def kfold_runs(tmp_path_factory):
    """run_mil_kfold on 40 synthetic cases (10 test) at 32², 2 folds, 2
    epochs, save_ckpts, in both packages from the same Flax init, the port
    on JAX's bag draws."""
    import mmtrs_tpu.models.mil as jmil_model
    import mmtrs_tpu.train.mil as jmil
    import mmtrs_tpu_torch.train.mil as pmil
    from mmtrs_tpu.config import MILConfig as JaxCfg
    from mmtrs_tpu_torch.config import MILConfig
    from mmtrs_tpu_torch.models.convert import milnet_from_flax
    from mmtrs_tpu_torch.utils.table import Table

    n = 40
    df = synth_standardized(n, seed=6)
    df["split"] = ["test" if i >= 30 else "train" for i in range(n)]
    y = df["y_majority"].astype(int).to_numpy()
    imgs = synth_images(n, 40, seed=7, labels=y)
    jdir, pdir = tmp_path_factory.mktemp("jax_mil"), tmp_path_factory.mktemp("port_mil")
    flax_mil = _flax_milnet_f32()
    saved = (jmil.MILNet, jmil_model.create_model, pmil.BagDraws)
    jmil.MILNet = flax_mil
    jmil_model.create_model = functools.partial(saved[1], drop_path=0.0)
    pmil.BagDraws = JaxBagDraws
    try:
        jout = jmil.run_mil_kfold(imgs, df, JaxCfg(**KW), outdir=jdir, epochs=2, save_ckpts=True,
                                  log=lambda *a: None)
        net = flax_mil(model_name="test_cnn", attn_dim=128)
        v = net.init(jax.random.key(JaxCfg().seed), jnp.zeros((1, 3, 32, 32, 3)), train=False)
        table = Table({c: df[c].to_numpy() for c in df.columns})
        pout = pmil.run_mil_kfold(imgs, table, MILConfig(**KW), outdir=pdir, epochs=2, save_ckpts=True,
                                  log=lambda *a: None, device="cpu",
                                  init=milnet_from_flax(jax.tree.map(np.asarray, v)), dtype=torch.float32,
                                  drop_rate=0.0, drop_path=0.0)
    finally:
        jmil.MILNet, jmil_model.create_model, pmil.BagDraws = saved
    return {"jax": jout, "port": pout, "jdir": jdir, "pdir": pdir, "imgs": imgs, "table": table}


def test_run_mil_kfold_matches_jax(kfold_runs):
    """Per fold val_auc equal; OOF and test probabilities within 1e-3; the
    CSVs' headers, names and labels equal; summary.json with the same keys."""
    from mmtrs_tpu_torch.utils.io import read_table

    j, p = kfold_runs["jax"], kfold_runs["port"]
    js, ps = j["summary"], p["summary"]
    assert len(js["folds"]) == len(ps["folds"]) == 2
    for a, b in zip(js["folds"], ps["folds"]):
        assert a["fold"] == b["fold"] and abs(a["val_auc"] - b["val_auc"]) <= 1e-9
    assert abs(js["test_auc"] - ps["test_auc"]) <= 1e-3
    for part in ("oof", "test"):
        np.testing.assert_array_equal(p[part]["image_name"], j[part]["image_name"].to_numpy())
        np.testing.assert_array_equal(p[part]["y"], j[part]["y"].to_numpy())
        np.testing.assert_allclose(p[part]["prob"], j[part]["prob"].to_numpy(), rtol=0, atol=1e-3)
    jd, pd_ = kfold_runs["jdir"], kfold_runs["pdir"]
    for name in ("oof_val.csv", "pred_test.csv"):
        assert (pd_ / name).read_text().splitlines()[0] == (jd / name).read_text().splitlines()[0]
        assert read_table(pd_ / name).columns == ["image_name", "y", "prob"]
    jsum, psum = (json.loads((d / "summary.json").read_text()) for d in (jd, pd_))
    assert set(jsum) == set(psum)
    for k in range(2):
        jr = json.loads((jd / f"mil_v1_fold{k}.recipe.json").read_text())
        pr = json.loads((pd_ / f"mil_v1_fold{k}.recipe.json").read_text())
        assert jr == pr


def test_mil_folds_serve_from_the_folder(kfold_runs):
    """MILEnsemble.from_folder reads both npz folds into nets equal to the
    trained states, and predicts a finite p for a case's images."""
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble

    ens = MILEnsemble.from_folder(kfold_runs["pdir"], device="cpu")
    assert ens is not None and len(ens.nets) == 2
    for net, state in zip(ens.nets, kfold_runs["port"]["states"]):
        for k, v in state["model"].items():
            assert torch.equal(net.state_dict()[k].float(), v.float()), k
    p = ens.predict(kfold_runs["imgs"][:3])
    assert 0.0 <= p <= 1.0
