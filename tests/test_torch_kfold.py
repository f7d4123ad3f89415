"""The port's k-fold vision trainer held against the JAX package on the CPU
in float32: MixUp/CutMix on JAX's draws, the constrained threshold,
``run_hard_kfold`` with EMA, gradient accumulation, MixUp, patience and
``overfit_n``, the port's freeze, and a pin of the JAX package's
``optax.masked`` freeze.

Both packages train ``test_cnn`` (one logit) from the same Flax init on the
same batches; each side's ``create_model`` is patched to dropout 0 (the
factory's 0.2 would draw bits that differ between the packages), and the
port's MixUp draws are JAX's own for fold_in(key(seed), step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.synth import synth_images


def jax_mix_draws(key, batch, mixup_alpha=0.2, cutmix_alpha=1.0, p=0.5):
    """MixDraws from apply_mixup_cutmix's own draw lines (kfold.py:54-77)."""
    from mmtrs_tpu_torch.train.kfold import MixDraws

    kg, kl, kp, kc, kxy = jax.random.split(key, 5)
    ky, kx = jax.random.split(kxy)
    return MixDraws.from_numpy(
        jax.random.bernoulli(kg, p), jax.random.bernoulli(jax.random.fold_in(kg, 1)),
        jax.random.permutation(kp, batch), jax.random.beta(kl, mixup_alpha, mixup_alpha),
        jax.random.beta(kc, cutmix_alpha, cutmix_alpha), jax.random.uniform(ky, ()), jax.random.uniform(kx, ()))


def _kinds(n=40):
    """Steps of seed 0 whose draws give no mix, mixup and cutmix."""
    out = {}
    for s in range(n):
        d = jax_mix_draws(jax.random.fold_in(jax.random.key(0), s), 6)
        out.setdefault("off" if not d.gate else ("cut" if d.use_cut else "mix"), s)
    return out


@pytest.mark.parametrize("kind", ["off", "mix", "cut"])
def test_mixup_cutmix_matches_jax_on_its_draws(kind):
    """apply_mixup_cutmix on f32 [6, 20, 24, 3] and soft targets with JAX's
    draws: images within 1e-5 and targets within 1e-6 of JAX's (a cutmix box
    equal, since its bounds are the same f32 numbers)."""
    from mmtrs_tpu.train.kfold import apply_mixup_cutmix as jmix
    from mmtrs_tpu_torch.train.kfold import apply_mixup_cutmix

    key = jax.random.fold_in(jax.random.key(0), _kinds()[kind])
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (6, 20, 24, 3)).astype(np.float32)
    t = rng.random(6).astype(np.float32)
    wx, wt = jmix(jnp.asarray(x), jnp.asarray(t), key)
    gx, gt = apply_mixup_cutmix(torch.from_numpy(x), torch.from_numpy(t), jax_mix_draws(key, 6))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=0, atol=1e-6)
    if kind == "off":
        assert np.array_equal(gx.numpy(), x)
    if kind == "cut":
        changed = np.any(gx.numpy() != x, axis=(0, 3))
        assert changed.any() and np.array_equal(changed, np.any(np.asarray(wx) != x, axis=(0, 3)))


def test_mix_draws_from_the_ports_generator():
    """The port's own draws: per (seed, step) the same, another step other
    ones; the gate fires about half the time, a permutation each."""
    from mmtrs_tpu_torch.train.kfold import MixDraws

    draw = lambda s: MixDraws.draw(np.random.default_rng([42, s]), 8)
    fields = lambda d: (d.gate, d.use_cut, d.perm.tolist(), d.lam_mix, d.lam_cut, d.cy_u, d.cx_u)
    assert fields(draw(3)) == fields(draw(3)) and fields(draw(3)) != fields(draw(4))
    gates = [draw(s).gate for s in range(400)]
    assert 0.4 < np.mean(gates) < 0.6
    assert sorted(draw(5).perm) == list(range(8))


@pytest.mark.parametrize("objective,min_recall", [("max_f1", 0.0), ("max_acc", 0.9), ("max_f1", 1.1)])
def test_tune_threshold_constrained_matches_jax(objective, min_recall):
    """Equal thresholds to JAX's, the unreachable recall (1.1) falling back
    to the unconstrained optimum."""
    from mmtrs_tpu.train.kfold import tune_threshold_constrained as jt
    from mmtrs_tpu_torch.train.kfold import tune_threshold_constrained

    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 80)
    p = np.clip(y * 0.3 + rng.random(80) * 0.7, 0, 1)
    assert tune_threshold_constrained(y, p, objective, min_recall) == jt(y, p, objective, min_recall)


# -- run_hard_kfold in both packages ------------------------------------------------


def _cohort(n=56, size=32, seed=4):
    from mmtrs_tpu_torch.utils.table import Table

    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(int)
    table = {"image_name": [f"{i}.jpg" for i in range(n)], "y_majority": y,
             "origin_id": np.arange(n) // 2, "split": ["test" if i >= 48 else "train" for i in range(n)]}
    return table, Table(table), synth_images(n, size, seed=seed, labels=y)


KW = dict(model_name="test_cnn", img_size=32, epochs=3, batch_size=6, grad_accum=2, lr=1e-3, n_folds=2,
          seed=11, use_mixup=True, ema_decay=0.9, patience=2, overfit_n=18)


def _no_dropout(module):
    return functools.partial(module.create_model, drop_rate=0.0, drop_path=0.0)


@pytest.fixture(scope="module")
def kfold_runs(tmp_path_factory):
    """run_hard_kfold on 56 rows (8 test) at 32², 2 folds × 3 epochs, batch
    6, grad_accum 2, MixUp, EMA 0.9, patience 2, overfit_n 18, in both
    packages, the port on JAX's MixUp draws and init."""
    import pandas as pd

    import mmtrs_tpu.train.kfold as jk
    import mmtrs_tpu_torch.train.kfold as pk
    from mmtrs_tpu_torch.models.convert import vision_from_flax
    from tests.test_torch_train_vision import _flax_init

    mp = pytest.MonkeyPatch()
    mp.setattr(jk, "create_model", _no_dropout(jk))
    mp.setattr(pk, "create_model", _no_dropout(pk))
    mp.setattr(pk.KFoldHardTrainer, "_mix_draws",
               lambda self, step, b: jax_mix_draws(jax.random.fold_in(jax.random.key(self.cfg.seed), step), b))
    try:
        raw, table, imgs = _cohort()
        jdir, pdir = tmp_path_factory.mktemp("jax_kfold"), tmp_path_factory.mktemp("port_kfold")
        jout = jk.run_hard_kfold(imgs, pd.DataFrame(raw), jk.KFoldConfig(**KW), outdir=jdir, log=lambda *a: None)
        init = vision_from_flax(_flax_init("test_cnn", 32, KW["seed"], num_classes=1), "test_cnn")
        logs = []
        pout = pk.run_hard_kfold(imgs, table, pk.KFoldConfig(**KW), outdir=pdir, log=logs.append, device="cpu",
                                 init=init)
    finally:
        mp.undo()
    return {"jax": jout, "port": pout, "jdir": jdir, "pdir": pdir, "logs": logs}


def test_run_hard_kfold_matches_jax(kfold_runs):
    """Per fold val AUC within 1e-6 and the threshold within one 0.005 grid
    step; the OOF and test probabilities (prob_vis_hard) within 1e-4; the
    summary's keys and the CSVs' headers, names and labels equal."""
    from mmtrs_tpu_torch.utils.io import read_table

    j, p = kfold_runs["jax"], kfold_runs["port"]
    assert set(p) == set(j) | {"fits"}
    for a, b in zip(j["folds"], p["folds"]):
        assert set(a) == set(b) and a["fold"] == b["fold"]
        assert abs(a["val_auc"] - b["val_auc"]) <= 1e-6
        assert abs(a["thr"] - b["thr"]) <= 0.005 + 1e-9
    assert abs(j["test_auc"] - p["test_auc"]) <= 1e-6
    for name in ("oof_val.csv", "pred_test.csv"):
        jt, pt = read_table(kfold_runs["jdir"] / name), read_table(kfold_runs["pdir"] / name)
        assert (kfold_runs["pdir"] / name).read_text().splitlines()[0] == "image_name,y,prob_vis_hard"
        np.testing.assert_array_equal(pt["image_name"], jt["image_name"])
        np.testing.assert_array_equal(pt["y"], jt["y"])
        np.testing.assert_allclose(pt["prob_vis_hard"], jt["prob_vis_hard"], rtol=0, atol=1e-4)


def test_kfold_debug_tools(kfold_runs):
    """Each fold trained on overfit_n rows (3 steps an epoch at batch 6, an
    AdamW step every second), logged its loss, grad norm and logit std a
    epoch, and stopped early where val AUC did not rise for 2 epochs."""
    fits = kfold_runs["port"]["fits"]
    for f in fits:
        assert 1 <= len(f["history"]) <= 3 and f["frozen_moved"] is None
        for h in f["history"]:
            assert np.isfinite([h["loss"], h["grad_norm"], h["logit_std"]]).all() and h["grad_norm"] > 0
    assert sum(m.startswith("[kfold ep") for m in kfold_runs["logs"]) == sum(len(f["history"]) for f in fits)


def test_freeze_keeps_the_backbone_bit_unchanged():
    """freeze_epochs=1 in the port: through the frozen epoch every backbone
    parameter stays bit-equal to the fold's start while the classifier
    moves (BatchNorm statistics move, as in train mode); after unfreezing
    the backbone moves too; the optimiser of the frozen epoch held the
    classifier alone."""
    import mmtrs_tpu_torch.train.kfold as pk

    _, table, imgs = _cohort()
    cfg = pk.KFoldConfig(**dict(KW, freeze_epochs=1, use_mixup=False, ema_decay=0.0, patience=0, epochs=1))
    tr = pk.KFoldHardTrainer(cfg, device="cpu")
    y = np.asarray(table["y_majority"])
    idx = np.arange(48)
    best = tr.fit_fold(torch.from_numpy(imgs), y, idx[:36], idx[36:], log=lambda *a: None)
    assert best["frozen_moved"] == []
    assert tr.frozen_leaves_moved() == []
    assert [id(p) for p in tr.opt.params] == [id(p) for n, p in tr.model.named_parameters()
                                              if n.startswith("classifier.")]
    assert not torch.equal(tr.model.classifier.weight.detach(), tr._init["classifier.weight"])
    assert not torch.equal(tr.model.bn0.running_mean, tr._init["bn0.running_mean"])
    tr2 = pk.KFoldHardTrainer(pk.KFoldConfig(**dict(cfg.__dict__, epochs=2)), device="cpu")
    best = tr2.fit_fold(torch.from_numpy(imgs), y, idx[:36], idx[36:], log=lambda *a: None)
    assert best["frozen_moved"] == [] and len(tr2.frozen_leaves_moved()) > 0
    assert len(tr2.opt.params) == len(list(tr2.model.parameters()))


def test_jax_masked_freeze_passes_gradients_through():
    """The JAX package's freeze (optax.masked around AdamW) leaves the
    masked-out leaves' raw gradient as their update, so apply_updates moves
    a 'frozen' parameter from 1.0 to 1.5 on a gradient of 0.5. The port
    freezes instead; when optax or the JAX package changes this, this test
    shows it."""
    tx = optax.masked(optax.adamw(1e-3), {"backbone": False, "classifier": True})
    params = {"backbone": jnp.ones(3), "classifier": jnp.ones(2)}
    grads = {"backbone": jnp.full(3, 0.5), "classifier": jnp.full(2, 0.5)}
    upd, _ = tx.update(grads, tx.init(params), params)
    np.testing.assert_array_equal(np.asarray(upd["backbone"]), 0.5)
    new = optax.apply_updates(params, upd)
    np.testing.assert_array_equal(np.asarray(new["backbone"]), 1.5)
    assert np.all(np.abs(np.asarray(new["classifier"]) - 1.0) < 2e-3)


def test_quick_train_probe_and_card_default():
    """quick_train_probe is the AUC of the first n rows without TTA; the
    trainer takes the card by default and raises here without one."""
    import mmtrs_tpu_torch.train.kfold as pk
    from mmtrs_tpu_torch.metrics.binary import roc_auc

    _, table, imgs = _cohort()
    cfg = pk.KFoldConfig(model_name="test_cnn", img_size=32, batch_size=8)
    tr = pk.KFoldHardTrainer(cfg, device="cpu")
    st = {"model": tr.model.state_dict()}
    y = np.asarray(table["y_majority"])
    x = torch.from_numpy(imgs)
    assert tr.quick_train_probe(st, x, y, n=20) == roc_auc(y[:20], tr.predict_proba(st, x[:20], tta=False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pk.KFoldHardTrainer(cfg)
