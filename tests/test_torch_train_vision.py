"""The port's vision trainers held against the JAX package on the CPU in
float32: the losses and the sampler, ``VisionTrainer.fit`` (hard and soft),
its training prep on JAX's own augmentation draws, the seed ensemble, the
progressive trainer, the CLI twin and the sklearn splitters written out.

Both packages train ``test_cnn`` from the same Flax init (converted) on the
same batches: ``epoch_batches`` and ``weighted_sampler_indices`` make the
same numpy calls on ``default_rng(cfg.seed)``. The JAX side runs with
``bf16=False`` and dropout 0 (its configs' defaults are bf16 and 0.2), so the
dropout bits, which differ between the packages, do not enter.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import synth_images

LR = 1e-3


def _flax_init(name, size, seed, num_classes=2):
    from mmtrs_tpu.models.backbones.factory import create_model as jax_create

    net = jax_create(name, num_classes=num_classes, drop_rate=0.0, drop_path=0.0, dtype=jnp.float32)
    v = net.init(jax.random.key(seed), jnp.zeros((1, size, size, 3), jnp.float32), train=False)
    return jax.tree.map(np.asarray, v)


# -- losses and the sampler -------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_and_sampler_match_jax(smoothing):
    """ce_two_class (with and without class weights), bce_logits (with and
    without sample weights) within 1e-6 of JAX's; weighted_sampler_indices
    equal to JAX's on the same numpy generator."""
    from mmtrs_tpu.train import common as jc
    from mmtrs_tpu_torch.train import common as pc

    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (32, 2)).astype(np.float32)
    y = rng.integers(0, 2, 32)
    cw = np.array([0.7, 1.9], np.float32)
    for w in (None, cw):
        want = float(jc.ce_two_class(jnp.asarray(logits), jnp.asarray(y), smoothing,
                                     None if w is None else jnp.asarray(w)))
        got = float(pc.ce_two_class(torch.from_numpy(logits), torch.from_numpy(y), smoothing,
                                    None if w is None else torch.from_numpy(w)))
        assert abs(got - want) <= 1e-6, (got, want)
    z = rng.normal(0, 3, 32).astype(np.float32)
    t = rng.random(32).astype(np.float32)
    sw = rng.random(32).astype(np.float32)
    for s in (None, sw, np.zeros(32, np.float32)):
        want = float(jc.bce_logits(jnp.asarray(z), jnp.asarray(t), None if s is None else jnp.asarray(s)))
        got = float(pc.bce_logits(torch.from_numpy(z), torch.from_numpy(t), None if s is None else torch.from_numpy(s)))
        assert abs(got - want) <= 1e-6, (got, want)
    yy = (rng.random(50) < 0.2).astype(int)
    np.testing.assert_array_equal(pc.weighted_sampler_indices(yy, 64, np.random.default_rng(5)),
                                  jc.weighted_sampler_indices(yy, 64, np.random.default_rng(5)))


# -- VisionTrainer.fit in both packages -------------------------------------------------


def _data(n, size, seed, soft):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.35).astype(int)
    return dict(images=synth_images(n, size, seed=seed, labels=y), y=y,
                p=np.clip(y * 0.6 + rng.random(n) * 0.4, 0, 1) if soft else None,
                w=rng.uniform(0.5, 1.5, n) if soft else None, origin_id=np.arange(n) + 100 * seed)


KW = dict(model_name="test_cnn", img_size=32, epochs=2, batch_size=8, lr=LR, drop_rate=0.0, drop_path=0.0,
          bf16=False, seed=7)


@pytest.fixture(scope="module", params=["hard", "soft"])
def fit_runs(request):
    """VisionTrainer(test_cnn at 32², batch 8, 2 epochs).fit on 44 train and
    20 val images, in both packages from the same Flax init; each side's
    predict_proba (TTA) on val and tune_threshold_f1."""
    from mmtrs_tpu.config import VisionTrainConfig as JCfg
    from mmtrs_tpu.train.vision import VisionData as JData
    from mmtrs_tpu.train.vision import VisionTrainer as JTrainer
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.models.convert import vision_from_flax
    from mmtrs_tpu_torch.train.vision import VisionData, VisionTrainer

    task = request.param
    soft = task == "soft"
    tr, va = _data(44, 32, 1, soft), _data(20, 32, 2, soft)
    jt = JTrainer(JCfg(task=task, **KW))
    jstate, jhist = jt.fit(JData(**tr), JData(**va), log=lambda *a: None)
    jp = jt.predict_proba(jstate, JData(**va))
    jthr = jt.tune_threshold_f1(jstate, JData(**va))
    init = vision_from_flax(_flax_init("test_cnn", 32, KW["seed"], 2 if task == "hard" else 1), "test_cnn")
    pt = VisionTrainer(VisionTrainConfig(task=task, **KW), device="cpu", init=init)
    pstate, phist = pt.fit(VisionData(**tr), VisionData(**va), log=lambda *a: None)
    pp = pt.predict_proba(pstate, VisionData(**va))
    pthr = pt.tune_threshold_f1(pstate, VisionData(**va))
    return {"task": task, "jax": (jhist, jp, jthr), "port": (phist, pp, pthr), "trainer": pt, "state": pstate,
            "val": va}


def test_vision_fit_matches_jax(fit_runs):
    """Per epoch train loss and val loss within 1e-4 relative, val AUC
    within 1e-6 (both rank the same probabilities); predict_proba with the
    hflip TTA within 1e-4; the tuned F1 threshold equal or one step of the
    0.005 grid away."""
    (jhist, jp, jthr), (phist, pp, pthr) = fit_runs["jax"], fit_runs["port"]
    assert len(jhist) == len(phist) == 2
    for a, b in zip(jhist, phist):
        assert set(a) == set(b)
        for k in ("train_loss", "loss"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(a[k]), (k, a[k], b[k])
        assert abs(a["auc"] - b["auc"]) <= 1e-6
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-4)
    assert abs(pthr - jthr) <= 0.005 + 1e-9


def test_vision_tta_is_a_probability_mean(fit_runs):
    """predict_proba(tta=True) is the mean of the probabilities of the image
    and its W-flip (not of their logits), each view as predict_proba sees
    it alone."""
    from mmtrs_tpu_torch.train.vision import VisionData

    tr, st, va = fit_runs["trainer"], fit_runs["state"], fit_runs["val"]
    a = tr.predict_proba(st, VisionData(**va), tta=False)
    flipped = dict(va, images=np.ascontiguousarray(va["images"][:, :, ::-1]))
    b = tr.predict_proba(st, VisionData(**flipped), tta=False)
    np.testing.assert_allclose(tr.predict_proba(st, VisionData(**va), tta=True), (a + b) / 2, rtol=0, atol=1e-7)


def test_ensemble_predict_repairs_nan():
    """ensemble_predict: the sigmoid of the mean member logit; a NaN
    probability makes the mean NaN, which is repaired to logit 0 (p 0.5),
    as in the JAX package; per_model_aucs one AUC a member."""
    from mmtrs_tpu.train.vision import ensemble_predict as jens
    from mmtrs_tpu_torch.train.vision import VisionData, ensemble_predict, per_model_aucs

    members = [np.array([0.9, 0.2, np.nan, 0.5]), np.array([0.7, 0.4, 0.6, 1.0])]

    class Stub:
        def predict_proba(self, st, data, tta=True):
            return members[st]

    data = VisionData(images=np.zeros((4, 8, 8, 3), np.uint8), y=np.array([1, 0, 1, 0]))
    got = ensemble_predict(Stub(), [0, 1], data)
    want = jens(Stub(), [0, 1], data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[2] == 0.5 and np.isfinite(got).all()
    assert per_model_aucs(Stub(), [1], data) == [0.5]


# -- the training prep on JAX's draws ---------------------------------------------------


def test_train_prep_legacy_matches_jax(jax_tpu_route):
    """VisionTrainer._prep_images(train=True) with ``legacy`` on u8 [8, 64,
    64, 3] at seed + epoch 0, the port fed JAX's draws for keys_for_batch(0,
    ids, 0) (ids that fire every member but noise): un-normalised to levels,
    ≥ 99.5 % of values within 2 levels of the JAX trainer's prep on its TPU
    route (test_torch_augment's bar for the chain)."""
    from mmtrs_tpu.config import VisionTrainConfig as JCfg
    from mmtrs_tpu.train.vision import VisionTrainer as JTrainer
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.train.vision import VisionTrainer
    from tests.test_torch_augment import _covering_ids, _jax_draws, _keys

    ids = np.array(_covering_ids())
    imgs = synth_images(len(ids), 64, seed=3)
    kw = dict(KW, img_size=64, seed=0)
    want = np.asarray(JTrainer(JCfg(**kw), aug_preset="legacy")._prep_images(imgs, True, 0, ids, np.zeros(len(ids))))
    pt = VisionTrainer(VisionTrainConfig(**kw), aug_preset="legacy", device="cpu")
    draws, _ = _jax_draws(_keys(ids), 64, 64, hole=64 // 24)
    pt._draws = lambda *a: draws
    got = pt._prep_images(torch.from_numpy(imgs), True, 0, ids, np.zeros(len(ids), np.int64)).numpy()
    _level_bar(got, want)


def _level_bar(got, want, bar=0.995):
    std = np.array([0.229, 0.224, 0.225], np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    lv = lambda x: (x * std + mean) * 255.0
    d = np.abs(lv(got) - lv(want))
    assert (d <= 2.0 + 1e-3).mean() >= bar, ((d <= 2.0 + 1e-3).mean(), d.max())


def test_train_prep_ten_matches_jax(jax_tpu_route, jax_normals):
    """The same with ``ten``, all ten variants (aug_idx 0-9), its draws and
    normals from JAX for keys_for_batch(seed + epoch, ids, aug_idx), and a
    resize of the 64² batch to img_size 48 after the augmentation."""
    from mmtrs_tpu.config import VisionTrainConfig as JCfg
    from mmtrs_tpu.train.vision import VisionTrainer as JTrainer
    from mmtrs_tpu.utils.rng import keys_for_batch
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.train.vision import VisionTrainer
    from tests.test_torch_presets import _jax_ten_draws

    ids, which = np.arange(30, 40), np.arange(10, dtype=np.int32)
    imgs = synth_images(10, 64, seed=4)
    kw = dict(KW, img_size=48, seed=5)
    keys = keys_for_batch(kw["seed"] + 1, jnp.asarray(ids, jnp.uint32), jnp.asarray(which, jnp.uint32))
    draws, normals = _jax_ten_draws(keys, which, 64, 64)
    jax_normals(normals)
    want = np.asarray(JTrainer(JCfg(**kw), aug_preset="ten")._prep_images(imgs, True, kw["seed"] + 1, ids, which))
    pt = VisionTrainer(VisionTrainConfig(**kw), aug_preset="ten", device="cpu")
    pt._draws = lambda *a: draws
    got = pt._prep_images(torch.from_numpy(imgs), True, kw["seed"] + 1, ids, which).numpy()
    assert got.shape == (10, 48, 48, 3)
    _level_bar(got, want)


from tests.test_torch_augment import jax_tpu_route  # noqa: E402,F401  (a fixture)
from tests.test_torch_presets import jax_normals  # noqa: E402,F401  (a fixture)


# -- the progressive trainer ------------------------------------------------------------


def test_train_progressive_matches_jax(monkeypatch):
    """train_progressive with 2 stages (32² then 40², 1 epoch each, batch 8,
    warmup 3 steps in stage 0) × 2 seeds on 40 train / 16 val images at 40²,
    both packages' VisionTrainConfig patched to f32 and dropout 0, the port
    from JAX's init per seed: each member's val probabilities within 1e-4,
    and progressive_ensemble_probs within 1e-4."""
    import mmtrs_tpu.train.progressive as jprog
    import mmtrs_tpu_torch.train.progressive as pprog
    from mmtrs_tpu.config import ProgressiveConfig as JPC
    from mmtrs_tpu.config import ProgressiveStage as JPS
    from mmtrs_tpu.train.vision import VisionData as JData
    from mmtrs_tpu_torch.config import ProgressiveConfig, ProgressiveStage
    from mmtrs_tpu_torch.models.convert import vision_from_flax
    from mmtrs_tpu_torch.train.vision import VisionData

    off = dict(bf16=False, drop_rate=0.0, drop_path=0.0)
    monkeypatch.setattr(jprog, "VisionTrainConfig", functools.partial(jprog.VisionTrainConfig, **off))
    monkeypatch.setattr(pprog, "VisionTrainConfig", functools.partial(pprog.VisionTrainConfig, **off))
    tr, va = _data(40, 40, 5, False), _data(16, 40, 6, False)
    stages = ((32, 1, 8, 1e-3), (40, 1, 8, 5e-4))
    seeds = (3, 4)
    jcfg = JPC(model_name="test_cnn", stages=tuple(JPS(*s) for s in stages), seeds=seeds, warmup_steps=3)
    pcfg = ProgressiveConfig(model_name="test_cnn", stages=tuple(ProgressiveStage(*s) for s in stages), seeds=seeds,
                             warmup_steps=3)
    jstates = jprog.train_progressive(jcfg, JData(**tr), JData(**va), log=lambda *a: None)
    inits = {s: vision_from_flax(_flax_init("test_cnn", 32, s), "test_cnn") for s in seeds}
    pstates = pprog.train_progressive(pcfg, VisionData(**tr), VisionData(**va), log=lambda *a: None, device="cpu",
                                      inits=inits)
    assert len(pstates) == 2 and pstates[0][0].cfg.img_size == 40 and pstates[0][0].cfg.warmup_steps == 0
    for (jt, js), (pt, ps) in zip(jstates, pstates):
        np.testing.assert_allclose(pt.predict_proba(ps, VisionData(**va)), jt.predict_proba(js, JData(**va)),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(pprog.progressive_ensemble_probs(pstates, VisionData(**va)),
                               jprog.progressive_ensemble_probs(jstates, JData(**va)), rtol=0, atol=1e-4)


# -- the CLI twin -----------------------------------------------------------------------


def test_cli_twin_matches_run_train_images(tmp_path, monkeypatch):
    """``cli.run_train_images.main`` against ``run_train_images.main`` on a
    CSV of 36 rows (4 marked test, 2 without a file) and a folder of 40²
    JPEGs (resized to 32 by Pillow's BILINEAR in JAX, resize_bilinear_u8
    here), --task hard, test_cnn, 2 epochs, --aug none, both trainers
    patched to f32 and dropout 0 and the port given JAX's init: the
    summaries' history and thr within the fit test's bars, the recipes
    equal, and the npz checkpoint's leaves within 1e-4 of the Orbax one's."""
    import run_train_images as jcli
    import mmtrs_tpu.train.vision as jv
    import mmtrs_tpu_torch.train.vision as pv
    from mmtrs_tpu.utils.checkpoint import load_checkpoint
    from mmtrs_tpu_torch.cli import run_train_images as pcli
    from mmtrs_tpu_torch.models.convert import vision_from_flax
    from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint
    from mmtrs_tpu_torch.utils.images import save_jpeg
    from mmtrs_tpu_torch.utils.table import Table, to_csv

    n = 36
    rng = np.random.default_rng(9)
    y = (rng.random(n) < 0.4).astype(int)
    imgs = synth_images(n, 40, seed=9, labels=y)
    img_dir = tmp_path / "images"
    names = [f"t{i}.jpg" for i in range(n)]
    for i, name in enumerate(names):
        if i not in (5, 17):
            save_jpeg(img_dir / name, imgs[i])
    to_csv(Table({"image_name": names, "y_majority": y, "origin_id": np.arange(n) // 2,
                  "split": ["Test" if i >= 32 else "train" for i in range(n)]}), tmp_path / "meta.csv")
    off = dict(bf16=False, drop_rate=0.0, drop_path=0.0)
    monkeypatch.setattr("mmtrs_tpu.config.VisionTrainConfig",
                        functools.partial(jv.VisionTrainConfig, **off))
    monkeypatch.setattr("mmtrs_tpu_torch.config.VisionTrainConfig",
                        functools.partial(pv.VisionTrainConfig, **off))
    init = vision_from_flax(_flax_init("test_cnn", 32, 42), "test_cnn")
    orig = pv.VisionTrainer.__init__
    monkeypatch.setattr(pv.VisionTrainer, "__init__", lambda self, cfg, **k: orig(self, cfg, **dict(k, init=init)))
    args = ["--task", "hard", "--model", "test_cnn", "--img_size", "32", "--data", str(tmp_path / "meta.csv"),
            "--image_dir", str(img_dir), "--epochs", "2", "--batch_size", "8", "--lr", "1e-3"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert pcli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    js, ps = (json.loads((tmp_path / d / "hard_summary.json").read_text()) for d in ("jax", "port"))
    assert abs(js["thr"] - ps["thr"]) <= 0.005 + 1e-9
    for a, b in zip(js["history"], ps["history"]):
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-4 * a["train_loss"]
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * a["loss"]
    jtree, jrec = load_checkpoint(tmp_path / "jax" / "vision_hard_best")
    ptree, prec = load_npz_checkpoint(tmp_path / "port" / "vision_hard_best")
    assert prec == dict(jrec, thr=prec["thr"]) and set(prec) == {"model_name", "img_size", "task", "thr"}
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(a) for k, a in jax.tree_util.tree_leaves_with_path(t)}
    jl = flat({c: jtree[c] for c in ("params", "batch_stats")})
    pl = flat(ptree)
    assert set(jl) == set(pl)
    for k, a in jl.items():
        np.testing.assert_allclose(pl[k], a, rtol=0, atol=1e-4, err_msg=k)


def test_cli_needs_a_card_by_default(tmp_path):
    """Without --device the twin trains on the card; here, with none, it
    raises instead of training on the CPU."""
    from mmtrs_tpu_torch.cli import run_train_images as pcli
    from mmtrs_tpu_torch.utils.table import Table, to_csv

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    to_csv(Table({"image_name": ["a.jpg"], "y_majority": [1]}), tmp_path / "m.csv")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(["--data", str(tmp_path / "m.csv"), "--image_dir", str(tmp_path)])


# -- the splitters ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_group_splitters_match_sklearn(seed):
    """grouped_train_test_split and stratified_group_kfold (2 and 5 folds)
    give sklearn 1.9.0's GroupShuffleSplit / StratifiedGroupKFold(shuffle)
    indices on random groups and labels."""
    from sklearn.model_selection import GroupShuffleSplit, StratifiedGroupKFold

    from mmtrs_tpu.data.splits import grouped_train_test_split as jgtts
    from mmtrs_tpu_torch.data.splits import grouped_train_test_split, stratified_group_kfold
    from mmtrs_tpu_torch.utils.table import Table

    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 400))
    g = rng.integers(0, max(n // 3, 6), n)
    y = (rng.random(n) < rng.uniform(0.2, 0.8)).astype(int)
    import pandas as pd

    want = jgtts(pd.DataFrame({"origin_id": g}), 0.15, seed)
    got = grouped_train_test_split(Table({"origin_id": g}), 0.15, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tr, te = next(GroupShuffleSplit(1, test_size=0.3, random_state=seed).split(np.zeros(n), groups=g.astype(str)))
    a, b = grouped_train_test_split(Table({"origin_id": g}), 0.3, seed)
    np.testing.assert_array_equal(a, tr)
    np.testing.assert_array_equal(b, te)
    for k in (2, 5):
        want = list(StratifiedGroupKFold(k, shuffle=True, random_state=seed).split(np.zeros(n), y, g))
        got = list(stratified_group_kfold(y, g, k, seed))
        assert len(got) == k
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_vision_trainer_pretrained_and_head_bias():
    """init_state: the head bias fills both classifier biases for hard; a
    pretrained backbone tree (port names) replaces the backbone and keeps
    the head; one that does not fit raises."""
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.train.vision import VisionTrainer

    tr = VisionTrainer(VisionTrainConfig(**KW, task="hard"), device="cpu")
    st = tr.init_state(4, head_bias=-1.25)
    assert torch.all(st["model"]["classifier.bias"] == -1.25)
    pre = {k: torch.full_like(v, 0.5) for k, v in tr._init.items() if not k.startswith("classifier")}
    st = tr.init_state(4, pretrained=pre)
    assert torch.all(st["model"]["conv0.weight"] == 0.5)
    assert torch.equal(st["model"]["classifier.weight"], tr._init["classifier.weight"])
    with pytest.raises(ValueError, match="do not fit"):
        tr.init_state(4, pretrained={"conv0.weight": torch.zeros(3)})
