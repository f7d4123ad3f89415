"""The port's stream collection, threshold sweep and MM finalize held
against the JAX package on the CPU.

``collect_base_preds`` reads the npz that scripts/export_npz_checkpoints.py
writes beside a JAX-trained, Orbax-saved ``vision_hard_best``, and the
forests as both packages save them; the failure cases are the JAX package's
own (tests/test_parity_surfaces.py). ``finalize_mm_from_ckpts`` is held to
the port's own training run and to the JAX finalize on JAX-trained folds,
exported to npz.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tests.synth import synth_images, synth_standardized


def _frames(n=40, seed=7):
    from mmtrs_tpu_torch.utils.table import Table

    df = synth_standardized(n, seed=seed)
    is_test = df["split"] == "test"
    parts = [df[~is_test].reset_index(drop=True), df[is_test].reset_index(drop=True)]
    return parts, [Table({c: p[c].to_numpy() for c in p.columns}) for p in parts]


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    """A JAX VisionTrainer (test_cnn at 32², f32, 1 epoch) saved as Orbax
    ``vision_hard_best`` with its recipe and exported to npz, and a JAX
    forest saved as ``xgb_forest``, nested one level each."""
    from mmtrs_tpu.config import GBDTConfig, VisionTrainConfig
    from mmtrs_tpu.data.features import build_features
    from mmtrs_tpu.models.gbdt import train_gbdt
    from mmtrs_tpu.train.vision import VisionData, VisionTrainer
    from mmtrs_tpu.utils.checkpoint import save_checkpoint
    from scripts.export_npz_checkpoints import export_folder

    root = tmp_path_factory.mktemp("streams")
    (df_val, df_test), _ = _frames()
    X = build_features(df_val).to_numpy(np.float32)
    y = df_val["y_majority"].astype(int).to_numpy()
    train_gbdt(X, y, GBDTConfig(n_estimators=8, max_depth=2, early_stopping_rounds=0)).save(
        root / "ml" / "sub" / "xgb_forest")
    rng = np.random.default_rng(3)
    yy = (rng.random(40) < 0.4).astype(int)
    data = lambda s: VisionData(images=synth_images(20, 32, seed=s, labels=yy[:20]), y=yy[:20])
    vt = VisionTrainer(VisionTrainConfig(model_name="test_cnn", img_size=32, epochs=1, batch_size=8, bf16=False,
                                         drop_rate=0.0))
    state, _ = vt.fit(data(4), data(5), log=lambda *a: None)
    wdir = root / "weights" / "vision"
    save_checkpoint(wdir / "vision_hard_best", {"params": state.params, "batch_stats": state.batch_stats},
                    recipe={"model_name": "test_cnn", "img_size": 32, "task": "hard", "thr": 0.5})
    assert [p.name for p in export_folder(root / "weights")] == ["vision_hard_best.npz"]
    return root


def test_collect_base_preds_matches_jax(saved_models):
    """Discovery by the JAX package's globs (nested one level): v_hard and
    xgb found, v_soft and lgbm None; each found stream within 1e-5 of the
    JAX package's collect_base_preds on the same frames and images."""
    from mmtrs_tpu.fusion.streams import collect_base_preds as jcollect
    from mmtrs_tpu_torch.fusion.streams import collect_base_preds

    (jv, jt), (pv, pt_) = _frames()
    iv, it = synth_images(len(jv), 32, seed=1), synth_images(len(jt), 32, seed=2)
    kw = dict(weight_dir=saved_models / "weights", ml_dir=saved_models / "ml")
    want = jcollect(jv, jt, iv, it, **kw)
    got = collect_base_preds(pv, pt_, iv, it, device="cpu", **kw)
    for split, n in (("val", len(jv)), ("test", len(jt))):
        assert set(got[split]) == {"v_hard", "v_soft", "xgb", "lgbm"}
        assert got[split]["v_soft"] is None and got[split]["lgbm"] is None
        for k in ("v_hard", "xgb"):
            assert got[split][k] is not None and len(got[split][k]) == n
            np.testing.assert_allclose(got[split][k], want[split][k], rtol=0, atol=1e-5, err_msg=k)


def test_collect_base_preds_failure_modes_yield_none(tmp_path):
    """The JAX package's four load-time failures give None streams: a recipe
    without its payload, a recipe naming an unknown model, a forest npz that
    is not one, a forest whose json does not parse; and no folders at all."""
    from mmtrs_tpu_torch.fusion.streams import collect_base_preds

    _, (pv, pt_) = _frames()
    imgs, imgs_te = synth_images(len(pv), 32, seed=1), synth_images(len(pt_), 32, seed=2)
    wdir, mldir = tmp_path / "weights", tmp_path / "ml"
    wdir.mkdir()
    mldir.mkdir()
    (wdir / "vision_hard_best.recipe.json").write_text(json.dumps({"model_name": "test_cnn", "img_size": 32,
                                                                   "task": "hard"}))
    (wdir / "vision_soft_best.recipe.json").write_text(json.dumps({"model_name": "no_such_arch", "img_size": 32,
                                                                   "task": "soft"}))
    np.savez(wdir / "vision_soft_best.npz", **{"params/x": np.zeros(1)})
    (mldir / "xgb_forest.npz").write_bytes(b"not a real npz")
    (mldir / "lgbm_forest.npz").write_bytes(b"")
    (mldir / "lgbm_forest.json").write_text("{broken")
    out = collect_base_preds(pv, pt_, imgs, imgs_te, weight_dir=wdir, ml_dir=mldir, device="cpu")
    for split in ("val", "test"):
        assert all(out[split][k] is None for k in ("v_hard", "v_soft", "xgb", "lgbm"))
    empty = collect_base_preds(pv, pt_, None, None, weight_dir=tmp_path / "x", ml_dir=tmp_path / "y", device="cpu")
    assert all(v is None for s in empty.values() for v in s.values())


def test_prediction_errors_propagate(saved_models, monkeypatch):
    """An error raised while a loaded model predicts is not turned into a
    None stream."""
    from mmtrs_tpu_torch.fusion import streams
    from mmtrs_tpu_torch.train.vision import VisionTrainer

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(VisionTrainer, "predict_proba", boom)
    base = saved_models / "weights" / "vision" / "vision_hard_best"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        streams._predict_vision_ckpt(base, synth_images(3, 32, seed=1), device="cpu")


# -- the threshold sweep ----------------------------------------------------------------


@pytest.mark.parametrize("objective", ["max_acc", "max_f1", "recall_constrained"])
def test_threshold_sweep_matches_jax(objective, tmp_path):
    """run_threshold_sweep on 3 folds of logits: per fold T within 1e-4
    relative of JAX's LBFGS fit, the threshold equal or one step of the
    1001-step grid away, the test metrics at it equal where the threshold is;
    the aggregate's keys, and its means and population stds within 1e-4 of
    T's mean for T and 1e-9 for the rest where every fold's threshold is
    equal (it is, on these folds); the CSV's header equal; no plots
    without make_plots."""
    from mmtrs_tpu.eval.threshold_sweep import run_threshold_sweep as jsweep
    from mmtrs_tpu_torch.eval.threshold_sweep import run_threshold_sweep

    rng = np.random.default_rng(8)
    lv, yv, lt = [], [], []
    for k in range(3):
        y = (rng.random(120) < 0.45).astype(int)
        lv.append((y * 2.0 - 1.0) * rng.uniform(0.5, 3.0) + rng.normal(0, 1.5, 120))
        yv.append(y)
        lt.append(rng.normal(0, 2.0, 90))
    y_test = (rng.random(90) < 0.5).astype(int)
    lt = [z + (y_test * 2 - 1) for z in lt]
    want = jsweep(lv, yv, lt, y_test, objective, 0.9, outdir=tmp_path / "jax", make_plots=False)
    got = run_threshold_sweep(lv, yv, lt, y_test, objective, 0.9, outdir=tmp_path / "port", make_plots=False)
    assert set(got) == set(want) and set(got["aggregate"]) == set(want["aggregate"])
    same = True
    for a, b in zip(want["folds"], got["folds"]):
        assert set(a) == set(b)
        assert abs(b["T"] - a["T"]) <= 1e-4 * a["T"]
        assert abs(b["thr"] - a["thr"]) <= 0.001 + 1e-12
        if b["thr"] == a["thr"]:
            for m in ("val_acc", "val_f1", "test_acc", "test_f1", "test_auc"):
                assert abs(b[m] - a[m]) <= 1e-9, m
        same &= b["thr"] == a["thr"]
    assert same
    if same:
        for c, v in want["aggregate"].items():
            bar = 1e-4 * abs(v["mean"]) if c == "T" else 1e-9
            assert abs(got["aggregate"][c]["mean"] - v["mean"]) <= bar, c
            assert abs(got["aggregate"][c]["std"] - v["std"]) <= bar, c
    head = lambda d: (d / "threshold_sweep.csv").read_text().splitlines()[0]
    assert head(tmp_path / "port") == head(tmp_path / "jax")
    assert not (tmp_path / "port" / "plots").exists()
    assert json.loads((tmp_path / "port" / "threshold_sweep.json").read_text())["objective"] == objective


def test_plots_import_matplotlib_lazily(tmp_path, monkeypatch):
    """With matplotlib present make_plots writes the per-fold PNGs; where it
    cannot be imported, make_plots raises ImportError, as the JAX package."""
    import builtins

    from mmtrs_tpu_torch.eval.threshold_sweep import run_threshold_sweep

    y = np.array([0, 1] * 10)
    z = np.linspace(-2, 2, 20)
    run_threshold_sweep([z], [y], [z], y, outdir=tmp_path / "a")
    assert sorted(p.name for p in (tmp_path / "a" / "plots").iterdir()) == ["metrics_fold0.png", "roc_fold0.png"]
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError):
        run_threshold_sweep([z], [y], [z], y, outdir=tmp_path / "b")
    assert run_threshold_sweep([z], [y], [z], y, outdir=tmp_path / "c", make_plots=False)["folds"]


# -- finalize_mm_from_ckpts -------------------------------------------------------------


KW = dict(model_name="test_cnn", img_size=32, batch_size=12, lr=1e-3, n_folds=2, epochs=1, train_aug="none",
          tab_dropout=0.0, head_dropout=0.0)


def _mm_cohort():
    from mmtrs_tpu_torch.utils.table import Table

    n = 48
    df = synth_standardized(n, seed=11)
    df["split"] = ["test" if i >= 38 else "train" for i in range(n)]
    y = df["y_majority"].astype(int).to_numpy()
    return df, Table({c: df[c].to_numpy() for c in df.columns}), synth_images(n, 32, seed=12, labels=y)


def test_finalize_matches_the_ports_training_run(tmp_path):
    """The port's run_mm_kfold (f32, save_ckpts) then finalize_mm_from_ckpts
    on its folder: the finalized OOF and test probabilities equal the
    training run's within 1e-6, names and labels equal, and the three files
    written under finalized/."""
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.train.mm import finalize_mm_from_ckpts, run_mm_kfold
    from mmtrs_tpu_torch.utils.io import read_table

    _, table, imgs = _mm_cohort()
    cfg = MMJointConfig(**KW)
    out = run_mm_kfold(imgs, table, cfg, outdir=tmp_path / "train", save_ckpts=True, log=lambda *a: None,
                       device="cpu", dtype=torch.float32)
    fin = finalize_mm_from_ckpts(imgs, table, tmp_path / "train", cfg, outdir=tmp_path / "fin", log=lambda *a: None,
                                 device="cpu", dtype=torch.float32)
    for part in ("oof", "test"):
        np.testing.assert_array_equal(fin[part]["image_name"], out[part]["image_name"])
        np.testing.assert_array_equal(fin[part]["y"], out[part]["y"])
        np.testing.assert_allclose(fin[part]["prob"], out[part]["prob"], rtol=0, atol=1e-6)
    names = sorted(p.name for p in (tmp_path / "fin" / "finalized").iterdir())
    assert names == ["oof_val.csv", "pred_test.csv", "summary.json"]
    assert read_table(tmp_path / "fin" / "finalized" / "oof_val.csv").columns == ["image_name", "y", "prob"]
    assert set(fin["summary"]) == {"oof_auc", "test_auc", "finalized_from"}


def test_finalize_matches_jax_on_exported_folds(tmp_path, monkeypatch):
    """JAX's run_mm_kfold (its module patched to f32) saves Orbax folds;
    scripts/export_npz_checkpoints.py writes their npz; the JAX finalize on
    the Orbax folds and the port's on the npz agree within 1e-5 on the OOF
    and test probabilities, and the summary's AUCs within 1e-6."""
    import mmtrs_tpu.train.mm as jmm
    from mmtrs_tpu.config import MMJointConfig as JCfg
    from mmtrs_tpu.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.train.mm import finalize_mm_from_ckpts
    from scripts.export_npz_checkpoints import export_folder

    df, table, imgs = _mm_cohort()
    monkeypatch.setattr(jmm, "MMJointDualHead", functools.partial(MMJointDualHead, dtype=jnp.float32))
    jmm.run_mm_kfold(imgs, df, JCfg(**KW), outdir=tmp_path, save_ckpts=True, log=lambda *a: None)
    assert len(export_folder(tmp_path)) == 2
    want = jmm.finalize_mm_from_ckpts(imgs, df, tmp_path, JCfg(**KW), outdir=tmp_path / "jax", log=lambda *a: None)
    got = finalize_mm_from_ckpts(imgs, table, tmp_path, MMJointConfig(**KW), outdir=tmp_path / "port",
                                 log=lambda *a: None, device="cpu", dtype=torch.float32)
    for part in ("oof", "test"):
        np.testing.assert_array_equal(got[part]["image_name"], want[part]["image_name"].to_numpy())
        np.testing.assert_allclose(got[part]["prob"], want[part]["prob"].to_numpy(), rtol=0, atol=1e-5)
    for k in ("oof_auc", "test_auc"):
        assert abs(got["summary"][k] - want["summary"][k]) <= 1e-6
    assert pd.read_csv(tmp_path / "port" / "finalized" / "pred_test.csv").columns.tolist() == ["image_name", "y", "prob"]
