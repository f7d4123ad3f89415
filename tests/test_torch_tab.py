"""The port's Tab stream held against the JAX package on the CPU:
``engineer_features``, ``apply_bins``, the forest walk (``predict_raw``,
``predict_proba``), ``Forest`` files, ``load_tab_ensemble`` and
``TabEnsemble``.

The JAX package adds the trees one after another in f32 (a ``scan``); the
port sums them in one f32 reduction, so the bar on p is 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import synth_standardized


@pytest.fixture(scope="module")
def tab_dir(tmp_path_factory):
    """A 3-fold tab ensemble as train_tab_kfold writes it (stack_tab_like:
    depth 5, class-balanced, with a validation prefix) on a synthetic
    cohort, 160 trees a fold."""
    from mmtrs_tpu.config import GBDTConfig
    from mmtrs_tpu.train.tabular import train_tab_kfold

    root = tmp_path_factory.mktemp("tab")
    cfg = dataclasses.replace(GBDTConfig.stack_tab_like(), n_estimators=160)
    train_tab_kfold(synth_standardized(150, seed=11), outdir=root, n_folds=3, cfg=cfg)
    return root


def _rows(n, seed):
    """[n, 9] encoded fields over every value each field takes (and a few
    off the encodings)."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(lo, hi + 1, n) for lo, hi in
            ((0, 1), (0, 1), (0, 1), (0, 1), (-1, 1), (0, 3), (0, 1), (0, 1), (0, 1))]
    x = np.stack(cols, axis=1).astype(np.float32)
    x[:4] += np.float32(0.5)
    return x


def test_engineer_features_matches_jax_exactly():
    from mmtrs_tpu.data.features import ALL_FEATURES as JAX_ALL, engineer_features_jax
    from mmtrs_tpu_torch.data.features import ALL_FEATURES, engineer_features

    x = _rows(400, seed=1)
    want = np.asarray(engineer_features_jax(jnp.asarray(x)))
    got = engineer_features(torch.from_numpy(x))
    assert ALL_FEATURES == JAX_ALL and got.shape == (400, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(engineer_features(torch.from_numpy(x[0])).numpy(), want[0])


def test_apply_bins_matches_jax_exactly():
    """Values on the edges, between, outside, ±inf and NaN; a feature with
    no edges takes bin 0."""
    from mmtrs_tpu.models.gbdt import BinSpec as JaxSpec, apply_bins as japply
    from mmtrs_tpu_torch.models.gbdt import BinSpec, apply_bins

    rng = np.random.default_rng(2)
    edges = tuple(np.sort(rng.normal(0, 1, k)).astype(np.float32) for k in (5, 0, 1, 63, 12))
    X = rng.normal(0, 1.5, (300, 5)).astype(np.float32)
    X[:5, 0] = edges[0]
    X[5:17, 4] = edges[4]
    X[17, :] = np.inf
    X[18, :] = -np.inf
    X[19, :] = np.nan
    want = japply(X, JaxSpec(edges))
    got = apply_bins(X, BinSpec(edges))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("objective", ["binary_logistic", "soft_regression"])
def test_predict_matches_jax(tab_dir, objective):
    """Forests written by train_tab_kfold, read by the port's
    load_tab_ensemble: raw scores within 4e-6 (a few f32 ULPs of the sum)
    and p within 1e-6 of the JAX package's; the soft-regression objective
    clips instead of the sigmoid."""
    from mmtrs_tpu.models import gbdt as jgbdt
    from mmtrs_tpu.train.tabular import load_tab_ensemble as jload
    from mmtrs_tpu_torch.data.features import engineer_features
    from mmtrs_tpu_torch.models.gbdt import predict_proba, predict_raw
    from mmtrs_tpu_torch.train.tabular import load_tab_ensemble

    jforests, forests = jload(tab_dir), load_tab_ensemble(tab_dir, device="cpu")
    assert len(forests) == len(jforests) == 3
    X = engineer_features(torch.from_numpy(_rows(256, seed=3))).numpy()
    for jf, f in zip(jforests, forests):
        assert f.n_trees_used == jf.n_trees_used and f.depth == jf.depth == 5
        assert f.split_feat.shape == (160, 31) and f.leaf_value.shape == (160, 32)
        jf, f = (dataclasses.replace(jf, objective=objective),
                 dataclasses.replace(f, objective=objective))
        raw = predict_raw(f, X)
        assert raw.dtype == torch.float32 and raw.shape == (256,)
        want = jgbdt.predict_raw(jf, X)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(raw.numpy(), want, atol=4e-6, rtol=0)
        np.testing.assert_allclose(predict_proba(f, X).numpy(), jgbdt.predict_proba(jf, X),
                                   atol=1e-6, rtol=0)


def test_forest_save_load_round_trip(tab_dir, tmp_path):
    """The port writes the JAX package's format: its saved forest loads in
    JAX with the same arrays and metadata, and back in the port."""
    from mmtrs_tpu.models.gbdt import Forest as JaxForest
    from mmtrs_tpu_torch.models.gbdt import Forest

    f = Forest.load(tab_dir / "tab_fold1", device="cpu")
    f.save(tmp_path / "copy")
    j, back = JaxForest.load(tmp_path / "copy"), Forest.load(tmp_path / "copy", device="cpu")
    orig = JaxForest.load(tab_dir / "tab_fold1")
    for name in ("split_feat", "split_bin", "leaf_value"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)), np.asarray(getattr(orig, name)))
        np.testing.assert_array_equal(getattr(back, name).numpy(), getattr(f, name).numpy())
    assert (j.depth, j.base_score, j.n_trees_used, j.objective) == (
        orig.depth, orig.base_score, orig.n_trees_used, orig.objective)
    np.testing.assert_array_equal(j.val_history, orig.val_history)
    for a, b in zip(j.bin_edges, orig.bin_edges):
        np.testing.assert_array_equal(a, b)


def test_tab_ensemble_matches_jax(tab_dir, tmp_path):
    """TabEnsemble.from_folder + predict_one on encoded UI fields: within
    1e-6 of the JAX ensemble; a folder that does not exist is no stream."""
    from mmtrs_tpu.serve.ensembles import TabEnsemble as JaxTab
    from mmtrs_tpu_torch.serve.ensembles import TabEnsemble

    jtab, tab = JaxTab.from_folder(tab_dir), TabEnsemble.from_folder(tab_dir, device="cpu")
    assert len(tab.forests) == 3
    for row in _rows(12, seed=4)[4:]:
        tab9 = [float(v) for v in row]
        assert abs(tab.predict_one(tab9) - jtab.predict_one(tab9)) <= 1e-6, tab9
    assert TabEnsemble.from_folder(tmp_path / "absent", device="cpu") is None


def test_tab_ensemble_takes_forests_to_its_device(tab_dir):
    """TabEnsemble built from loaded forests serves on the device it is
    given, with the answers of from_folder; Forest.to on the device the
    forest already lies on is the forest itself."""
    from mmtrs_tpu_torch.serve.ensembles import TabEnsemble
    from mmtrs_tpu_torch.train.tabular import load_tab_ensemble

    forests = load_tab_ensemble(tab_dir, "cpu")
    assert forests[0].to("cpu") is forests[0]
    tab, ref = TabEnsemble(forests, device="cpu"), TabEnsemble.from_folder(tab_dir, device="cpu")
    assert tab.device == torch.device("cpu")
    for row in _rows(6, seed=5):
        tab9 = [float(v) for v in row]
        assert tab.predict_one(tab9) == ref.predict_one(tab9)
