"""The port's GBDT fitting held against the JAX package on the CPU: the
binning, ``train_gbdt`` on both objectives with monotone constraints, with
early stopping and with the JAX package's own subsampling masks fed in
(``GBDTDraws.from_numpy``), the sample weights, and a forest saved by the
port and read by the JAX package.

The histograms are segment sums added in row order, the order of JAX's
``segment_sum`` on the CPU, so the split features and bins are equal and
the leaves agree within 1e-6 of the forest's largest leaf (the
validation loss's mean is reduced in another order: within 1e-6 relative).
The leaf bar is relative to the forest's scale, not to each leaf: the
sigmoid's last bit differs between the packages, a leaf is a sum of
gradients of both signs, and a leaf of 1.8e-4 read 6.7e-6 off relative
(1.2e-9 absolute) in ``binary_mono_full``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

LEAF_RTOL = 1e-6
VAL_RTOL = 1e-6


def jax_gbdt_masks(cfg, n: int, n_feat: int) -> tuple[np.ndarray, np.ndarray | None]:
    """The column [T, F] and row [T, n] masks JAX's ``train_gbdt`` draws
    (mmtrs_tpu/models/gbdt.py: ``scan_body`` and ``grow_tree``)."""
    keys = jax.random.split(jax.random.key(cfg.seed), cfg.n_estimators)

    def one(key):
        row = jnp.ones((n,), jnp.float32)
        if cfg.subsample < 1.0:
            ksub, key = jax.random.split(key)
            row = (jax.random.uniform(ksub, (n,)) < cfg.subsample).astype(jnp.float32)
        kcol, _ = jax.random.split(key)
        if cfg.colsample < 1.0:
            col = jax.random.uniform(kcol, (n_feat,)) < cfg.colsample
        else:
            col = jnp.ones((n_feat,), dtype=bool)
        return row, col.at[jnp.argmax(col)].set(True)

    rows, cols = jax.vmap(one)(keys)
    return np.asarray(cols), (np.asarray(rows) if cfg.subsample < 1.0 else None)


def jax_draws_for(cfg):
    """``draws_for`` (rows, features) → the port's draws holding JAX's masks."""
    from mmtrs_tpu_torch.models.gbdt import GBDTDraws

    return lambda n, f: GBDTDraws.from_numpy(*jax_gbdt_masks(cfg, n, f))


def _data(n=300, seed=0, soft=False):
    rng = np.random.default_rng(seed)
    X = np.c_[rng.integers(0, 3, (n, 7)), rng.normal(0, 1, (n, 2))].astype(np.float32)
    z = X[:, 0] - 0.5 * X[:, 1] + X[:, 7] + rng.normal(0, 1, n)
    y = (1 / (1 + np.exp(-z))).astype(np.float32) if soft else (z > 1).astype(np.float32)
    w = rng.uniform(0.3, 1.0, n)
    return X, y, w


def _configs():
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu_torch.config import GBDTConfig as P

    mono = (1, -1, 1, 1, 1, 0, 0, 0, 1)
    cases = {
        "binary_mono_full": dict(n_estimators=40, subsample=1.0, colsample=1.0, monotone_constraints=mono),
        "binary_masks": dict(n_estimators=40, subsample=0.8, colsample=0.7),
        "binary_stack_tab_like": {**J.stack_tab_like().__dict__, "n_estimators": 60},
        "soft_lgbm_like": {**J.lgbm_like().__dict__, "n_estimators": 60, "min_child_weight": 5.0},
        "soft_early_stop_masks": {**J.lgbm_like().__dict__, "n_estimators": 50, "subsample": 0.9,
                                  "colsample": 0.8, "early_stopping_rounds": 10, "monotone_constraints": mono},
    }
    return {k: (J(**v), P(**v)) for k, v in cases.items()}


def test_fit_bins_matches_jax():
    """Edges equal (dtype and value) on integer columns, a continuous one
    above max_bins distinct values (quantiles), a constant and a NaN-laced one."""
    from mmtrs_tpu.models.gbdt import fit_bins as jfit
    from mmtrs_tpu_torch.models.gbdt import fit_bins

    rng = np.random.default_rng(1)
    X = np.c_[rng.integers(0, 5, 500), rng.normal(0, 1, 500), np.full(500, 3.0), rng.normal(0, 1, 500)]
    X[::7, 3] = np.nan
    for max_bins in (16, 64):
        want, got = jfit(X, max_bins), fit_bins(X, max_bins)
        assert len(want.edges) == len(got.edges)
        for a, b in zip(want.edges, got.edges):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["binary_mono_full", "binary_masks", "soft_lgbm_like", "soft_early_stop_masks"])
def test_train_gbdt_matches_jax(case):
    """Split features and bins equal, leaves within 1e-6 of the largest
    (where no row reaches a leaf at reg_lambda 0, JAX's 0/0 is NaN and the
    port's leaf 0), the val history within 1e-6 relative,
    ``n_trees_used`` and the base score equal."""
    from mmtrs_tpu.models.gbdt import train_gbdt as jtrain
    from mmtrs_tpu_torch.models.gbdt import GBDTDraws, train_gbdt

    jcfg, pcfg = _configs()[case]
    X, y, w = _data(soft=jcfg.objective == "soft_regression")
    tr, va = slice(0, 220), slice(220, None)
    want = jtrain(X[tr], y[tr], jcfg, sample_weight=w[tr], X_val=X[va], y_val=y[va])
    draws = GBDTDraws.from_numpy(*jax_gbdt_masks(jcfg, 220, X.shape[1]))
    got = train_gbdt(X[tr], y[tr], pcfg, sample_weight=w[tr], X_val=X[va], y_val=y[va], draws=draws, device="cpu")
    assert np.array_equal(np.asarray(want.split_feat), got.split_feat.numpy())
    assert np.array_equal(np.asarray(want.split_bin), got.split_bin.numpy())
    lw, lg = np.asarray(want.leaf_value), got.leaf_value.numpy()
    empty = np.isnan(lw)
    assert np.isfinite(lg).all() and (lg[empty] == 0).all()
    ok = ~empty
    assert np.abs(lg[ok] - lw[ok]).max() <= LEAF_RTOL * np.abs(lw[ok]).max()
    np.testing.assert_allclose(got.val_history, want.val_history, rtol=VAL_RTOL, atol=0)
    assert got.n_trees_used == want.n_trees_used and got.base_score == want.base_score
    assert got.depth == want.depth


def test_train_gbdt_stack_tab_like_matches_jax():
    """``stack_tab_like`` (reg_lambda 0, min_child_weight 1, depth 5) with
    JAX's masks: at reg_lambda 0 a deep node's gains are G²/H of a few rows,
    and two splits whose gains agree to the last bits are common, so the
    sigmoid's last bit (XLA's exp against PyTorch's; every row's p is
    sigmoid(base) in the first tree) decides between them. Measured: 54 of
    60 trees split alike, the first differs at level 4 of tree 0, and the
    forests' probabilities on the 300 rows differ by at most 4.8e-3. Bars:
    90 % of the trees alike, probabilities within 1e-2, the val loss of the
    last tree within 1e-3 relative."""
    from mmtrs_tpu.models.gbdt import predict_proba as jpredict
    from mmtrs_tpu.models.gbdt import train_gbdt as jtrain
    from mmtrs_tpu_torch.models.gbdt import GBDTDraws, predict_proba, train_gbdt

    jcfg, pcfg = _configs()["binary_stack_tab_like"]
    X, y, w = _data()
    tr, va = slice(0, 220), slice(220, None)
    want = jtrain(X[tr], y[tr], jcfg, sample_weight=w[tr], X_val=X[va], y_val=y[va])
    draws = GBDTDraws.from_numpy(*jax_gbdt_masks(jcfg, 220, X.shape[1]))
    got = train_gbdt(X[tr], y[tr], pcfg, sample_weight=w[tr], X_val=X[va], y_val=y[va], draws=draws, device="cpu")
    alike = ((np.asarray(want.split_feat) == got.split_feat.numpy())
             & (np.asarray(want.split_bin) == got.split_bin.numpy())).all(1)
    assert alike.mean() >= 0.9
    assert np.abs(jpredict(want, X) - predict_proba(got, X).numpy()).max() <= 1e-2
    assert abs(got.val_history[-1] - want.val_history[-1]) <= 1e-3 * abs(want.val_history[-1])


def test_train_gbdt_without_val_uses_every_tree():
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.models.gbdt import train_gbdt as jtrain
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.models.gbdt import train_gbdt

    kw = dict(n_estimators=20, subsample=1.0, colsample=1.0, max_depth=3)
    X, y, _ = _data(120, seed=2)
    want = jtrain(X, y, J(**kw))
    got = train_gbdt(X, y, P(**kw), device="cpu")
    assert got.n_trees_used == want.n_trees_used == 20 and got.val_history is None
    lw = np.asarray(want.leaf_value)
    assert np.abs(got.leaf_value.numpy() - lw).max() <= LEAF_RTOL * np.abs(lw).max()


def test_train_gbdt_is_repeatable_and_its_draws_are_seeded():
    """Two fits from the default draws give the same forest; another seed
    another one; at least one column is kept in every tree."""
    from mmtrs_tpu_torch.config import GBDTConfig
    from mmtrs_tpu_torch.models.gbdt import GBDTDraws, train_gbdt

    cfg = GBDTConfig(n_estimators=15, subsample=0.7, colsample=0.2)
    X, y, _ = _data(150, seed=3)
    a = train_gbdt(X, y, cfg, device="cpu")
    b = train_gbdt(X, y, cfg, device="cpu")
    assert all(np.array_equal(getattr(a, k).numpy(), getattr(b, k).numpy(), equal_nan=True)
               for k in ("split_feat", "split_bin", "leaf_value"))
    d = GBDTDraws.draw(cfg, 150, 9)
    assert d.col_keep.any(1).all() and d.row_keep.shape == (15, 150)
    assert not torch.equal(d.col_keep, GBDTDraws.draw(GBDTConfig(n_estimators=15, colsample=0.2, seed=7), 150, 9).col_keep)


@pytest.mark.parametrize("power,balanced", [(0.7, True), (0.5, False), (0.0, True)])
def test_consensus_sample_weights_match_jax(power, balanced):
    from mmtrs_tpu.models.gbdt import consensus_sample_weights as jcsw
    from mmtrs_tpu_torch.models.gbdt import consensus_sample_weights

    rng = np.random.default_rng(4)
    w, y = rng.uniform(-0.1, 1.0, 80), rng.integers(0, 2, 80)
    want = jcsw(w, y, power, balanced)
    got = consensus_sample_weights(w, y, power, balanced)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_forest_saved_by_port_reads_in_jax(tmp_path):
    """npz + json: the JAX package's Forest.load reads the port's forest and
    predicts what the port predicts (f32, its scan against one reduction:
    within 1e-6)."""
    from mmtrs_tpu.models.gbdt import Forest as JForest
    from mmtrs_tpu.models.gbdt import predict_proba as jpredict
    from mmtrs_tpu_torch.config import GBDTConfig
    from mmtrs_tpu_torch.models.gbdt import Forest, predict_proba, train_gbdt

    X, y, _ = _data(200, seed=5)
    f = train_gbdt(X[:150], y[:150], GBDTConfig(n_estimators=30, early_stopping_rounds=5),
                   X_val=X[150:], y_val=y[150:], device="cpu")
    f.save(tmp_path / "tab_fold0")
    jf = JForest.load(tmp_path / "tab_fold0")
    assert jf.n_trees_used == f.n_trees_used and np.array_equal(np.asarray(jf.split_feat), f.split_feat.numpy())
    np.testing.assert_allclose(jpredict(jf, X), predict_proba(f, X).numpy(), rtol=0, atol=1e-6)
    back = Forest.load(tmp_path / "tab_fold0", "cpu")
    np.testing.assert_array_equal(back.val_history, f.val_history)
