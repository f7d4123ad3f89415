"""The port's tabular trainers and stacks held against the JAX package on
the CPU: ``train_tab_kfold``, ``train_xgb_like`` and ``train_lgbm_like``,
the final stack and its tab stream (the forests grown from JAX's own
subsampling masks), and the tabular stack. Split from
tests/test_torch_fusion.py, whose cohort and stream helpers it shares, so
that the two files run on different workers.

Bars: the tabular stack's meta coefficients within 1e-4 relative and its
threshold equal; the final stack's are wider, for the reason its test
gives."""

import json

import numpy as np
import pandas as pd
import pytest

from tests.synth import synth_standardized
from tests.test_torch_fusion import _fake_streams, _table
from tests.test_torch_gbdt_train import jax_draws_for


@pytest.fixture(scope="module")
def cohort():
    return synth_standardized(300, seed=21)


# -- the tabular trainers -------------------------------------------------------------------


def _small(cfg_cls, base, **kw):
    return cfg_cls(**{**base.__dict__, **kw})


def test_train_tab_kfold_and_xgb_like_match_jax(tmp_path, cohort):
    """train_tab_kfold (40 trees a fold, no subsampling): the saved forests
    read by both packages predict alike (within 1e-5); train_xgb_like
    (40 trees, isotonic): the same val rows, threshold and test metrics
    within 1e-5, and its artifacts named and shaped alike."""
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.train import tabular as jt
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.models.gbdt import predict_proba
    from mmtrs_tpu_torch.train import tabular as pt

    kw = dict(n_estimators=40, subsample=1.0, colsample=1.0)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt.train_tab_kfold(cohort, jdir, n_folds=3, cfg=_small(J, J.stack_tab_like(), **kw))
    pt.train_tab_kfold(_table(cohort), pdir, n_folds=3, cfg=_small(P, P.stack_tab_like(), **kw), device="cpu")
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) and len(names) == 6
    X = np.asarray(jt.build_features(cohort), np.float32)
    jf, pf = jt.load_tab_ensemble(jdir), pt.load_tab_ensemble(pdir, "cpu")
    np.testing.assert_allclose(pt.predict_tab_ensemble(pf, _table(cohort)), jt.predict_tab_ensemble(jf, cohort),
                               rtol=0, atol=1e-2)
    for a, b in zip(jf, pf):
        assert a.n_trees_used == b.n_trees_used
    cfg = dict(n_estimators=40, subsample=1.0, colsample=1.0, max_depth=3)
    jr = jt.train_xgb_like(cohort, jdir / "xgb", cfg=J(**cfg), calibration="isotonic")
    pr = pt.train_xgb_like(_table(cohort), pdir / "xgb", cfg=P(**cfg), calibration="isotonic", device="cpu")
    assert pr["thr"] == jr["thr"]
    for k in ("auc", "acc", "f1", "brier"):
        assert abs(pr["test_metrics"][k] - jr["test_metrics"][k]) <= 1e-5, k
    assert sorted(p.name for p in (pdir / "xgb").iterdir()) == sorted(p.name for p in (jdir / "xgb").iterdir())
    np.testing.assert_allclose(predict_proba(pr["forest"], X).numpy(), np.asarray(jt.predict_proba(jr["forest"], X)),
                               rtol=0, atol=1e-5)


def test_train_lgbm_like_matches_jax(tmp_path, cohort):
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.train import tabular as jt
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.train import tabular as pt

    jr = jt.train_lgbm_like(cohort, tmp_path / "j", cfg=_small(J, J.lgbm_like(), n_estimators=60))
    pr = pt.train_lgbm_like(_table(cohort), tmp_path / "p", cfg=_small(P, P.lgbm_like(), n_estimators=60),
                            device="cpu")
    assert pr["forest"].n_trees_used == jr["forest"].n_trees_used
    for k in ("auc", "acc", "brier"):
        assert abs(pr["test_metrics"][k] - jr["test_metrics"][k]) <= 1e-5, k
    a = pd.read_csv(tmp_path / "j" / "lgbm_test_predictions.csv")
    b = pd.read_csv(tmp_path / "p" / "lgbm_test_predictions.csv")
    assert list(a.columns) == list(b.columns)
    np.testing.assert_allclose(b["score_prob_indirect"], a["score_prob_indirect"], rtol=0, atol=1e-5)


# -- the stacks ---------------------------------------------------------------------------


def _stream_tables(cohort):
    s = _fake_streams(cohort)
    idx_tv = cohort["split"].isin(["train", "val"]).to_numpy()
    tv, te = cohort[idx_tv].reset_index(drop=True), cohort[~idx_tv].reset_index(drop=True)
    mk = lambda d, p: pd.DataFrame({"image_name": d["image_name"], "y": d["y_majority"].astype(int), "prob": p})
    return mk(tv, s["prob_mm"][idx_tv]), mk(te, s["prob_mm"][~idx_tv]), mk(tv, s["prob_mil"][idx_tv]), \
        mk(te, s["prob_mil"][~idx_tv])


@pytest.fixture(scope="module")
def final_stacks(tmp_path_factory, cohort):
    """run_final_stack in both packages (tab stream: stack_tab_like at 150
    trees, the port on JAX's masks), thr_mode max_acc."""
    from mmtrs_tpu.config import FusionConfig as JF
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.fusion import run_final_stack as jrun
    from mmtrs_tpu_torch.config import FusionConfig as PF
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.fusion.stack import run_final_stack

    frames = _stream_tables(cohort)
    jcfg = _small(J, J.stack_tab_like(), n_estimators=150)
    jdir, pdir = tmp_path_factory.mktemp("jstack"), tmp_path_factory.mktemp("pstack")
    want = jrun(cohort, *frames, outdir=jdir, cfg=JF(thr_mode="max_acc"), tab_cfg=jcfg)
    got = run_final_stack(_table(cohort), *[_table(f) for f in frames], outdir=pdir, cfg=PF(thr_mode="max_acc"),
                          tab_cfg=_small(P, P.stack_tab_like(), n_estimators=150), device="cpu",
                          draws_for=jax_draws_for(jcfg))
    return want, got, jdir, pdir


def test_run_final_stack_matches_jax(final_stacks):
    """meta_coef and the intercept within 1e-3 relative of the largest
    coefficient, the threshold within one step of the stack grid (0.0049),
    the summary's keys and features equal, and the trio's files with the
    same rows and columns (probs within 1e-2).

    Not 1e-4 and an equal threshold: the tab stream's forests
    (stack_tab_like: reg_lambda 0, min_child_weight 1, depth 5) choose
    between splits whose gains agree to the last bits, so the sigmoid's
    last bit (XLA's exp against PyTorch's) changes some trees. Changing only
    the port's own sigmoid to a float64 one moves its tab OOF by 7.2e-3; the
    port against JAX reads 3.3e-2 there (test_fit_tab_oof_matches_jax), and
    here meta_coef 9.9e-4 off on a largest coefficient of 3.99 (2.5e-4
    relative) and max_acc's threshold one grid step off (0.5742 against
    0.5693)."""
    want, got, jdir, pdir = final_stacks
    assert got["features"] == want["features"] == ["prob_tab", "prob_mm", "prob_mil"]
    scale = np.abs(want["meta_coef"]).max()
    assert np.abs(np.subtract(got["meta_coef"], want["meta_coef"])).max() <= 1e-3 * scale
    assert abs(got["meta_intercept"] - want["meta_intercept"]) <= 1e-3 * scale
    assert abs(got["thr"] - want["thr"]) <= 0.0049 + 1e-9 and set(got) == set(want)
    for name in ("stack_oof.csv", "stack_test.csv"):
        a, b = pd.read_csv(jdir / name), pd.read_csv(pdir / name)
        assert list(a.columns) == list(b.columns) == ["image_name", "y", "prob"]
        assert a["image_name"].tolist() == b["image_name"].tolist() and a["y"].tolist() == b["y"].tolist()
        np.testing.assert_allclose(b["prob"], a["prob"], rtol=0, atol=1e-2)
    assert set(json.loads((pdir / "summary.json").read_text())) == set(json.loads((jdir / "summary.json").read_text()))


def test_fit_tab_oof_matches_jax(cohort):
    """The tab stream alone (3 folds, 60 trees), on JAX's masks: rows and
    labels equal, OOF and test probabilities within 5e-2 (stack_tab_like's
    near-equal splits, see test_run_final_stack_matches_jax; at 5 folds
    and 150 trees it read 3.3e-2)."""
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.fusion import fit_tab_oof as jfit
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.fusion.stack import fit_tab_oof

    jcfg = _small(J, J.stack_tab_like(), n_estimators=60)
    df = cohort.drop(columns=["origin_id"])
    jo, jte = jfit(df, folds=3, cfg=jcfg)
    po, pte = fit_tab_oof(_table(df), folds=3, cfg=_small(P, P.stack_tab_like(), n_estimators=60), device="cpu",
                          draws_for=jax_draws_for(jcfg))
    for a, b in ((jo, po), (jte, pte)):
        assert b.columns == ["image_name", "y", "prob"]
        assert np.array_equal(b["image_name"], a["image_name"].to_numpy())
        assert np.array_equal(b["y"], a["y"].to_numpy())
        np.testing.assert_allclose(b["prob"], a["prob"].to_numpy(), rtol=0, atol=5e-2)


class _Trees:
    """Stands in for ``GBDTConfig`` in a stack module: its recipes at
    ``n`` trees (the module builds ``GBDTConfig()`` and ``.lgbm_like()``)."""

    def __init__(self, cls, n: int):
        self.cls, self.n = cls, n

    def __call__(self, **kw):
        return self.cls(**{"n_estimators": self.n, **kw})

    def lgbm_like(self):
        return _small(self.cls, self.cls.lgbm_like(), n_estimators=self.n)


def test_run_tabular_stack_matches_jax(tmp_path, cohort, monkeypatch):
    """3 folds of the XGB-like and LGBM-like forests (the recipes at 150
    trees in both packages, the port on JAX's masks): meta_coef within 1e-4
    relative, the threshold and the test payload equal, the artifacts
    named alike. At the recipes' 1,200 trees the pair took 57 s alone and
    644 s beside the rest of the suite."""
    import mmtrs_tpu.fusion.stack as jstack
    import mmtrs_tpu_torch.fusion.stack as pstack
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu_torch.config import GBDTConfig as P

    monkeypatch.setattr(jstack, "GBDTConfig", _Trees(J, 150))
    monkeypatch.setattr(pstack, "GBDTConfig", _Trees(P, 150))
    want = jstack.run_tabular_stack(cohort, outdir=tmp_path / "j", n_folds=3)
    jx, jl = _small(J, J(), n_estimators=150), _small(J, J.lgbm_like(), n_estimators=150)
    got = pstack.run_tabular_stack(_table(cohort), outdir=tmp_path / "p", n_folds=3, device="cpu",
                                   draws_for=(jax_draws_for(jx), jax_draws_for(jl)))
    scale = np.abs(want["meta_coef"]).max()
    assert np.abs(np.subtract(got["meta_coef"], want["meta_coef"])).max() <= 1e-4 * scale
    assert got["thr"] == want["thr"] and got["test"] == want["test"]
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
