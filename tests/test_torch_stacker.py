"""The port's fusion layer held against the JAX package on the CPU:
``choose_threshold``, ``LogisticRegression`` (Newton in f32) and the
``Stacker`` fitted from the repo's out-of-fold CSVs read with the csv
module.

XLA's and PyTorch's f32 solves and reductions round differently, so the
coefficients are held to 1e-4 relative; a threshold on the grid is equal,
and ``youden`` (one of the scores) is within 1e-6.
"""

import numpy as np
import pandas as pd
import pytest

from tests.test_torch_mm import ROOT

OOF = ROOT / "results" / "rehearsal_r5"
MODES = ("max_f1", "max_acc", "youden", "target_prec", "target_rec")


def _seeded_scores(n=500, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    p = np.clip(0.5 + 0.25 * (y - 0.5) + rng.normal(0, 0.2, n), 0, 1)
    p[:40] = np.round(p[:40], 2)  # ties, some on the grid
    return y, p


@pytest.mark.parametrize("mode", MODES)
def test_choose_threshold_matches_jax(mode):
    from mmtrs_tpu.metrics import choose_threshold as jchoose
    from mmtrs_tpu_torch.metrics.thresholds import choose_threshold

    mm = pd.read_csv(OOF / "mm" / "oof_val.csv")
    for y, p in (_seeded_scores(), (mm["y"].astype(int).to_numpy(), mm["prob"].to_numpy())):
        assert choose_threshold(y, p, mode) == jchoose(y, p, mode)
        assert choose_threshold(y, p, mode, target=0.6) == jchoose(y, p, mode, target=0.6)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("penalty", ["l2", "none"])
@pytest.mark.parametrize("weighting", ["plain", "balanced", "sample_weight"])
def test_logistic_regression_matches_jax(penalty, weighting):
    """Unbalanced seeded data (3 features): coefficients and intercept
    within 1e-4 relative; predict_proba is float64 numpy on them."""
    from mmtrs_tpu.models.linear import LogisticRegression as JaxLR
    from mmtrs_tpu_torch.models.linear import LogisticRegression

    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (400, 3))
    y = (X @ [1.5, -0.7, 0.2] + rng.normal(0, 1, 400) > 0.8).astype(int)
    kw = {"class_weight": "balanced"} if weighting == "balanced" else {}
    sw = rng.uniform(0.2, 2.0, 400) if weighting == "sample_weight" else None
    want = JaxLR(penalty=penalty, C=0.5, max_iter=1000, **kw).fit(X, y, sample_weight=sw)
    got = LogisticRegression(penalty=penalty, C=0.5, max_iter=1000, **kw).fit(
        X, y, sample_weight=sw, device="cpu")
    assert _rel(np.r_[got.coef_, got.intercept_], np.r_[want.coef_, want.intercept_]) <= 1e-4
    assert 1 <= got.n_iter_ <= 1000
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X), atol=1e-5)
    with pytest.raises(ValueError, match="penalty"):
        LogisticRegression(penalty="l1").fit(X, y, device="cpu")


def _oof_rows(stream):
    from mmtrs_tpu_torch.serve.service import read_oof_csv

    return read_oof_csv(OOF / stream / "oof_val.csv")


def test_stacker_golden_fit_on_repo_oof():
    """Stacker.fit on results/rehearsal_r5/{mm,mil}/oof_val.csv (3,762 rows
    each): the JAX package's meta2 and thresholds, measured on the CPU."""
    from mmtrs_tpu_torch.serve.service import Stacker

    st = Stacker.fit(_oof_rows("mm"), _oof_rows("mil"), device="cpu")
    assert _rel(st.meta2.coef_, [4.174269, 2.372620]) <= 1e-4
    assert abs(st.meta2.intercept_ + 3.271809) <= 1e-4 * 3.271809
    assert st.thresholds["max_f1"] == pytest.approx(0.3218181818, abs=1e-9)
    assert st.thresholds["max_acc"] == pytest.approx(0.4752525253, abs=1e-9)
    assert abs(st.thresholds["youden"] - 0.4762211923) <= 1e-6
    assert st.meta3 is None


def _tab_oof(mm, seed=7):
    """A synthetic tab OOF file: the MM rows shuffled, 10 % dropped, y
    written as an integer, a seeded probability."""
    rng = np.random.default_rng(seed)
    tab = mm.sample(frac=0.9, random_state=seed)[["image_name", "y"]].copy()
    tab["y"] = tab["y"].astype(int)
    tab["prob"] = np.clip(0.3 + 0.4 * tab["y"] + rng.normal(0, 0.25, len(tab)), 0.001, 0.999)
    return tab


def test_stacker_matches_jax_with_tab_and_fuse(tmp_path):
    """With a tab OOF column: the inner join's rows, meta2/meta3 and the
    thresholds against the JAX Stacker on the same files; fuse in both
    modes within 1e-6 (p from f32-fitted coefficients)."""
    from mmtrs_tpu.serve.service import Stacker as JaxStacker
    from mmtrs_tpu_torch.serve.service import Stacker, read_oof_csv

    mm, mil = (pd.read_csv(OOF / s / "oof_val.csv") for s in ("mm", "mil"))
    _tab_oof(mm).to_csv(tmp_path / "tab.csv", index=False)
    tab = pd.read_csv(tmp_path / "tab.csv")
    want = JaxStacker.fit(mm, mil, tab)
    got = Stacker.fit(_oof_rows("mm"), _oof_rows("mil"), read_oof_csv(tmp_path / "tab.csv"),
                      device="cpu")
    assert _rel(got.meta2.coef_, want.meta2.coef_) <= 1e-4
    assert _rel(np.r_[got.meta3.coef_, got.meta3.intercept_],
                np.r_[want.meta3.coef_, want.meta3.intercept_]) <= 1e-4
    for mode in ("max_f1", "max_acc"):
        assert got.thresholds[mode] == want.thresholds[mode]
    assert abs(got.thresholds["youden"] - want.thresholds["youden"]) <= 1e-6
    for args in ((0.7, 0.4, None), (0.2, 0.9, 0.6), (0.55, 0.5, 0.05)):
        for legacy in (False, True):
            assert abs(got.fuse(*args, legacy_blend=legacy) - want.fuse(*args, legacy_blend=legacy)) <= 1e-6


def test_merge_keeps_pandas_order():
    """The join is pandas' inner merge: each left row in turn with its
    matches in right's order, duplicates included, y compared as a number."""
    from mmtrs_tpu_torch.serve.service import _merge

    left = pd.DataFrame({"image_name": ["a", "b", "a", "c", "d"], "y": [1.0, 0.0, 1.0, 1.0, 0.0],
                         "prob": [0.1, 0.2, 0.3, 0.4, 0.5]})
    right = pd.DataFrame({"image_name": ["c", "a", "b", "a", "d"], "y": [1, 1, 0, 1, 1],
                          "prob": [0.6, 0.7, 0.8, 0.9, 0.95]})
    want = left.merge(right.rename(columns={"prob": "q"}), on=["image_name", "y"])
    rows = lambda df: [{k: str(v) for k, v in r.items()} for r in df.to_dict("records")]
    got = _merge(rows(left), rows(right), "q")
    assert [(r["image_name"], float(r["prob"]), float(r["q"])) for r in got] == list(
        zip(want["image_name"], want["prob"], want["q"]))
