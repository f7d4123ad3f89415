"""The port's fusion layer held against the JAX package on the CPU: the
split copies against scikit-learn, the features, metrics, calibrators and
L1 logistic, the generic fusion with its recipe, and ``cli/run_fusion.py``
against ``run_fusion.py`` file for file (the tabular trainers and the
stacks: tests/test_torch_stack_fit.py).

Bars: the Newton and FISTA fits run in f32 in both packages, from
different f32 arithmetic (XLA's and PyTorch's): Platt's (a, b) within 1e-5
relative, L1 coefficients within 1e-4 relative, thresholds equal."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synth import synth_standardized


def _table(df: pd.DataFrame):
    from mmtrs_tpu_torch.utils.table import Table

    return Table({c: df[c].to_numpy() for c in df.columns})


@pytest.fixture(scope="module")
def cohort():
    return synth_standardized(300, seed=21)


def _fake_streams(df, seed=0):
    """tests/test_fusion.py's correlated-but-noisy stream probabilities."""
    rng = np.random.default_rng(seed)
    y = df["y_majority"].astype(int).to_numpy()
    mk = lambda noise: np.clip(0.5 + 0.35 * (y * 2 - 1) + rng.normal(0, noise, len(y)), 0.01, 0.99)
    return {"prob_mm": mk(0.25), "prob_mil": mk(0.3)}


# -- splits -------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 42, 7])
@pytest.mark.parametrize("n_pos", [13, 50])
def test_stratified_kfold_matches_sklearn(seed, n_pos):
    from sklearn.model_selection import StratifiedKFold

    from mmtrs_tpu_torch.data.splits import stratified_kfold

    y = np.r_[np.ones(n_pos), np.zeros(61)].astype(int)
    np.random.default_rng(seed).shuffle(y)
    want = list(StratifiedKFold(5, shuffle=True, random_state=seed).split(np.zeros(len(y)), y))
    got = list(stratified_kfold(y, 5, seed))
    assert len(got) == 5
    for (a, b), (c, d) in zip(want, got):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    noshuf = list(StratifiedKFold(3).split(np.zeros(len(y)), y))
    for (a, b), (c, d) in zip(noshuf, stratified_kfold(y, 3, shuffle=False)):
        assert np.array_equal(a, c) and np.array_equal(b, d)


@pytest.mark.parametrize("seed,test_size,n", [(42, 0.2, 97), (3, 0.25, 40), (11, 0.2, 255)])
def test_stratified_shuffle_split_matches_sklearn(seed, test_size, n):
    from sklearn.model_selection import StratifiedShuffleSplit

    from mmtrs_tpu_torch.data.splits import stratified_shuffle_split

    y = (np.random.default_rng(seed).random(n) < 0.37).astype(int)
    a, b = next(StratifiedShuffleSplit(1, test_size=test_size, random_state=seed).split(np.zeros(n), y))
    c, d = stratified_shuffle_split(y, test_size, seed)
    assert np.array_equal(a, c) and np.array_equal(b, d)


# -- features and metrics -------------------------------------------------------------------


def test_build_features_matches_jax(cohort):
    """The 16 columns equal, with a missing value, a float and a text
    number in the base columns."""
    from mmtrs_tpu.data.features import ALL_FEATURES, build_features as jbuild, features_to_array as jarr
    from mmtrs_tpu_torch.data.features import build_features, features_to_array

    df = cohort.copy()
    df["depth"] = df["depth"].astype(object)
    df.loc[df.index[0], "depth"] = "1"
    df.loc[df.index[1], "depth"] = np.nan
    df["width"] = df["width"].astype(float)
    df.loc[df.index[2], "width"] = 1.7
    want = jbuild(df)
    got = build_features(_table(df))
    assert got.columns == list(ALL_FEATURES)
    for c in ALL_FEATURES:
        assert np.array_equal(got[c], want[c].to_numpy()), c
    assert np.array_equal(features_to_array(_table(df)), jarr(df))
    assert np.array_equal(features_to_array(_table(cohort), engineered=False), jarr(cohort, engineered=False))


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_metrics_match_jax(thr):
    from mmtrs_tpu.metrics import binary as jb
    from mmtrs_tpu.metrics.thresholds import tune_threshold as jtune
    from mmtrs_tpu_torch.metrics import binary as pb
    from mmtrs_tpu_torch.metrics.thresholds import tune_threshold

    rng = np.random.default_rng(8)
    y = rng.integers(0, 2, 120)
    p = np.round(np.clip(0.5 * y + rng.normal(0.25, 0.25, 120), 0, 1), 2)  # ties
    for name in ("average_precision", "brier", "log_loss"):
        assert getattr(pb, name)(y, p) == getattr(jb, name)(y, p), name
    assert pb.binary_report(y, p, thr) == jb.binary_report(y, p, thr)
    assert pb.evaluate(y, p, thr) == jb.evaluate(y, p, thr)
    assert pb.summary_payload(y, p, thr) == jb.summary_payload(y, p, thr)
    for metric in ("f1", "accuracy", "balanced_accuracy", "youden", "pr_auc"):
        assert tune_threshold(y, p, metric) == jtune(y, p, metric), metric


# -- calibrators and the L1 logistic ----------------------------------------------------


@pytest.mark.parametrize("kind", ["platt", "sigmoid", "isotonic", "none"])
def test_calibrators_match_jax(kind):
    """Platt (plain and prior-corrected): a, b within 1e-5 relative;
    isotonic and none: equal transforms."""
    from mmtrs_tpu.models.linear import make_calibrator as jmake
    from mmtrs_tpu_torch.models.linear import make_calibrator

    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 150)
    s = np.clip(0.3 + 0.4 * y + rng.normal(0, 0.2, 150), 0, 1)
    s[:10] = s[10:20]  # duplicated scores for isotonic's merge
    want, got = jmake(kind, s, y), make_calibrator(kind, s, y, device="cpu")
    q = np.linspace(-0.1, 1.1, 57)
    if kind in ("platt", "sigmoid"):
        assert abs(got.a - want.a) <= 1e-5 * abs(want.a) and abs(got.b - want.b) <= 1e-5 * abs(want.b)
        np.testing.assert_allclose(got.transform(q), want.transform(q), rtol=1e-5)
    else:
        assert np.array_equal(np.asarray(got.transform(q)), np.asarray(want.transform(q)))


@pytest.mark.parametrize("C", [1.0, 0.05])
def test_l1_logistic_matches_jax(C):
    """FISTA in f32 in both: coefficients and intercept within 1e-4
    relative of the largest; the same zeros at strong regularisation; the
    simplex weights within 1e-4."""
    from mmtrs_tpu.models.linear import LogisticRegression as J
    from mmtrs_tpu_torch.models.linear import LogisticRegression as P

    rng = np.random.default_rng(10)
    X = rng.random((200, 4))
    y = (X @ [2, -1, 3, 0] + rng.normal(0, 1, 200) > 2).astype(int)
    a = J(penalty="l1", C=C, max_iter=5000).fit(X, y)
    b = P(penalty="l1", C=C, max_iter=5000).fit(X, y, device="cpu")
    scale = max(np.abs(a.coef_).max(), abs(a.intercept_))
    assert np.abs(b.coef_ - a.coef_).max() <= 1e-4 * scale
    assert abs(b.intercept_ - a.intercept_) <= 1e-4 * scale
    assert np.array_equal(a.coef_ == 0, b.coef_ == 0)
    np.testing.assert_allclose(b.weights_simplex, a.weights_simplex, rtol=0, atol=1e-4)


# -- generic fusion, its recipe, the CLI ----------------------------------------------------


def test_fit_fusion_recipe_and_fuse_streams_match_jax(tmp_path, cohort):
    """fit_fusion (isotonic): the same choice, calibrated matrices equal,
    weights within 1e-4, thresholds equal; load_recipe + fuse_streams of
    the port's folder equal JAX's of its own (p within 1e-4), a masked
    stream and no stream as JAX does."""
    from mmtrs_tpu.fusion import fit_fusion as jfit
    from mmtrs_tpu.fusion import fuse_streams as jfuse
    from mmtrs_tpu.fusion import load_recipe as jload
    from mmtrs_tpu_torch.fusion.fuse import fit_fusion
    from mmtrs_tpu_torch.fusion.infer import fuse_streams, load_recipe

    s = _fake_streams(cohort)
    y = cohort["y_majority"].astype(int).to_numpy()
    half = len(y) // 2
    sv = {"v_hard": s["prob_mm"][:half], "xgb": s["prob_mil"][:half]}
    st = {"v_hard": s["prob_mm"][half:], "xgb": s["prob_mil"][half:]}
    want = jfit(sv, y[:half], st, y[half:], out_dir=tmp_path / "j")
    got = fit_fusion(sv, y[:half], st, y[half:], out_dir=tmp_path / "p", device="cpu")
    assert got["choice"] == want["choice"] and got["streams_used"] == want["streams_used"]
    for part in ("stack", "blend"):
        np.testing.assert_allclose(got[part]["weights"], want[part]["weights"], rtol=0, atol=1e-4)
        assert got[part]["threshold"] == want[part]["threshold"]
    assert got["threshold"] == want["threshold"]
    for f in ("P_val.npy", "P_test.npy"):
        assert np.array_equal(np.load(tmp_path / "p" / f), np.load(tmp_path / "j" / f))
    jr, pr = jload(tmp_path / "j"), load_recipe(tmp_path / "p")
    for case in ({"v_hard": 0.9, "xgb": 0.8}, {"v_hard": 0.9}):
        a, b = jfuse(jr, case), fuse_streams(pr, case)
        assert b["label"] == a["label"] and b["streams_used"] == a["streams_used"]
        assert abs(b["p_indirect"] - a["p_indirect"]) <= 1e-4
    with pytest.raises(RuntimeError):
        fuse_streams(pr, {})


def _fusion_csv(path, cohort, with_val: bool):
    s = _fake_streams(cohort, seed=1)
    df = pd.DataFrame({"image_name": cohort["image_name"], "y_majority": cohort["y_majority"],
                       "split": cohort["split"].str.upper(), "prob_tab": s["prob_mil"][::-1],
                       "prob_mm": s["prob_mm"], "prob_mil": s["prob_mil"]})
    if not with_val:
        df["split"] = df["split"].replace({"VAL": "TRAIN"})
    df.to_csv(path, index=False)
    return path


@pytest.mark.parametrize("with_val", [True, False])
def test_cli_matches_run_fusion(tmp_path, cohort, with_val, capsys):
    """train (val rows given, or a stratified share of train), info,
    infer-one and infer-batch of both CLIs on the same CSV: the same files;
    P_val/P_test equal, fusion_summary.json's choice, streams and
    thresholds equal and weights within 1e-4; hybrid_test_predictions.csv
    with the same names and labels, p within 1e-4."""
    import run_fusion as jcli
    from mmtrs_tpu_torch.cli import run_fusion as pcli

    data = _fusion_csv(tmp_path / "preds.csv", cohort, with_val)
    jd, pd_ = tmp_path / "j", tmp_path / "p"
    assert jcli.main(["train", "--data", str(data), "--out_dir", str(jd)]) == 0
    assert pcli.main(["train", "--data", str(data), "--out_dir", str(pd_), "--device", "cpu"]) == 0
    assert sorted(p.name for p in pd_.iterdir()) == sorted(p.name for p in jd.iterdir())
    for f in ("P_val.npy", "P_test.npy"):
        assert np.array_equal(np.load(pd_ / f), np.load(jd / f))
    a, b = (json.loads((d / "fusion_summary.json").read_text()) for d in (jd, pd_))
    assert set(a) == set(b) and b["choice"] == a["choice"] and b["streams_used"] == a["streams_used"]
    assert b["threshold"] == a["threshold"]
    for part in ("stack", "blend"):
        np.testing.assert_allclose(b[part]["weights"], a[part]["weights"], rtol=0, atol=1e-4)
    capsys.readouterr()
    assert jcli.main(["info", "--fusion_dir", str(jd)]) == 0
    j_info = json.loads(capsys.readouterr().out)
    assert pcli.main(["info", "--fusion_dir", str(pd_)]) == 0
    p_info = json.loads(capsys.readouterr().out)
    assert set(p_info) == set(j_info) and p_info["streams_used"] == j_info["streams_used"]
    case = json.dumps({"prob_mm": 0.7, "prob_mil": 0.4})
    jcli.main(["infer-one", "--fusion_dir", str(jd), "--streams", case])
    j_one = json.loads(capsys.readouterr().out)
    pcli.main(["infer-one", "--fusion_dir", str(pd_), "--streams", case])
    p_one = json.loads(capsys.readouterr().out)
    assert p_one["label"] == j_one["label"] and abs(p_one["p_indirect"] - j_one["p_indirect"]) <= 1e-4
    assert jcli.main(["infer-batch", "--fusion_dir", str(jd), "--data", str(data), "--out_dir", str(jd)]) == 0
    assert pcli.main(["infer-batch", "--fusion_dir", str(pd_), "--data", str(data), "--out_dir", str(pd_)]) == 0
    ja, pa = pd.read_csv(jd / "hybrid_test_predictions.csv"), pd.read_csv(pd_ / "hybrid_test_predictions.csv")
    assert list(pa.columns) == list(ja.columns) and len(pa) == len(ja) > 0
    assert pa["image_name"].tolist() == ja["image_name"].tolist() and pa["label"].tolist() == ja["label"].tolist()
    np.testing.assert_allclose(pa["p_indirect"], ja["p_indirect"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pa["threshold"], ja["threshold"], rtol=0, atol=0)


def test_entry_points_need_the_card_by_default():
    """Without ``device`` the new entry points ask for the card, and raise
    on a machine without one."""
    from mmtrs_tpu_torch.config import GBDTConfig
    from mmtrs_tpu_torch.fusion.fuse import fit_fusion
    from mmtrs_tpu_torch.models.gbdt import train_gbdt
    from mmtrs_tpu_torch.train.mil import MILTrainer

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    X, y = np.zeros((4, 2), np.float32), np.array([0, 1, 0, 1])
    for call in (lambda: train_gbdt(X, y, GBDTConfig(n_estimators=1)),
                 lambda: fit_fusion({"a": y * 0.5}, y, {"a": y * 0.5}, y),
                 lambda: MILTrainer()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
