"""The port's split builders (mmtrs_tpu_torch/data/splits.py) and the two
split CLIs held against the JAX package: the 400-trial balanced grouped
split, its row fallback, propagation to augmented rows (with a base table
whose keys repeat, so pandas' left join repeats rows), the leakage check,
the audit and the k-fold table. Bars: indices and values equal, the CLIs'
CSVs byte for byte."""

import numpy as np
import pandas as pd
import pytest

from mmtrs_tpu_torch.utils.table import Table, to_csv


def _lineage(n_base: int, n_aug: int, seed: int, origin: bool = True) -> pd.DataFrame:
    """A lineage table: n_base originals then n_aug children each, labels
    per origin, a weight column and (optionally) origin_id."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n_base) < 0.35).astype(int)
    rows = []
    for i in range(n_base):
        rows.append({"image_name": f"{i + 1}.jpg", "origin_id": i + 1, "aug_idx": 0, "y_majority": y[i],
                     "weight": round(float(rng.random()), 3)})
    for i in range(n_base):
        for k in range(1, n_aug + 1):
            rows.append({"image_name": f"{i + 1}__aug{k}.jpg", "origin_id": i + 1, "aug_idx": k,
                         "y_majority": y[i], "weight": rows[i]["weight"]})
    df = pd.DataFrame(rows)
    return df if origin else df.drop(columns=["origin_id"])


def _port(df: pd.DataFrame, tmp_path, name="t.csv") -> Table:
    from mmtrs_tpu_torch.utils.io import read_table

    df.to_csv(tmp_path / name, index=False)
    return read_table(tmp_path / name)


@pytest.mark.parametrize("n,trials,fracs", [(60, 400, (0.7, 0.15, 0.15)), (37, 50, (0.6, 0.2, 0.2))])
def test_balanced_grouped_split_matches_jax(tmp_path, n, trials, fracs):
    from mmtrs_tpu.data import splits as J
    from mmtrs_tpu_torch.data import splits as P

    df = _lineage(n, 2, seed=n)
    kw = dict(train_frac=fracs[0], val_frac=fracs[1], test_frac=fracs[2], max_trials=trials, seed=5)
    want = J.balanced_grouped_split(df, J.ThreeWaySplitConfig(**kw))
    got = P.balanced_grouped_split(_port(df, tmp_path), P.ThreeWaySplitConfig(**kw))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_stratified_row_split_matches_jax(tmp_path):
    """No group column: the row-level stratified fallback."""
    from mmtrs_tpu.data import splits as J
    from mmtrs_tpu_torch.data import splits as P

    df = _lineage(80, 0, seed=2, origin=False)
    want = J.balanced_grouped_split(df, J.ThreeWaySplitConfig(seed=11))
    got = P.balanced_grouped_split(_port(df, tmp_path), P.ThreeWaySplitConfig(seed=11))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_score_balance_matches_jax():
    from mmtrs_tpu.data import splits as J
    from mmtrs_tpu_torch.data import splits as P

    for sizes, rates in (((70, 15, 15), (0.3, 0.4, 0.2)), ((10, 0, 3), (0.5, 0.0, 1.0))):
        assert P._score_balance(sizes, rates, 0.33, P.ThreeWaySplitConfig()) == \
            J._score_balance(sizes, rates, 0.33, J.ThreeWaySplitConfig())


@pytest.mark.parametrize("route", ["group", "group_dup", "parent", "stem", "stem_dup"])
def test_propagate_split_to_augmented_matches_jax(tmp_path, route):
    """Each route of the join: on the group, on a group whose base rows
    carry two splits (pandas repeats the augmented row), on an explicit
    parent column, on the image stem (no group column; one base stem twice
    with two splits, and children whose parent is absent get 'train')."""
    from mmtrs_tpu.data import splits as J
    from mmtrs_tpu_torch.data import splits as P

    df = _lineage(12, 2, seed=4)
    base = df[df["aug_idx"] == 0].reset_index(drop=True)
    base["split"] = np.resize(["train", "val", "test"], len(base))
    aug = df.copy()
    kw = {}
    if route == "group_dup":
        base = pd.concat([base, base.iloc[[1]].assign(split="test")], ignore_index=True)
    if route == "parent":
        aug = aug.assign(origin_id=aug["origin_id"] + 100,
                         parent=[f"{o}.jpg" for o in df["origin_id"]])
        kw = {"parent_col_aug": "parent"}
    if route.startswith("stem"):
        aug = aug.drop(columns=["origin_id"])
        aug.loc[len(aug)] = {"image_name": "99_aug1.jpg", "aug_idx": 1, "y_majority": 0, "weight": 0.5}
        if route == "stem_dup":
            base = pd.concat([base, base.iloc[[1]].assign(split="test")], ignore_index=True)
    want = J.propagate_split_to_augmented(aug, base, **kw)
    got = P.propagate_split_to_augmented(_port(aug, tmp_path, "a.csv"), _port(base, tmp_path, "b.csv"), **kw)
    want.to_csv(tmp_path / "jax.csv", index=False)
    to_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    if route == "group_dup":
        assert len(got) == len(aug) + 3


def test_leakage_and_audit_match_jax(tmp_path):
    from mmtrs_tpu.data import splits as J
    from mmtrs_tpu_torch.data import splits as P

    df = _lineage(15, 1, seed=8)
    df["split"] = np.where(df["origin_id"] % 3 == 0, "test", np.where(df["origin_id"] % 3 == 1, "Train", "val"))
    J.assert_no_group_leakage(df)
    P.assert_no_group_leakage(_port(df, tmp_path))
    assert P.audit_report(_port(df, tmp_path)) == J.audit_report(df)
    bad = df.copy()
    bad.loc[[16, 20, 22], "split"] = "test"
    with pytest.raises(AssertionError) as je:
        J.assert_no_group_leakage(bad)
    with pytest.raises(AssertionError) as pe:
        P.assert_no_group_leakage(_port(bad, tmp_path))
    assert str(pe.value) == str(je.value)
    assert P.audit_report(Table({"split": ["train"], "y_majority": [1]})) == \
        J.audit_report(pd.DataFrame({"split": ["train"], "y_majority": [1]}))


@pytest.mark.parametrize("test_prop", [0.2, 0.0])
def test_make_group_fold_table_matches_jax(tmp_path, test_prop):
    from mmtrs_tpu.data import splits as J
    from mmtrs_tpu_torch.data import splits as P

    df = _lineage(40, 2, seed=6)
    want = J.make_group_fold_table(df, n_folds=4, test_prop=test_prop, seed=3)
    got = P.make_group_fold_table(_port(df, tmp_path), n_folds=4, test_prop=test_prop, seed=3)
    want.to_csv(tmp_path / "jax.csv", index=False)
    to_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("case", ["lineage", "no_origin", "no_aug_idx"])
def test_make_balanced_splits_cli_matches_jax(tmp_path, case):
    """The CLI twin on a lineage table, on one without origin_id (base rows
    by aug_idx == 0, one group each, joined on image_name) and on one
    without aug_idx: the written CSVs byte for byte."""
    from mmtrs_tpu_torch.cli import make_balanced_splits as port_cli
    from scripts import make_balanced_splits as jax_cli

    df = _lineage(30, 2, seed=9, origin=case != "no_origin")
    if case == "no_aug_idx":
        df = df[df["aug_idx"] == 0].drop(columns=["aug_idx"])
    df.to_csv(tmp_path / "in.csv", index=False)
    args = ["--table", str(tmp_path / "in.csv"), "--trials", "60", "--seed", "7"]
    assert jax_cli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert port_cli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_make_group_splits_cli_matches_jax(tmp_path):
    from mmtrs_tpu_torch.cli import make_group_splits as port_cli
    from scripts import make_group_splits as jax_cli

    _lineage(50, 2, seed=10).to_csv(tmp_path / "in.csv", index=False)
    args = ["--csv", str(tmp_path / "in.csv"), "--folds", "3", "--test-prop", "0.2", "--seed", "5"]
    assert jax_cli.main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert port_cli.main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 8
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_split_clis_need_the_card_by_default(tmp_path):
    from mmtrs_tpu_torch.cli import make_balanced_splits, make_group_splits

    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    _lineage(10, 1, seed=1).to_csv(tmp_path / "in.csv", index=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_balanced_splits.main(["--table", str(tmp_path / "in.csv"), "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_group_splits.main(["--csv", str(tmp_path / "in.csv"), "--outdir", str(tmp_path / "o")])
