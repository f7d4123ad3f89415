"""The port's pandas-free tables held against the JAX package on the CPU:
``utils.table`` and ``utils.io.read_table``/``write_table`` against pandas,
``data.records.build_augmented_table`` against the JAX builder (cell by
cell, column order, and the CSV byte for byte), ``data.splits.group_kfold``
against sklearn's GroupKFold (through the JAX ``group_kfold``), and
``roc_auc``/``sweep_thresholds`` against the JAX metrics.

The JAX builder runs with preset ``none``: its table does not depend on the
preset (the port's test below holds ``ten``'s table to ``none``'s), and its
``ten`` would compile the preset's XLA programs on the CPU for minutes.
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synth import synth_standardized


def _table(df: pd.DataFrame):
    from mmtrs_tpu_torch.utils.table import Table

    cols = {}
    for c in df.columns:
        s = df[c]
        if pd.api.types.is_integer_dtype(s.dtype):
            cols[c] = s.to_numpy("int64")
        elif pd.api.types.is_float_dtype(s.dtype):
            cols[c] = s.to_numpy("float64")
        else:
            cols[c] = np.array([None if v is None else str(v) for v in s], dtype=object)
    return Table(cols)


def _csv(df: pd.DataFrame) -> str:
    buf = io.StringIO()
    df.to_csv(buf, index=False)
    return buf.getvalue()


def _assert_same(table, df):
    assert table.columns == list(df.columns)
    assert len(table) == len(df)
    for c in df.columns:
        want = [None if (isinstance(v, float) and np.isnan(v)) else v for v in df[c].tolist()]
        got = [None if (isinstance(v, float) and np.isnan(v)) else v for v in table[c].tolist()]
        assert got == want, c


def _cohort(n, with_split):
    df = synth_standardized(n, seed=11)
    if not with_split:
        df = df.drop(columns=["split"])
    return df.drop(columns=["origin_id"])


# -- the table and its CSV ------------------------------------------------------------


def test_table_rows_columns_and_csv_text():
    """take by index and by mask, a scalar column, concat, select; the CSV
    text equals pandas' to_csv for ints, floats (1.0, 1e-05, NaN), bools,
    quoted and empty strings; read back with pandas' types."""
    from mmtrs_tpu_torch.utils.table import Table, from_csv, to_csv

    cols = {
        "i": np.array([1, -2, 3], np.int64),
        "f": np.array([1.0, 1e-05, np.nan]),
        "f32": np.array([0.1, 2.5, 1e20], np.float32),
        "b": np.array([True, False, True]),
        "s": np.array(['a,b', 'q"x', None], dtype=object),
    }
    t = Table(cols)
    t["k"] = "same"
    assert t.columns == ["i", "f", "f32", "b", "s", "k"] and len(t) == 3
    assert t.take([2, 0])["i"].tolist() == [3, 1]
    assert t.take(t["b"])["i"].tolist() == [1, 3]
    assert Table.concat([t, t.take([1])])["s"].tolist() == ['a,b', 'q"x', None, 'q"x']
    assert t.select(["k", "i"]).columns == ["k", "i"]
    with pytest.raises(ValueError, match="columns differ"):
        Table.concat([t, t.select(["i"])])
    with pytest.raises(ValueError, match="rows"):
        t["bad"] = [1, 2]

    df = pd.DataFrame(cols)
    df["k"] = "same"
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = to_csv(t, Path(d) / "t.csv")
        assert p.read_text() == _csv(df)
        back = from_csv(p)
        ref = pd.read_csv(p)
    assert back.columns == list(ref.columns)
    assert back["i"].dtype == np.int64 and back["b"].dtype == bool
    np.testing.assert_array_equal(back["f"], ref["f"].to_numpy())
    assert back["s"].tolist() == ['a,b', 'q"x', None]


def test_float_cells_read_as_pandas_reads_them():
    """pandas' default parser keeps 17 digits counting a leading zero, so
    a shortest repr such as 0.42857142857142855 reads one bit off; the
    port's reader gives pandas' double for every cell, over random values
    in every decade, integers-as-floats, subnormals and the extremes."""
    from mmtrs_tpu_torch.utils.table import _parse

    rng = np.random.default_rng(16)
    vals = np.concatenate([rng.random(3000), rng.normal(0, 1e5, 1000), np.exp(rng.normal(0, 60, 2000)),
                           rng.integers(0, 10**6, 500) / 7])
    cells = [repr(float(v)) for v in vals] + [f"{v:.20g}" for v in vals[:500]] + [
        "-0.0", "1e+16", "5e-324", "1.7976931348623157e+308", "123456789012345678901234", " 2.5", "inf", "-inf"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(cells) + "\n"))["x"].to_numpy()
    got = _parse(cells)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert _parse(["0.42857142857142855"])[0] != 0.42857142857142855  # pandas' bit, not float()'s
    assert _parse(["1", "NA", "3"]).tolist()[::2] == [1.0, 3.0]
    assert _parse(["a", "nan", "b"]).tolist() == ["a", None, "b"]


def test_read_table_refuses_xlsx(tmp_path):
    from mmtrs_tpu_torch.utils.io import read_table

    (tmp_path / "t.xlsx").write_bytes(b"PK")
    with pytest.raises(ValueError, match="XLSX"):
        read_table(tmp_path / "t.xlsx")


# -- build_augmented_table ------------------------------------------------------------


@pytest.mark.parametrize("case", ["no_split", "split", "val_frac"])
def test_build_augmented_table_matches_jax(case, tmp_path):
    """The port's table equals the JAX DataFrame cell by cell and in column
    order, with no split column (grouped test split made), with one, and
    with a grouped val carved out of train (val_frac 0.2); write_table's
    CSV is byte-equal to pandas' to_csv of the JAX table, and reads back
    equal. Preset ``none``: every row's image is its original's."""
    from mmtrs_tpu.data.records import build_augmented_table as jax_build
    from mmtrs_tpu_torch.data.records import build_augmented_table
    from mmtrs_tpu_torch.utils.io import read_table, write_table

    df = _cohort(9, with_split=case != "no_split")
    imgs = np.random.default_rng(12).integers(0, 256, (9, 16, 16, 3)).astype(np.uint8)
    kw = dict(n_aug=3, preset="none", seed=42, test_frac=0.25, val_frac=0.2 if case == "val_frac" else 0.0,
              batch_size=4)
    jt, jimgs = jax_build(df, imgs, **kw)
    pt, pimgs = build_augmented_table(_table(df), imgs, device="cpu", **kw)
    _assert_same(pt, jt)
    np.testing.assert_array_equal(pimgs.numpy(), jimgs)
    written = write_table(pt, tmp_path / "aug.xlsx")
    assert written == [tmp_path / "aug.csv"]
    assert written[0].read_text() == _csv(jt)
    _assert_same(read_table(written[0]), pd.read_csv(written[0]))
    if case == "val_frac":
        assert "val" in set(pt["split"]) and "test" in set(pt["split"])


def test_build_augmented_table_ten_children_and_writer():
    """Preset ``ten``: the table equals ``none``'s; row i's image is
    augment_children's child for row i's (origin_id, aug_idx); the
    originals are unchanged (and the caller's array untouched); the writer
    sees every row once, in order."""
    from mmtrs_tpu_torch.data.records import augment_children, build_augmented_table
    from mmtrs_tpu_torch.synth import synth_teeth

    df = _cohort(4, with_split=True)
    imgs = synth_teeth(4, 64, seed=13)
    before = imgs.copy()
    seen = []
    t_ten, out = build_augmented_table(_table(df), imgs, n_aug=3, preset="ten", seed=7, batch_size=5,
                                       device="cpu", image_writer=lambda n, im: seen.append((n, im.clone())))
    t_none, _ = build_augmented_table(_table(df), imgs, n_aug=3, preset="none", seed=7, device="cpu")
    for c in t_none.columns:
        assert t_ten[c].tolist() == t_none[c].tolist(), c
    np.testing.assert_array_equal(imgs, before)
    np.testing.assert_array_equal(out[:4].numpy(), imgs)
    src = {o: i for i, o in enumerate(t_ten["origin_id"][:4])}
    for i in range(4, len(t_ten)):
        o, a = int(t_ten["origin_id"][i]), int(t_ten["aug_idx"][i])
        want = augment_children(torch.from_numpy(imgs), [(src[o], o, a)], preset="ten", seed=7, batch_size=5)[0]
        assert torch.equal(out[i], want), i
    assert [n for n, _ in seen] == t_ten["image_name"].tolist()
    assert all(torch.equal(im, out[i]) for i, (_, im) in enumerate(seen))


def test_build_augmented_table_needs_a_card_by_default():
    from mmtrs_tpu_torch.data.records import build_augmented_table

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_augmented_table(_table(_cohort(2, True)), np.zeros((2, 8, 8, 3), np.uint8), n_aug=1, preset="none")


# -- folds and metrics ----------------------------------------------------------------


def _group_cases():
    rng = np.random.default_rng(14)
    return {
        "eleven_per_group": np.repeat(np.arange(1, 31), 11),  # the rehearsal's 1 + 10 children
        "unequal": rng.integers(0, 17, 300),
        "ties": np.repeat(np.array([5, 3, 9, 1, 7, 2, 8]), [4, 4, 4, 2, 2, 3, 3])[rng.permutation(22)],
    }


@pytest.mark.parametrize("case", ["eleven_per_group", "unequal", "ties"])
def test_group_kfold_matches_sklearn(case):
    """Exactly the train and test indices of the JAX group_kfold
    (sklearn's GroupKFold), fold by fold."""
    from mmtrs_tpu.data.splits import group_kfold as jax_group_kfold
    from mmtrs_tpu_torch.data.splits import group_kfold

    groups = _group_cases()[case]
    want = list(jax_group_kfold(pd.DataFrame({"origin_id": groups}), 5))
    got = list(group_kfold(groups, 5))
    assert len(got) == len(want) == 5
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_roc_auc_and_threshold_sweep_match_jax():
    """roc_auc and sweep_thresholds equal the JAX package's to 1e-12 on
    scores with many ties, and on a grid that hits scores exactly."""
    from mmtrs_tpu.metrics import roc_auc as jax_auc
    from mmtrs_tpu.metrics.thresholds import sweep_thresholds as jax_sweep
    from mmtrs_tpu_torch.metrics.binary import roc_auc
    from mmtrs_tpu_torch.metrics.thresholds import sweep_thresholds

    rng = np.random.default_rng(15)
    y = (rng.random(400) < 0.4).astype(int)
    for p in (rng.random(400), np.round(rng.random(400), 1), np.full(400, 0.5)):
        assert abs(roc_auc(y, p) - jax_auc(y, p)) <= 1e-12
        grid = np.linspace(0.2, 0.8, 61)
        a, b = sweep_thresholds(y, p, grid), jax_sweep(y, p, grid)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12, err_msg=k)
    assert np.isnan(roc_auc(np.zeros(5), rng.random(5)))
