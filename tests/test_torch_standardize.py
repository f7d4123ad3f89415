"""The port's tabular standardiser (mmtrs_tpu_torch/data/standardize.py)
held against the JAX package's on string tables this file builds: every
rule of every field, unicode ≤/≥/dashes, "mm" spacing, blanks and NaN,
``strict`` on and off, the vote targets' 0/0 and ±inf, and ``add_split``.
Bars: each mapped value equal (a missing value on both sides), and the CSVs
the two write (pandas' ``to_csv`` and the port's ``to_csv``) byte for byte."""

import numpy as np
import pandas as pd
import pytest

from mmtrs_tpu_torch.utils.table import Table, to_csv

# every rule of every field, and values no rule maps
CASES = {
    "depth": ["> 4mm", ">4 mm", "greater than 4mm", "Greater = 4 mm", "≤ 4mm", "<=4mm", "< 4 mm", "le 4mm",
              "l 4mm", "5mm", "3.5 mm", "4.0mm", "6  MM", "deep", "", None, "  >  4MM  ", "≥4mm"],
    "width": ["all ≥ 1mm", "All >= 1 mm", "all 1mm", "some < 1mm", "Some <1 mm", "some <1mm", "> 1mm", ">=1 mm",
              "< 1 mm", "<= 1mm", "wide", "", None, "all <1mm", "some", "≥1mm"],
    "enamel_cracks": ["yes", "Y", "present", "Presence", "TRUE", "1", "no", "n", "absent", "Absence", "false", "0",
                      "maybe", "", None, " Yes "],
    "occlusal_load": ["yes", "no", "y", "n", "true", "false", "1", "0", "x", "", None, "PRESENT"],
    "carious_lesion": ["Low", "moderate", "Medium", "high", "HIGH risk", "low-moderate", "none", "", None, "mild"],
    "opposing_type": ["Natural tooth", "missing", "None", "FPD", "fixed partial denture", "implant", "natural implant",
                      "bridge", "", None, "Implant – FPD"],
    "adjacent_teeth": ["presence from one side", "one side", "Presence from both sides", "present", "absent", "",
                       None, "ONE SIDE only"],
    "age_range": ["< 20", "<20", "20-60", ">= 20", "20 - 60", "20–60", "≥ 20", "18-25", "20-70", "30-65", "10 - 15",
                  "&<20", "adult", "", None, "20—60"],
    "cervical_lesion": ["yes", "no", "", None, "2"],
}


def _raw_table(n: int, seed: int, fields=CASES) -> dict:
    """n rows: each field's cases in turn (shuffled), vote counts with 0/0,
    one-sided and ordinary rows."""
    rng = np.random.default_rng(seed)
    cols = {"image_name": [f"{i}.jpg" for i in range(n)]}
    for f, vals in fields.items():
        cols[f] = [vals[j] for j in rng.permutation(np.resize(np.arange(len(vals)), n))]
    direct = rng.integers(0, 5, n)
    indirect = rng.integers(0, 5, n)
    direct[:3], indirect[:3] = 0, 0  # 0/0 → 0
    direct[3], indirect[3] = 0, 4
    cols["Direct"], cols["Indirect"] = direct, indirect
    return cols


def _write_raw(path, cols):
    """The raw table as a CSV, so both packages read the same cells."""
    pd.DataFrame(cols).to_csv(path, index=False)
    return path


@pytest.mark.parametrize("field", sorted(CASES))
def test_every_mapper_matches_jax(field):
    from mmtrs_tpu.data import standardize as J
    from mmtrs_tpu_torch.data import standardize as P

    vals = CASES[field] + [float("nan"), np.nan, 1.0, 0, 5]
    for v in vals:
        want = J.FIELD_MAPPERS[field](v)
        got = P.FIELD_MAPPERS[field](v)
        assert (got is None and want is pd.NA) or got == want, (field, v, got, want)


def test_norm_matches_jax():
    from mmtrs_tpu.data.standardize import _norm as jn
    from mmtrs_tpu_torch.data.standardize import _norm as pn

    for v in [s for vals in CASES.values() for s in vals] + [None, float("nan"), 3, 2.5, "A\t\tB", "4MMmm"]:
        assert pn(v) == jn(v), v


@pytest.mark.parametrize("strict", [True, False])
def test_standardize_table_csv_matches_jax(tmp_path, strict):
    """standardize_table + add_split on a 64-row raw table read from CSV by
    each package; without strict, two fields are missing and skipped. The
    written CSVs are equal byte for byte, the field columns are nullable
    integers on both sides."""
    from mmtrs_tpu.data import standardize as J
    from mmtrs_tpu_torch.data import standardize as P
    from mmtrs_tpu_torch.utils.io import read_table

    cols = _raw_table(64, seed=3)
    if not strict:
        del cols["width"], cols["age_range"]
    src = _write_raw(tmp_path / "raw.csv", cols)
    want = J.add_split(J.standardize_table(pd.read_csv(src), strict=strict), test_count=13, seed=7)
    got = P.add_split(P.standardize_table(read_table(src), strict=strict), test_count=13, seed=7)
    assert got.columns == list(want.columns)
    for c in P.FIELD_MAPPERS:
        if c in want:
            assert str(want[c].dtype) == "Int64" and isinstance(got[c], np.ma.MaskedArray)
            assert np.array_equal(np.ma.getmaskarray(got[c]), want[c].isna().to_numpy())
            assert got[c].filled(-9).tolist() == want[c].fillna(-9).astype(int).tolist()
    want.to_csv(tmp_path / "jax.csv", index=False)
    to_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_strict_raises_on_a_missing_field():
    from mmtrs_tpu.data import standardize as J
    from mmtrs_tpu_torch.data import standardize as P

    cols = _raw_table(8, seed=1)
    del cols["depth"]
    with pytest.raises(KeyError, match="depth"):
        J.standardize_table(pd.DataFrame(cols))
    with pytest.raises(KeyError, match="depth"):
        P.standardize_table(Table(cols))


@pytest.mark.parametrize("votes", ["ints", "text", "floats"])
def test_compute_targets_matches_jax(tmp_path, votes):
    """p_indirect, y_majority and weight from vote columns read as ints,
    as text with blanks and words (coerced, missing → 0) and as floats with
    NaN and a negative count (±inf → NaN → 0, clipped to [0, 1])."""
    from mmtrs_tpu.data import standardize as J
    from mmtrs_tpu_torch.data import standardize as P
    from mmtrs_tpu_torch.utils.io import read_table

    d = {"ints": ([0, 0, 3, 1, 2, 5], [0, 4, 0, 1, 7, 5]),
         "text": (["0", "", "x", "3", "2", "1"], ["0", "2", "1", "", "7", "abc"]),
         "floats": ([0.0, np.nan, 2.5, 1.0, -1.0, 3.0], [0.0, 2.0, 0.5, np.nan, 1.0, 0.0])}[votes]
    src = _write_raw(tmp_path / "v.csv", {"Direct": d[0], "Indirect": d[1]})
    want = J.compute_targets(pd.read_csv(src))
    got = P.compute_targets(read_table(src))
    for c in ("Direct", "Indirect", "p_indirect", "y_majority", "weight"):
        np.testing.assert_array_equal(np.ma.getdata(got[c]), want[c].to_numpy(dtype=float), err_msg=c)
    want.to_csv(tmp_path / "jax.csv", index=False)
    to_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("n,count,seed", [(10, 3, 0), (50, 80, 42), (200, 80, 9)])
def test_add_split_matches_jax(n, count, seed):
    from mmtrs_tpu.data import standardize as J
    from mmtrs_tpu_torch.data import standardize as P

    want = J.add_split(pd.DataFrame({"a": np.arange(n)}), test_count=count, seed=seed)
    got = P.add_split(Table({"a": np.arange(n)}), test_count=count, seed=seed)
    assert got["split"].tolist() == want["split"].tolist()
