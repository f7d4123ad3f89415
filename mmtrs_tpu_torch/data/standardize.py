"""Tabular standardisation: raw clinician strings → numeric encodings and
targets (port of mmtrs_tpu/data/standardize.py on the port's ``Table``).

- mappers: depth (≤4mm→0, >4mm→1), width (<1mm→0, ≥1mm→1), yes/no fields,
  carious_lesion (low→-1 / moderate→0 / high→1), opposing_type
  (natural→0 / missing→1 / FPD→2 / implant→3), adjacent_teeth (one side→0 /
  both→1), age_range (<20→0, ≥20→1), each an ordered list of rules on a
  normalised string; a value no rule maps is missing (None);
- ``compute_targets``: p_indirect = Indirect / (Direct + Indirect) (0/0 and
  ±inf become 0), y_majority = p_indirect ≥ 0.5, weight = |2p − 1|;
- ``add_split``: exactly ``test_count`` random test rows, numpy
  ``default_rng(seed).choice``.

A mapped column is a nullable integer column (``utils.table.int_na``, the
JAX package's pandas ``Int64``): a missing value is written to CSV as the
empty cell pandas writes for ``pd.NA``.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import numpy as np

from mmtrs_tpu_torch.data.features import to_numeric
from mmtrs_tpu_torch.utils.table import Table, int_na

Rule = tuple[Callable[[str], bool], int]


def _isna(s) -> bool:
    return s is None or (isinstance(s, (float, np.floating)) and math.isnan(s))


def _norm(s) -> str:
    if _isna(s):
        return ""
    s = str(s).strip().lower()
    s = re.sub(r"\s+", " ", s)
    s = (
        s.replace("≤", "<=")
        .replace("≥", ">=")
        .replace("–", "-")
        .replace("—", "-")
        .replace("mm", " mm")
    )
    return re.sub(r"\s+", " ", s)


def _contains(*subs: str) -> Callable[[str], bool]:
    return lambda s: any(sub in s for sub in subs)


def _in_set(*vals: str) -> Callable[[str], bool]:
    vs = set(vals)
    return lambda s: s in vs


def _depth_numeric(s: str):
    m = re.search(r"(\d+(?:\.\d+)?)\s*mm", s)
    if m:
        try:
            return 1 if float(m.group(1)) > 4.0 else 0
        except ValueError:
            return None
    return None


def map_depth(val):
    s = _norm(val)
    if not s:
        return None
    if re.search(r"(>|\bgreater)\s*=?\s*4\s*mm", s):
        return 1
    if re.search(r"(<=|<|≤|\ble?\b)\s*=?\s*4\s*mm", s):
        return 0
    return _depth_numeric(s)


def map_width(val):
    s = _norm(val)
    if not s:
        return None
    if "all" in s and ("1 mm" in s or ">= 1 mm" in s or ">=1 mm" in s):
        return 1
    if "some" in s and ("< 1 mm" in s or "<1 mm" in s or "<1mm" in s):
        return 0
    if re.search(r"(>=|>)\s*1\s*mm", s):
        return 1
    if re.search(r"(<|<=)\s*1\s*mm", s):
        return 0
    return None


_YES = _in_set("yes", "y", "present", "presence", "true", "1")
_NO = _in_set("no", "n", "absent", "absence", "false", "0")


def map_yes_no(val):
    s = _norm(val)
    if not s:
        return None
    if _YES(s):
        return 1
    if _NO(s):
        return 0
    return None


_ORDERED_RULES: dict[str, list[Rule]] = {
    "carious_lesion": [
        (_contains("low"), -1),
        (_contains("moderate", "medium"), 0),
        (_contains("high"), 1),
    ],
    "opposing_type": [
        (_contains("natural"), 0),
        (_contains("missing", "none"), 1),
        (_contains("fpd", "fixed partial denture"), 2),
        (_contains("implant"), 3),
    ],
    "adjacent_teeth": [
        (_contains("presence from one side", "one side"), 0),
        (_contains("presence", "present"), 1),
    ],
}


def _map_rules(field: str, val):
    s = _norm(val)
    if not s:
        return None
    for pred, enc in _ORDERED_RULES[field]:
        if pred(s):
            return enc
    return None


def map_carious_lesion(val):
    return _map_rules("carious_lesion", val)


def map_opposing_type(val):
    return _map_rules("opposing_type", val)


def map_adjacent_teeth(val):
    return _map_rules("adjacent_teeth", val)


def map_age_range(val):
    s = _norm(val).replace("&", "")
    if not s:
        return None
    if "< 20" in s or "<20" in s:
        return 0
    if "20-60" in s or ">= 20" in s or "20 - 60" in s:
        return 1
    m = re.search(r"(\d+)\s*-\s*(\d+)", s)
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        return 1 if lo >= 20 and hi >= 60 else 0
    return None


FIELD_MAPPERS: dict[str, Callable] = {
    "depth": map_depth,
    "width": map_width,
    "enamel_cracks": map_yes_no,
    "occlusal_load": map_yes_no,
    "carious_lesion": map_carious_lesion,
    "opposing_type": map_opposing_type,
    "adjacent_teeth": map_adjacent_teeth,
    "age_range": map_age_range,
    "cervical_lesion": map_yes_no,
}


def _is_int_text(v) -> bool:
    try:
        int(str(v).strip())
        return True
    except ValueError:
        return False


def _to_numeric(col: np.ndarray) -> np.ndarray:
    """pandas' ``to_numeric(errors="coerce").fillna(0)`` on a column: int64
    where every cell is an integer (integer or boolean columns, text of
    integers), else float64 with what does not parse as 0."""
    col = col.filled(0) if isinstance(col, np.ma.MaskedArray) else col
    if col.dtype.kind in "biu" or (col.dtype.kind == "O" and all(_is_int_text(v) for v in col.tolist())):
        return np.array([int(str(v).strip()) if col.dtype.kind == "O" else int(v) for v in col.tolist()],
                        dtype=np.int64)
    f = to_numeric(col)
    return np.where(np.isnan(f), 0.0, f)


def compute_targets(table: Table) -> Table:
    """p_indirect / y_majority / weight from the expert vote counts
    ``Direct`` and ``Indirect`` (both made numeric, missing → 0)."""
    df = table.copy()
    for c in ("Direct", "Indirect"):
        if c not in df:
            raise KeyError(f"Missing required column: '{c}'")
    direct, indirect = _to_numeric(df["Direct"]), _to_numeric(df["Indirect"])
    total = direct + indirect
    with np.errstate(divide="ignore", invalid="ignore"):
        p = indirect / total
    p = np.clip(np.where(np.isfinite(p), p, 0.0), 0.0, 1.0).astype(np.float64)
    df["Direct"], df["Indirect"] = direct, indirect
    df["p_indirect"] = p
    df["y_majority"] = int_na((p >= 0.5).astype(np.int64))
    df["weight"] = np.abs(p * 2 - 1)
    return df


def standardize_table(table: Table, strict: bool = True) -> Table:
    """Map every categorical field to its nullable integer code and compute
    the targets; ``strict``: a missing field raises ``KeyError``, else it is
    skipped."""
    df = table.copy()
    for col, fn in FIELD_MAPPERS.items():
        if col not in df:
            if strict:
                raise KeyError(f"Missing required column: '{col}'")
            continue
        df[col] = int_na([fn(v) for v in df[col].tolist()])
    return compute_targets(df)


def add_split(table: Table, test_count: int = 80, seed: int = 42) -> Table:
    """Exactly ``min(test_count, n)`` random test rows, the rest train."""
    df = table.copy()
    n = len(df)
    k = min(test_count, n)
    rng = np.random.default_rng(seed)
    test_idx = rng.choice(n, size=k, replace=False)
    split = np.array(["train"] * n, dtype=object)
    split[test_idx] = "test"
    df["split"] = split
    return df
