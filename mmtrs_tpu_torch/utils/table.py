"""A small column table, the port's stand-in for the pandas DataFrames of
the JAX package's lineage tables and trainer outputs (the card's machine
may have no pandas).

A :class:`Table` is ordered columns of equal-length 1-d numpy arrays:
integers int64, floats float64 (or float32), booleans bool, text as
object arrays of ``str`` (never numpy's fixed-width strings, which cut
longer values on assignment), and nullable integers (pandas' ``Int64``) as
int64 masked arrays (:func:`int_na`). Rows are taken with an index or a boolean
mask. :func:`to_csv` writes what pandas' ``to_csv(index=False)`` writes for
such columns, and :func:`from_csv` reads what pandas' ``read_csv`` reads from the same
cells: each column's type as pandas infers it, its default missing-value
words as missing, and each float as pandas' default parser
(``precise_xstrtod``) rounds it, which keeps 17 significant digits counting
a leading zero and may miss the last bit of a shortest repr (``_xstrtod``).
"""

from __future__ import annotations

import csv
import io
import math
from pathlib import Path

import numpy as np


def int_na(values) -> np.ma.MaskedArray:
    """A nullable integer column, pandas' ``Int64``: ints, and None (or
    NaN) where a value is missing → int64 masked where missing. A missing
    cell is written to CSV as the empty cell pandas writes for ``pd.NA``."""
    vals = list(values)
    miss = np.array([v is None or (isinstance(v, float) and math.isnan(v)) for v in vals], dtype=bool)
    data = np.array([0 if m else int(v) for v, m in zip(vals, miss)], dtype=np.int64)
    return np.ma.MaskedArray(data, mask=miss)


def _column(values, n: int | None = None) -> np.ndarray:
    if isinstance(values, np.ma.MaskedArray):
        if values.dtype.kind not in "iu" or np.ndim(values) != 1:
            raise ValueError("a masked column must be 1-d integers (a nullable Int64 column)")
        return np.ma.MaskedArray(values.data.astype(np.int64), mask=np.ma.getmaskarray(values).copy())
    if isinstance(values, (str, bytes)) or np.ndim(values) == 0:
        if n is None:
            raise ValueError("a scalar column needs a table with rows")
        values = [values] * n
    a = np.asarray(values)
    if a.ndim != 1:
        raise ValueError(f"a column must be 1-d, got shape {a.shape}")
    if a.dtype.kind in "USO":
        out = np.empty(len(a), dtype=object)
        out[:] = [v if v is None else str(v) for v in a.tolist()]
        return out
    return a.copy()


class Table:
    """Ordered, equal-length numpy columns."""

    def __init__(self, columns: dict | None = None):
        self._cols: dict[str, np.ndarray] = {}
        for k, v in (columns or {}).items():
            self[k] = v

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name: str, values) -> None:
        """Set a column from a sequence of this table's length, or from one
        value for every row."""
        col = _column(values, len(self) if self._cols else None)
        if self._cols and len(col) != len(self):
            raise ValueError(f"column {name!r} has {len(col)} rows, the table {len(self)}")
        self._cols[name] = col

    def take(self, rows) -> "Table":
        """The rows at an integer index or a boolean mask, in that order."""
        rows = np.asarray(rows)
        if rows.dtype != bool:
            rows = rows.astype(np.int64)
        return Table({k: v[rows] for k, v in self._cols.items()})

    def select(self, names) -> "Table":
        """The columns ``names``, in that order."""
        return Table({k: self._cols[k] for k in names})

    def copy(self) -> "Table":
        return Table(self._cols)

    @staticmethod
    def concat(tables: list["Table"]) -> "Table":
        """Rows of every table in turn; all have the first one's columns."""
        names = tables[0].columns
        for t in tables[1:]:
            if t.columns != names:
                raise ValueError(f"columns differ: {names} vs {t.columns}")
        cat = lambda cols: (np.ma.concatenate(cols) if any(isinstance(c, np.ma.MaskedArray) for c in cols)
                            else np.concatenate(cols))
        return Table({k: cat([t[k] for t in tables]) for k in names})


def join_key(v):
    """A join key as pandas compares it: numbers as floats (1 matches 1.0)."""
    return float(v) if isinstance(v, (int, float, np.integer, np.floating, np.bool_)) else v


def drop_duplicates(table: Table) -> Table:
    """pandas ``drop_duplicates()``: the first row of each distinct row, in
    order."""
    seen, keep = set(), []
    for i, row in enumerate(zip(*(table[c].tolist() for c in table.columns))):
        k = tuple(join_key(v) for v in row)
        if k not in seen:
            seen.add(k)
            keep.append(i)
    return table.take(np.asarray(keep, dtype=np.int64))


def merge_left(left: Table, right: Table, on: str) -> Table:
    """pandas ``left.merge(right, on=on, how="left")``: each left row in
    turn with each of its matches in right's order (a key that repeats in
    right repeats the left row), or once with right's columns missing (NaN
    for numbers, which makes an integer column float64; None for text);
    the key column is left's."""
    matches: dict = {}
    for j, v in enumerate(right[on].tolist()):
        matches.setdefault(join_key(v), []).append(j)
    li, ri = [], []
    for i, v in enumerate(left[on].tolist()):
        for j in matches.get(join_key(v), [-1]):
            li.append(i)
            ri.append(j)
    out = left.take(np.asarray(li, dtype=np.int64))
    ri = np.asarray(ri, dtype=np.int64)
    miss = ri < 0
    for c in right.columns:
        if c == on:
            continue
        col = np.ma.getdata(right[c])[np.where(miss, 0, ri)] if len(right) else np.empty(len(ri), right[c].dtype)
        if miss.any():
            if col.dtype.kind in "biuf":
                col = col.astype(np.float64)
                col[miss] = np.nan
            else:
                col = col.astype(object)
                col[miss] = None
        out[c] = col
    return out


def _cell(v, kind: str) -> str:
    if kind == "f":
        return "" if np.isnan(v) else str(v)  # numpy's shortest repr, pandas' float text
    if kind == "O":
        return "" if v is None else str(v)
    return str(v)


def to_csv(table: Table, path: str | Path) -> Path:
    """Write ``table`` as pandas' ``to_csv(index=False)`` writes it: the
    csv module's minimal quoting, "\\n" line ends, floats as numpy's
    shortest repr of their own type (``1.0``, ``1e-05``), NaN, None and a
    nullable integer's missing cells as empty cells."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(table.columns)
    cols = [(np.ma.getdata(table[k]), table[k].dtype.kind, np.ma.getmaskarray(table[k])) for k in table.columns]
    for i in range(len(table)):
        w.writerow(["" if miss[i] else _cell(c[i], kind) for c, kind, miss in cols])
    path.write_text(buf.getvalue())
    return path


# pandas' default na_values
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>",
       "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_INF = {"inf", "+inf", "-inf", "infinity", "+infinity", "-infinity"}
_POW10 = [float(f"1e{k}") for k in range(309)]


def _xstrtod(s: str) -> float:
    """pandas' ``precise_xstrtod`` (its default float parser): up to 17
    digits, the leading ones included, accumulated as ``n·10 + d`` in
    double, the rest dropped, then one multiply or divide by a power of
    ten."""
    if s.strip().lower() in _INF:
        return float(s)
    p, n = 0, len(s)
    while p < n and s[p] in " \t":
        p += 1
    neg = p < n and s[p] == "-"
    p += p < n and s[p] in "+-"
    number, exponent, digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        decimals = 0
        while digits < 17 and p < n and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and s[p].isdigit():
            p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(s)
    number = -number if neg else number
    if p < n and s[p] in "eE":
        p += 1
        eneg = p < n and s[p] == "-"
        p += p < n and s[p] in "+-"
        if not (p < n and s[p].isdigit()):
            raise ValueError(s)
        e = 0
        while p < n and s[p].isdigit():
            e = e * 10 + ord(s[p]) - 48
            p += 1
        exponent += -e if eneg else e
    while p < n and s[p] in " \t":
        p += 1
    if p != n:
        raise ValueError(s)
    if exponent > 308:
        return math.copysign(math.inf, number) if number else number
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse(cells: list[str]) -> np.ndarray:
    """A column's cells → bool, int64, float64 (missing cells NaN) or str
    (missing cells None), the first of these that holds every cell, as
    pandas' ``read_csv`` infers."""
    filled = [c for c in cells if c not in _NA]
    if filled and len(filled) == len(cells) and all(c in _TRUE | _FALSE for c in cells):
        return np.array([c in _TRUE for c in cells])
    if len(filled) == len(cells):
        try:
            return np.array([int(c) for c in cells], dtype=np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        return np.array([np.nan if c in _NA else _xstrtod(c) for c in cells], dtype=np.float64)
    except ValueError:
        return _column([None if c in _NA else c for c in cells])


def from_csv(path: str | Path) -> Table:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty file")
    header, body = rows[0], rows[1:]
    return Table({name: _parse([r[j] for r in body]) for j, name in enumerate(header)})
