"""Artifact IO helpers (the port's copy of ``ensure_dir``, ``timestamp``,
``save_json``, ``load_json``, ``copy_with_new_name``, ``read_table`` and
``write_table`` from mmtrs_tpu/utils/io.py, with its numpy-aware JSON
encoder).

Tables are the port's pandas-free :class:`~mmtrs_tpu_torch.utils.table.Table`
and go through the ``csv`` module. XLSX is neither read nor written: the
JAX package's ``write_table`` also writes an ``.xlsx`` beside the CSV where
openpyxl exists; the port writes the CSV only.
"""

from __future__ import annotations

import json
import shutil
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

import numpy as np

from mmtrs_tpu_torch.utils.table import Table, from_csv, to_csv


def ensure_dir(path: str | Path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def timestamp() -> str:
    """UTC ISO timestamp, filesystem-safe (reference: src/utils/io.py:15-17)."""
    return datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")


class _NumpyEncoder(json.JSONEncoder):
    def default(self, o: Any) -> Any:
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, Path):
            return str(o)
        return super().default(o)


def save_json(obj: Any, path: str | Path, indent: int = 2) -> Path:
    p = Path(path)
    ensure_dir(p.parent)
    with open(p, "w") as f:
        json.dump(obj, f, indent=indent, cls=_NumpyEncoder)
    return p


def load_json(path: str | Path) -> Any:
    with open(path) as f:
        return json.load(f)


def copy_with_new_name(src: str | Path, dst_dir: str | Path, new_name: str) -> Path:
    dst = ensure_dir(dst_dir) / new_name
    shutil.copy2(src, dst)
    return dst


def read_table(path: str | Path) -> Table:
    """Read a metadata table from .csv (reference: augment_records.py:45-52).
    An .xlsx or .xls table raises: re-export it as CSV."""
    p = Path(path)
    if p.suffix.lower() in (".xlsx", ".xls"):
        raise ValueError(f"{p}: XLSX tables are not read by the port; re-export the table as CSV")
    return from_csv(p)


def write_table(table: Table, path: str | Path) -> list[Path]:
    """Write ``table`` as ``<path stem>.csv``, byte for byte what pandas'
    ``to_csv(index=False)`` writes (CSV only: no .xlsx beside it)."""
    return [to_csv(table, Path(path).with_suffix(".csv"))]
