"""Artifact IO helpers (the port's copy of ``ensure_dir``, ``timestamp`` and
``save_json`` from mmtrs_tpu/utils/io.py, with its numpy-aware JSON
encoder). The pandas table readers are not copied: nothing ported reads a
table yet.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

import numpy as np


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
