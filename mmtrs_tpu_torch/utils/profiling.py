"""Structured run logs (the port's copy of ``StructuredLogger`` in
mmtrs_tpu/utils/profiling.py)."""

from __future__ import annotations

import json
import time
from pathlib import Path


class StructuredLogger:
    """Append-only JSONL metrics log.

    Each call to :meth:`log` writes one line:
    ``{"ts": <unix>, "event": <name>, ...fields}``. Safe to tail while a
    run is in flight; ``read()`` parses the full log back.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event}
        for k, v in fields.items():
            try:
                json.dumps(v)
                rec[k] = v
            except TypeError:
                rec[k] = str(v)
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [
            json.loads(line)
            for line in self.path.read_text().splitlines()
            if line.strip()
        ]
