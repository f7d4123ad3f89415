"""Tracing and structured run logs (the port's counterparts of
mmtrs_tpu/utils/profiling.py):

- :func:`trace` — a ``torch.profiler`` trace of a code region (CPU and, where
  a card is visible, CUDA activity), written into ``logdir`` as a Chrome
  trace that Perfetto or ``chrome://tracing`` opens;
- :func:`annotate` — a named region inside a trace
  (``torch.profiler.record_function``);
- :class:`StructuredLogger` — append-only JSONL metrics log.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the enclosed region and write ``logdir/trace_<ns>.json``.

    Usage::

        with trace("logs/trace_preproc"):
            out = preprocess_batch(x)
            torch.cuda.synchronize()
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named sub-region annotation (shows up inside a :func:`trace`)."""
    import torch

    return torch.profiler.record_function(name)


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
