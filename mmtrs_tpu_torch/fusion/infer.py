"""Fusion inference: recipe loading + stream masking (the port's copy of
mmtrs_tpu/fusion/infer.py; src/fusion/fuse_infer.py:11-138 parity).

The "every stream optional, never crash" contract: streams that fail to
produce a probability are masked out of the recipe weights (weights are NOT
renormalized — matching the reference), and threshold priority is
override > global tuned > method-specific.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load_recipe(fusion_dir: str | Path) -> dict:
    """Load streams.json or fusion_summary.json into a uniform recipe."""
    fusion_dir = Path(fusion_dir)
    streams_p = fusion_dir / "streams.json"
    if streams_p.exists():
        data = json.loads(streams_p.read_text())
        if "streams_used" in data and "blend" in data and "stack" in data:
            return {
                "choice": data.get("choice", "blend"),
                "streams_used": data["streams_used"],
                "threshold": data.get("threshold", data["blend"].get("threshold")),
                "blend": {
                    "weights": data["blend"]["weights"],
                    "threshold": data["blend"].get("threshold", data.get("threshold", 0.5)),
                },
                "stack": {
                    "weights": data["stack"]["weights"],
                    "threshold": data["stack"].get("threshold", data.get("threshold", 0.5)),
                },
            }
        if "streams" in data:
            names = list(data["streams"].keys())
            weights = [float(data["streams"][k]) for k in names]
            thr = float(data.get("threshold", 0.5))
            rec = {"weights": weights, "threshold": thr}
            return {
                "choice": data.get("choice", "blend"),
                "streams_used": names,
                "threshold": thr,
                "blend": rec,
                "stack": rec,
            }
    meta_p = fusion_dir / "fusion_summary.json"
    if not meta_p.exists():
        raise FileNotFoundError(f"Fusion artifacts not found in {fusion_dir}")
    meta = json.loads(meta_p.read_text())
    return {
        "choice": meta["choice"],
        "streams_used": meta["streams_used"],
        "threshold": meta["threshold"],
        "blend": {"weights": meta["blend"]["weights"], "threshold": meta["blend"]["threshold"]},
        "stack": {"weights": meta["stack"]["weights"], "threshold": meta["stack"]["threshold"]},
    }


def fuse_streams(
    recipe: dict,
    streams: dict[str, float],
    override_threshold: float | None = None,
) -> dict:
    """Weighted fuse of whatever streams are present (fuse_infer.py:97-138)."""
    used = recipe["streams_used"]
    choice = recipe["choice"]
    present = [k for k in used if k in streams and streams[k] is not None]
    if not present:
        raise RuntimeError("No available streams for this case.")

    probs = np.array([streams[k] for k in present], dtype=float)
    method = recipe["blend"] if choice == "blend" else recipe["stack"]
    all_w = np.asarray(method["weights"], dtype=float)
    mask = [i for i, k in enumerate(used) if k in present]
    w = all_w[mask]
    p = float((probs * w).sum())
    thr_method = method["threshold"]

    t = (
        override_threshold
        if override_threshold is not None
        else (recipe.get("threshold") if recipe.get("threshold") is not None else thr_method)
    )
    y = 1 if p >= t else 0
    return {
        "p_indirect": p,
        "threshold": float(t),
        "label": "Indirect" if y == 1 else "Direct",
        "streams_used": present,
        "streams_raw": {k: float(streams[k]) for k in present},
        "weights_used": {k: float(wi) for k, wi in zip(present, w)},
        "components": {k: float(wi * pv) for k, wi, pv in zip(present, w, probs)},
        "choice": choice,
    }
