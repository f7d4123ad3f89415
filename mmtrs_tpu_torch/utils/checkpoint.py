"""Checkpoints the port can read without JAX: ``<base>.npz`` beside the
``<base>.recipe.json`` sidecar of the JAX package's checkpoints
(mmtrs_tpu/utils/checkpoint.py).

The npz holds the ``params/…`` and ``batch_stats/…`` leaves of a Flax
variables tree under ``/``-joined keys. scripts/export_npz_checkpoints.py
writes one beside every Orbax checkpoint of a weights folder (that runs
where JAX is); models/convert.py turns the tree into a port state dict and
back.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

COLLECTIONS = ("params", "batch_stats")


def _npz_path(base: str | Path) -> Path:
    return Path(str(base) + ".npz")


def _recipe_path(base: str | Path) -> Path:
    return Path(str(base) + ".recipe.json")


def _flatten(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def save_npz_checkpoint(base: str | Path, tree: dict, recipe: dict | None = None) -> Path:
    """Write ``tree``'s params and batch_stats to ``<base>.npz`` (and
    ``recipe``, when given, to ``<base>.recipe.json``)."""
    path = _npz_path(base)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = {}
    for coll in COLLECTIONS:
        leaves.update(_flatten(tree.get(coll, {}), coll + "/"))
    np.savez(path, **leaves)
    if recipe is not None:
        _recipe_path(base).write_text(json.dumps(recipe, indent=2))
    return path


def load_npz_checkpoint(base: str | Path) -> tuple[dict, dict | None]:
    """``<base>.npz`` → ({"params": …, "batch_stats": …} of numpy arrays,
    the recipe or None). A missing npz raises."""
    path = _npz_path(base)
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found: export the Orbax checkpoint with scripts/export_npz_checkpoints.py"
        )
    tree: dict = {coll: {} for coll in COLLECTIONS}
    with np.load(path) as z:
        for key in z.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    rp = _recipe_path(base)
    recipe = json.loads(rp.read_text()) if rp.exists() else None
    return tree, recipe
