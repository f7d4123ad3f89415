#!/usr/bin/env python3
"""Export a weights folder's Orbax checkpoints to npz for the PyTorch port.

The JAX package saves MM and MIL folds as Orbax checkpoint directories with
a ``<base>.recipe.json`` sidecar (mmtrs_tpu/utils/checkpoint.py). The port
imports no JAX, so it reads ``<base>.npz`` instead
(mmtrs_tpu_torch/utils/checkpoint.py). This script walks a folder and
writes that npz beside every Orbax checkpoint that has a recipe, holding
only the ``params`` and ``batch_stats`` collections (a restore without a
target may also hold the optimiser state and the step). GBDT forests are
already npz + json and are left as they are.

Usage (where JAX and Orbax are installed; the npz files then travel with
the folder to the machine with the card):
  python scripts/export_npz_checkpoints.py weights/
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def export_folder(folder: str | Path) -> list[Path]:
    """Write ``<base>.npz`` for every ``<base>.recipe.json`` under ``folder``
    whose ``<base>`` is an Orbax checkpoint directory; returns the paths."""
    import jax
    import numpy as np

    from mmtrs_tpu.utils.checkpoint import load_checkpoint
    from mmtrs_tpu_torch.utils.checkpoint import COLLECTIONS, save_npz_checkpoint

    written = []
    for rp in sorted(Path(folder).rglob("*.recipe.json")):
        base = Path(str(rp)[: -len(".recipe.json")])
        if not base.is_dir():
            continue
        state, _ = load_checkpoint(base)
        tree = {c: jax.tree.map(np.asarray, state[c]) for c in COLLECTIONS if c in state}
        written.append(save_npz_checkpoint(base, tree))
    return written


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("folder", help="weights folder (searched recursively)")
    args = ap.parse_args(argv)
    for path in export_folder(args.folder):
        print(path)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
