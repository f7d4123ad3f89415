"""Group-aware folds (the port's ``group_kfold`` of
mmtrs_tpu/data/splits.py, without sklearn).

The JAX package calls sklearn's ``GroupKFold(n_splits).split``. The card's
machine has no sklearn, so this is that splitter's algorithm written out as
scikit-learn 1.9.0 has it (``GroupKFold._iter_test_indices`` without
shuffling): groups by ``np.unique(..., return_inverse=True)``, their sizes by
``bincount``, the groups taken largest first by a stable argsort reversed,
each into the fold with the fewest rows so far (the first such fold on a
tie). Older releases sorted the sizes with numpy's default (unstable)
argsort, so there groups of equal size may land in other folds.
"""

from __future__ import annotations

import numpy as np


def group_kfold(groups, n_folds: int = 5):
    """Yield (train_idx, test_idx) per fold for the rows' ``groups`` (e.g. a
    table's ``origin_id`` column), in sklearn's order."""
    groups = np.asarray(groups)
    unique, inverse = np.unique(groups, return_inverse=True)
    if n_folds > len(unique):
        raise ValueError(
            f"Cannot have number of splits n_splits={n_folds} greater than the number of groups: {len(unique)}."
        )
    sizes = np.bincount(inverse)
    order = np.argsort(sizes, kind="stable")[::-1]
    fold_rows = np.zeros(n_folds)
    group_fold = np.zeros(len(unique), dtype=np.int64)
    for g in order:
        f = int(np.argmin(fold_rows))
        fold_rows[f] += sizes[g]
        group_fold[g] = f
    row_fold = group_fold[inverse]
    idx = np.arange(len(groups))
    for f in range(n_folds):
        yield idx[row_fold != f], idx[row_fold == f]
