"""Folds and splits (the port's ``group_kfold`` and ``stratified_kfold`` of
mmtrs_tpu/data/splits.py, and the one ``StratifiedShuffleSplit`` draw of
mmtrs_tpu/train/tabular.py, without sklearn).

The JAX package calls sklearn's ``GroupKFold(n_splits).split``. The card's
machine has no sklearn, so this is that splitter's algorithm written out as
scikit-learn 1.9.0 has it (``GroupKFold._iter_test_indices`` without
shuffling): groups by ``np.unique(..., return_inverse=True)``, their sizes by
``bincount``, the groups taken largest first by a stable argsort reversed,
each into the fold with the fewest rows so far (the first such fold on a
tie). Older releases sorted the sizes with numpy's default (unstable)
argsort, so there groups of equal size may land in other folds.

``stratified_kfold`` and ``stratified_shuffle_split`` are scikit-learn
1.9.0's ``StratifiedKFold(shuffle=True)._make_test_folds`` and
``StratifiedShuffleSplit._iter_indices`` (with ``_approximate_mode``) on the
same ``RandomState`` calls, so a seed gives sklearn's indices.
"""

from __future__ import annotations

from math import ceil

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


def stratified_kfold(y, n_folds: int = 5, seed: int = 42, shuffle: bool = True):
    """Yield (train_idx, test_idx) per fold, as sklearn's
    ``StratifiedKFold(n_folds, shuffle, random_state=seed)`` on labels ``y``."""
    rng = np.random.RandomState(seed if shuffle else None)
    y = np.asarray(y).astype(int)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]  # classes in order of first appearance
    n_classes = len(y_idx)
    if np.all(n_folds > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_folds} cannot be greater than the number of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_folds], minlength=n_classes) for i in range(n_folds)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_folds).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    idx = np.arange(len(y))
    for f in range(n_folds):
        yield idx[test_folds != f], idx[test_folds == f]


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn.utils.extmath._approximate_mode: the floored proportional
    counts, topped up by largest remainder, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_shuffle_split(y, test_size: float = 0.2, seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) of ``next(StratifiedShuffleSplit(1,
    test_size=test_size, random_state=seed).split(X, y))``."""
    y = np.asarray(y)
    n = len(y)
    n_test = ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train {n_train} and test {n_test} rows must each hold the {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
