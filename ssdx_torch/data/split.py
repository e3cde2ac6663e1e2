"""Stratified group train/test splitting.

Replaces the reference's ``make_train_test_split`` (CarImageClass.py:402-450):
StratifiedGroupKFold over annotation *rows*, stratified by class, grouped by
filename, ``n_splits = floor(1/test_size)``, first fold taken; the two splits
are materialized as new datasets restricted to per-split file lists.

The port's own copy of ``ssdx/data/split.py``, with the fold assignment of
scikit-learn's ``StratifiedGroupKFold(n_splits, shuffle=True,
random_state=seed)`` (version 1.9, ``_iter_test_indices`` and
``_find_best_fold``) written out in numpy, so that the split is the JAX
package's, file for file, on a machine without scikit-learn:

  * the per-group class counts, their rows shuffled by
    ``np.random.RandomState(seed)`` (group ids are remapped with them);
  * groups taken in a stable order of decreasing std of their counts;
  * each group goes to the fold that minimises the mean over classes of the
    fold-wise std of ``counts / class_total``; ties (``np.isclose``) go to
    the fold with fewer rows, then to the first.
"""
from __future__ import annotations

import warnings

import numpy as np

from .dataset import SEED, DetectionDataset

__all__ = ["stratified_group_kfold_test_mask", "stratified_group_split",
           "make_train_test_split"]


def _target_type(y: np.ndarray) -> str:
    """scikit-learn's ``type_of_target`` for a 1-D target."""
    if y.dtype == object and len(y) and not isinstance(y[0], str):
        return "unknown"
    if y.dtype.kind == "f" and np.any(y != y.astype(int)):
        return "continuous"
    return "multiclass" if len(np.unique(y)) > 2 else "binary"


def _best_fold(counts_per_fold: np.ndarray, y_cnt: np.ndarray, group_counts: np.ndarray) -> int:
    best, min_eval, min_samples = None, np.inf, np.inf
    for i in range(counts_per_fold.shape[0]):
        counts_per_fold[i] += group_counts
        std_per_class = np.std(counts_per_fold / y_cnt.reshape(1, -1), axis=0)
        counts_per_fold[i] -= group_counts
        fold_eval = np.mean(std_per_class)
        samples = np.sum(counts_per_fold[i])
        if fold_eval < min_eval or (np.isclose(fold_eval, min_eval) and samples < min_samples):
            best, min_eval, min_samples = i, fold_eval, samples
    return best


def stratified_group_kfold_test_mask(y, groups, n_splits: int, seed: int | None) -> np.ndarray:
    """Bool mask of the rows in the first test fold of
    ``StratifiedGroupKFold(n_splits, shuffle=True, random_state=seed)``,
    with the same errors and warning."""
    if n_splits <= 1:
        raise ValueError("k-fold cross-validation requires at least one train/test split by "
                         f"setting n_splits=2 or more, got n_splits={n_splits}.")
    y, groups = np.asarray(y).reshape(-1), np.asarray(groups)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the "
                         f"number of samples: n_samples={len(y)}.")
    kind = _target_type(y)
    if kind not in ("binary", "multiclass"):
        raise ValueError(f"Supported target types are: {('binary', 'multiclass')}. "
                         f"Got {kind!r} instead.")
    _, y_inv, y_cnt = np.unique(y, return_inverse=True, return_counts=True)
    if np.all(n_splits > y_cnt):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class.")
    if n_splits > np.min(y_cnt):
        warnings.warn(f"The least populated class in y has only {np.min(y_cnt)} members, "
                      f"which is less than n_splits={n_splits}.", UserWarning)
    _, groups_inv, groups_cnt = np.unique(groups, return_inverse=True, return_counts=True)
    n_groups = len(groups_cnt)
    if n_splits > n_groups:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the "
                         f"number of groups: {n_groups}.")
    counts_per_group = np.zeros((n_groups, len(y_cnt)))
    np.add.at(counts_per_group, (groups_inv, y_inv), 1)
    rng = np.random.mtrand._rand if seed is None else np.random.RandomState(seed)
    perm = np.arange(n_groups)
    rng.shuffle(perm)
    counts_per_group = counts_per_group[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_groups)
    groups_inv = inv_perm[groups_inv]

    counts_per_fold = np.zeros((n_splits, len(y_cnt)))
    in_first = np.zeros(n_groups, bool)
    for g in np.argsort(-np.std(counts_per_group, axis=1), kind="stable"):
        fold = _best_fold(counts_per_fold, y_cnt, counts_per_group[g])
        counts_per_fold[fold] += counts_per_group[g]
        in_first[g] = fold == 0
    return in_first[groups_inv]


def stratified_group_split(
    df,
    test_size: float = 0.25,
    rand_state: int | None = SEED,
) -> tuple[list[str], list[str]]:
    """Return (train_files, test_files) from an annotation dataframe with
    'filename' and 'class' columns."""
    if not (0.0 < test_size < 1.0):
        raise ValueError(
            f"Test size should be a number between 0 and 1, received {test_size}."
        )
    n_splits = int(np.floor(1.0 / test_size))
    test = stratified_group_kfold_test_mask(df["class"], df["filename"], n_splits, rand_state)
    train_files = df["filename"][~test].drop_duplicates().to_list()
    test_files = df["filename"][test].drop_duplicates().to_list()
    # invariant checked by the reference's preprocess notebook: no group leak
    assert not (set(train_files) & set(test_files))
    return train_files, test_files


def make_train_test_split(
    full_set: DetectionDataset,
    test_size: float = 0.25,
    rand_state: int | None = SEED,
    transform_train=None,
    transform_test=None,
    include_area: bool = False,
) -> tuple[DetectionDataset, DetectionDataset]:
    """Split a dataset into (train, test) datasets over disjoint file groups."""
    train_files, test_files = stratified_group_split(
        full_set.annotate_df, test_size=test_size, rand_state=rand_state
    )
    train_ds = DetectionDataset(
        full_set.directory, file_list=train_files, transform=transform_train,
        include_area=include_area,
    )
    test_ds = DetectionDataset(
        full_set.directory, file_list=test_files, transform=transform_test,
        include_area=include_area,
    )
    return train_ds, test_ds
