"""Stratified group train/test splitting.

Replaces the reference's ``make_train_test_split`` (CarImageClass.py:402-450):
StratifiedGroupKFold over annotation *rows*, stratified by class, grouped by
filename, ``n_splits = floor(1/test_size)``, first fold taken; the two splits
are materialized as new datasets restricted to per-split file lists.

The port's own copy of ``ssdx/data/split.py``; it needs scikit-learn.
"""
from __future__ import annotations

import numpy as np
from sklearn.model_selection import StratifiedGroupKFold

from .dataset import SEED, DetectionDataset

__all__ = ["stratified_group_split", "make_train_test_split"]


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
    groups = df["filename"]
    X = df.drop(columns=["class"])
    y = df["class"]
    n_splits = int(np.floor(1.0 / test_size))
    sgkf = StratifiedGroupKFold(n_splits=n_splits, shuffle=True, random_state=rand_state)
    tr_idx, te_idx = next(sgkf.split(X, y, groups=groups))
    train_files = df["filename"].iloc[tr_idx].drop_duplicates().to_list()
    test_files = df["filename"].iloc[te_idx].drop_duplicates().to_list()
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
