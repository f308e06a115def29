"""Canonical cross-validation splits: deterministic stratified K-fold with keys
``{"train", "val"}``, persisted once to ``fold_idx_dict.json`` and reloaded
by every later stage.

The JAX package calls sklearn's ``StratifiedKFold(shuffle=False)``; the port
computes the same folds in numpy (sklearn is not a dependency): labels are
encoded by order of first appearance, the per-fold count of each class is a
round robin over the sorted encoded labels, and each class's samples are
dealt to folds in contiguous blocks, in data order.
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import numpy as np


def stratified_test_folds(y: np.ndarray, n_splits: int) -> np.ndarray:
    """The fold each sample is held out in, as ``StratifiedKFold(n_splits,
    shuffle=False)._make_test_folds`` assigns it."""
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {y.shape}")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         f"members in each class.")
    if n_splits > y_counts.min():
        warnings.warn(f"The least populated class in y has only {y_counts.min()} members, "
                      f"which is less than n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    return test_folds


def create_fold_split_idx(
    num_folds: int, cls_ids: Sequence[int], seed: int | None = None
) -> Dict[int, Dict[str, list]]:
    """Stratified K-fold over labels; returns {fold: {"train": [...], "val": [...]}}.

    ``seed`` is accepted for interface stability and unused (no shuffle).
    ``num_folds == 1`` is a single stratified 80/20 holdout: the first of 5
    splits."""
    if num_folds < 1:
        raise ValueError("num_folds must be >= 1")
    n_splits = 5 if num_folds == 1 else num_folds
    test_folds = stratified_test_folds(np.asarray(cls_ids), n_splits)
    idx = np.arange(len(test_folds))
    return {k: {"train": idx[test_folds != k].tolist(), "val": idx[test_folds == k].tolist()}
            for k in range(num_folds)}
