"""Splitter base class: fold iteration + cold/seen filtering.

The port's copy of ``rectools_tpu/model_selection/splitter.py``.

Behavioral parity with reference rectools/model_selection/splitter.py:27-166
(test rows referencing cold users/items or already-seen pairs are dropped,
fold stats collected on demand); the filter is expressed as a composition of
mask predicates over one running test mask rather than sequential column
re-slicing.
"""

import typing as tp
from functools import lru_cache

import numpy as np
import pandas as pd

from ..columns import Columns
from ..dataset import Interactions
from .utils import get_not_seen_mask

SplitIter = tp.Iterator[tp.Tuple[np.ndarray, np.ndarray, tp.Dict[str, tp.Any]]]


class Splitter:
    """Base class for cross-validation splitters. Subclasses implement
    ``_split_without_filter``."""

    def __init__(
        self, filter_cold_users: bool = True, filter_cold_items: bool = True, filter_already_seen: bool = True
    ) -> None:
        self.filter_cold_users = filter_cold_users
        self.filter_cold_items = filter_cold_items
        self.filter_already_seen = filter_already_seen

    def split(self, interactions: Interactions, collect_fold_stats: bool = False) -> SplitIter:
        """Yield (train_idx, test_idx, split_info) with filtering applied."""
        for train_idx, test_idx, split_info in self._split_without_filter(interactions, collect_fold_stats):
            yield self.filter(interactions, collect_fold_stats, train_idx, test_idx, split_info)

    def _split_without_filter(self, interactions: Interactions, collect_fold_stats: bool = False) -> SplitIter:
        raise NotImplementedError

    def filter(
        self,
        interactions: Interactions,
        collect_fold_stats: bool,
        train_idx: np.ndarray,
        test_idx: np.ndarray,
        split_info: tp.Dict[str, tp.Any],
    ) -> tp.Tuple[np.ndarray, np.ndarray, tp.Dict[str, tp.Any]]:
        """Drop cold-user / cold-item / already-seen rows from the test fold."""
        wants_filtering = self.filter_cold_users or self.filter_cold_items or self.filter_already_seen
        if not (wants_filtering or collect_fold_stats):
            return train_idx, test_idx, split_info

        users = interactions.df[Columns.User].to_numpy()
        items = interactions.df[Columns.Item].to_numpy()
        train_users, train_items = users[train_idx], items[train_idx]

        @lru_cache(maxsize=None)
        def train_uniques(col: str) -> np.ndarray:
            return pd.unique(train_users if col == Columns.User else train_items)

        keep = np.ones(len(test_idx), dtype=bool)
        if self.filter_cold_users:
            keep &= np.isin(users[test_idx], train_uniques(Columns.User))
        if self.filter_cold_items:
            keep &= np.isin(items[test_idx], train_uniques(Columns.Item))
        if self.filter_already_seen:
            # seen-pair removal must see only rows that survived the cold
            # filters — matching the reference's sequential semantics
            surviving = test_idx[keep]
            not_seen = get_not_seen_mask(train_users, train_items, users[surviving], items[surviving])
            keep[np.flatnonzero(keep)[~not_seen]] = False
        test_idx = test_idx[keep]

        if collect_fold_stats:
            split_info.update(
                train=train_users.size,
                train_users=train_uniques(Columns.User).size,
                train_items=train_uniques(Columns.Item).size,
                test=test_idx.size,
                test_users=pd.unique(users[test_idx]).size,
                test_items=pd.unique(items[test_idx]).size,
            )
        return train_idx, test_idx, split_info
