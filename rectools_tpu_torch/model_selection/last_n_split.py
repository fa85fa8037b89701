"""Leave-k-out splitter on last interactions per user.

The port's copy of ``rectools_tpu/model_selection/last_n_split.py``.

Behavioral parity with reference rectools/model_selection/last_n_split.py:27-160.
"""

import typing as tp

import numpy as np

from ..columns import Columns
from ..dataset import Interactions
from .splitter import Splitter


class LastNSplitter(Splitter):
    """Last-n interactions per user per fold, stable order for tied datetimes
    (reference last_n_split.py:27-160).

    Three users with interleaved histories (user 9 interacts exactly once):

    >>> import pandas as pd
    >>> df = pd.DataFrame(
    ...     {
    ...         Columns.User: [7, 8, 7, 9, 8, 7],
    ...         Columns.Item: [101, 102, 103, 101, 103, 102],
    ...         Columns.Weight: [1.0] * 6,
    ...         Columns.Datetime: pd.to_datetime(
    ...             ["2024-03-01", "2024-03-02", "2024-03-03",
    ...              "2024-03-04", "2024-03-05", "2024-03-06"]
    ...         ),
    ...     }
    ... )
    >>> interactions = Interactions(df)

    Two leave-one-out folds, no filtering — each fold's test set holds one
    interaction per user (user 9 only ever appears in the newest fold):

    >>> for train_ids, test_ids, _ in LastNSplitter(1, 2, False, False, False).split(interactions):
    ...     print(train_ids, test_ids)
    [0] [1 2]
    [0 1 2] [3 4 5]

    With ``filter_cold_users=True`` test rows of users absent from the fold's
    train part are dropped (user 8 in fold one, user 9 in fold two):

    >>> for train_ids, test_ids, _ in LastNSplitter(1, 2, True, False, False).split(interactions):
    ...     print(train_ids, test_ids)
    [0] [2]
    [0 1 2] [4 5]
    """

    def __init__(
        self,
        n: int,
        n_splits: int = 1,
        filter_cold_users: bool = True,
        filter_cold_items: bool = True,
        filter_already_seen: bool = True,
    ) -> None:
        super().__init__(filter_cold_users, filter_cold_items, filter_already_seen)
        self.n = n
        self.n_splits = n_splits

    @staticmethod
    def _recency_per_user(users: np.ndarray, datetimes: np.ndarray) -> np.ndarray:
        """Per-row recency within each user's history: 1 = newest interaction.

        Tied datetimes keep table order (the later table row is the more
        recent one) via the stable lexsort key, so the semantics match the
        reference's ``rank(method="first")`` contract without a groupby.
        """
        n_rows = users.shape[0]
        row_pos = np.arange(n_rows)
        order = np.lexsort((row_pos, datetimes, users))
        sorted_users = users[order]
        is_head = np.empty(n_rows, dtype=bool)
        if n_rows:
            is_head[0] = True
            is_head[1:] = sorted_users[1:] != sorted_users[:-1]
        head_pos = np.flatnonzero(is_head)
        group_of = np.cumsum(is_head) - 1
        group_end = np.append(head_pos[1:], n_rows)
        # Distance from the end of the user's sorted run, counted from 1.
        recency_sorted = group_end[group_of] - row_pos
        recency = np.empty(n_rows, dtype=np.int64)
        recency[order] = recency_sorted
        return recency

    def _split_without_filter(
        self,
        interactions: Interactions,
        collect_fold_stats: bool = False,
    ) -> tp.Iterator[tp.Tuple[np.ndarray, np.ndarray, tp.Dict[str, tp.Any]]]:
        df = interactions.df
        recency = self._recency_per_user(
            df[Columns.User].to_numpy(),
            df[Columns.Datetime].to_numpy(),
        )
        # Fold 0 tests the oldest window of the sliding scheme; the newest
        # ``(fold index from the end) * n`` interactions are dropped entirely.
        for fold, window_hi in enumerate(range(self.n_splits * self.n, 0, -self.n)):
            in_test = (recency <= window_hi) & (recency > window_hi - self.n)
            in_train = recency > window_hi
            yield np.flatnonzero(in_train), np.flatnonzero(in_test), {"i_split": fold}
