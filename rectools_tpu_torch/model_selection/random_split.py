"""Random interaction-level splitter.

The port's copy of ``rectools_tpu/model_selection/random_split.py``.

Behavioral parity with reference rectools/model_selection/random_split.py:27-145.
"""

import typing as tp

import numpy as np
import pandas as pd

from ..dataset import Interactions
from .splitter import Splitter


class RandomSplitter(Splitter):
    """Non-overlapping random test folds of a fixed fraction
    (reference random_split.py:27-145).

    >>> import pandas as pd
    >>> from rectools_tpu_torch import Columns
    >>> df = pd.DataFrame(
    ...     [
    ...         [1, 2, 1, "2021-09-01"],
    ...         [2, 1, 1, "2021-09-02"],
    ...         [2, 3, 1, "2021-09-03"],
    ...         [3, 2, 1, "2021-09-03"],
    ...         [3, 3, 1, "2021-09-04"],
    ...         [3, 4, 1, "2021-09-04"],
    ...         [1, 2, 1, "2021-09-05"],
    ...         [4, 2, 1, "2021-09-05"],
    ...     ],
    ...     columns=[Columns.User, Columns.Item, Columns.Weight, Columns.Datetime],
    ... ).astype({Columns.Datetime: "datetime64[ns]"})
    >>> interactions = Interactions(df)
    >>> splitter = RandomSplitter(test_fold_frac=0.25, random_state=42, n_splits=2, filter_cold_users=False,
    ...                     filter_cold_items=False, filter_already_seen=False)
    >>> for train_ids, test_ids, _ in splitter.split(interactions):
    ...     print(sorted(train_ids), sorted(test_ids))  # doctest: +SKIP
    """

    def __init__(
        self,
        test_fold_frac: float,
        n_splits: int = 1,
        random_state: tp.Optional[int] = None,
        filter_cold_users: bool = True,
        filter_cold_items: bool = True,
        filter_already_seen: bool = True,
    ) -> None:
        super().__init__(filter_cold_users, filter_cold_items, filter_already_seen)
        if not 0.0 < test_fold_frac < 1.0:
            raise ValueError("Value of test_fold_frac must be between 0 and 1")
        if test_fold_frac * n_splits > 1:
            raise ValueError(f"Impossible to create {n_splits} non-overlapping folds {test_fold_frac:.1%} each")
        self.test_fold_frac = test_fold_frac
        self.n_splits = n_splits
        self.random_state = random_state

    def _fold_size(self, n_interactions: int) -> int:
        """Resolve the per-fold interaction count, validating it is usable."""
        size = int(round(self.test_fold_frac * n_interactions))
        problem = (
            "empty test part" if size == 0
            else "empty train part: all interactions are related to the test" if size == n_interactions
            else None
        )
        if problem is not None:
            raise ValueError(
                f"Length of interactions ({n_interactions}) with "
                f"test_fold_frac={self.test_fold_frac} leads to {problem}"
            )
        if size * self.n_splits > n_interactions:
            raise ValueError(
                f"Impossible to create {self.n_splits} non-overlapping folds "
                f"with size {size} from {n_interactions} interactions"
            )
        return size

    def _split_without_filter(
        self,
        interactions: Interactions,
        collect_fold_stats: bool = False,
    ) -> tp.Iterator[tp.Tuple[np.ndarray, np.ndarray, tp.Dict[str, tp.Any]]]:
        n = len(interactions.df)
        fold_size = self._fold_size(n)
        # permutation of a RangeIndex: matches the reference's draw sequence
        # bit-for-bit so seeded folds are interchangeable between libraries
        order = np.random.default_rng(self.random_state).permutation(pd.RangeIndex(0, n))
        for i_split in range(self.n_splits):
            window = slice(i_split * fold_size, (i_split + 1) * fold_size)
            yield np.delete(order, window), order[window], {"i_split": i_split}
