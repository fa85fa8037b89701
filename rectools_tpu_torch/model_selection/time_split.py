"""Leave-time-out splitter with sliding date windows.

The port's copy of ``rectools_tpu/model_selection/time_split.py``.

Behavioral parity target: reference rectools/model_selection/time_split.py
(``TimeRangeSplitter``). Implemented as a single ``np.digitize`` pass over
the datetime column against the fold edges instead of per-fold boolean
masks.
"""

import re
import typing as tp

import numpy as np
import pandas as pd

from ..columns import Columns
from ..dataset import Interactions
from .splitter import Splitter

# pandas>=3 only accepts the lower-case hour alias; the reference's "4H"
# spelling stays accepted on input and is normalized before any pandas call.
_UNIT_ALIASES = {"D": "D", "H": "h", "h": "h"}
_TEST_SIZE_RE = re.compile(r"(?P<count>[1-9]\d*)(?P<unit>[DHh])")


class TimeRangeSplitter(Splitter):
    r"""Cross-validation splitter that carves the tail of the timeline into
    ``n_splits`` equal-width windows and tests on each window in order, with
    everything strictly before the window as train.

    ``test_size`` is ``"<count><unit>"`` with unit ``D`` (days) or ``H``/``h``
    (hours), e.g. ``"1D"``, ``"4H"``. The last window always covers the time
    unit containing the final interaction (its end is the last timestamp
    ceiled up to a unit boundary).

    >>> import pandas as pd
    >>> events = pd.DataFrame(
    ...     {
    ...         Columns.User: [10, 10, 20, 20, 30],
    ...         Columns.Item: [1, 2, 1, 3, 2],
    ...         Columns.Weight: [1, 1, 1, 1, 1],
    ...         Columns.Datetime: pd.to_datetime(
    ...             ["2024-03-01", "2024-03-02", "2024-03-02", "2024-03-03", "2024-03-04"]
    ...         ),
    ...     }
    ... )
    >>> splitter = TimeRangeSplitter("1D", n_splits=2, filter_cold_users=False,
    ...                              filter_cold_items=False, filter_already_seen=False)
    >>> for train, test, info in splitter.split(Interactions(events)):
    ...     print(train, test, str(info["start"].date()))
    [0 1 2] [3] 2024-03-03
    [0 1 2 3] [4] 2024-03-04
    """

    def __init__(
        self,
        test_size: str,
        n_splits: int = 1,
        filter_cold_users: bool = True,
        filter_cold_items: bool = True,
        filter_already_seen: bool = True,
    ) -> None:
        super().__init__(filter_cold_users, filter_cold_items, filter_already_seen)
        parsed = _TEST_SIZE_RE.fullmatch(test_size)
        if parsed is None:
            raise ValueError(
                f"test_size {test_size!r} is not of the form <count><unit> with unit D or H (e.g. '1D', '4H')"
            )
        self.test_size = test_size
        self.test_size_value = int(parsed["count"])
        self.test_size_unit = _UNIT_ALIASES[parsed["unit"]]
        self.n_splits = n_splits

    def _fold_edges(self, datetimes: "pd.Series[pd.Timestamp]") -> pd.DatetimeIndex:
        """``n_splits + 1`` window edges; edge[i]..edge[i+1] is test fold i."""
        final = datetimes.max()
        anchor = final.ceil(self.test_size_unit)
        if anchor == final:  # already on a unit boundary: the window must still contain it
            anchor += pd.Timedelta(1, unit=self.test_size_unit)
        span = pd.Timedelta(self.n_splits * self.test_size_value, unit=self.test_size_unit)
        return pd.date_range(
            start=anchor - span,
            periods=self.n_splits + 1,
            freq=f"{self.test_size_value}{self.test_size_unit}",
            tz=final.tz,
        )

    def get_test_fold_borders(self, interactions: Interactions) -> tp.List[tp.Tuple[pd.Timestamp, pd.Timestamp]]:
        """(start, end) per test fold; end of the last fold is the ceiled final timestamp."""
        edges = self._fold_edges(interactions.df[Columns.Datetime])
        return list(zip(edges[:-1], edges[1:]))

    def _split_without_filter(
        self,
        interactions: Interactions,
        collect_fold_stats: bool = False,
    ) -> tp.Iterator[tp.Tuple[np.ndarray, np.ndarray, tp.Dict[str, tp.Any]]]:
        datetimes = interactions.df[Columns.Datetime]
        edges = self._fold_edges(datetimes)
        # One searchsorted classifies every row: bin 0 = before all folds
        # (train for fold 0), bin i+1 = inside fold i, bin n_splits+1 = after
        # the end. (np.digitize rejects datetime64; side="right" matches its
        # half-open [start, end) fold semantics.)
        bins = np.searchsorted(edges.values, datetimes.values, side="right")
        for fold in range(self.n_splits):
            train_rows = np.flatnonzero(bins <= fold)
            test_rows = np.flatnonzero(bins == fold + 1)
            info = {"i_split": fold, "start": edges[fold], "end": edges[fold + 1]}
            yield train_rows, test_rows, info
