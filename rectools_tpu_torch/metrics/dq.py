"""Recommendations data-quality metrics.

The port's copy of ``rectools_tpu/metrics/dq.py``.

Behavioral parity with reference rectools/metrics/dq.py:29-300.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from ..utils.array_ops import fast_isin_for_sorted_test_elements
from .base import MetricAtK


@attr.s
class _RecoDQMetric(MetricAtK):
    """Base for reco-only DQ metrics (reference dq.py:29-78)."""

    deep: bool = attr.ib(default=False)

    def calc(self, reco: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco).mean()

    def calc_per_user(self, reco: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        raise NotImplementedError()


@attr.s
class SufficientReco(_RecoDQMetric):
    """Whether each user got k filled recommendations (reference dq.py:81-137).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 2, 3, 3, 3, 3, 3],
    ...     Columns.Item: [1, 2, 1, 2, 3, 1, 2, 3, 4, 5],
    ...     Columns.Rank: [1, 2, 1, 2, 3, 1, 2, 3, 4, 5]})
    >>> SufficientReco(k=4).calc_per_user(reco).values
    array([0, 0, 1])
    >>> SufficientReco(k=4, deep=True).calc_per_user(reco).values
    array([0.5 , 0.75, 1.  ])
    """

    def calc_per_user(self, reco: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        self._check(reco)
        reco_k = reco[reco[Columns.Rank] <= self.k]
        all_users = reco[Columns.User].unique()
        n_reco_per_user = reco_k.groupby(Columns.User).size().reindex(all_users, fill_value=0)
        if self.deep:
            return (n_reco_per_user / self.k).clip(upper=1).rename(None)
        return (n_reco_per_user >= self.k).astype("int").rename(None)


@attr.s
class UnrepeatedReco(_RecoDQMetric):
    """Absence of duplicated items per user list (reference dq.py:140-202).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 2, 3, 3, 3, 3, 3],
    ...     Columns.Item: [1, 2, 1, 1, 3, 1, 2, 2, 1, 5],
    ...     Columns.Rank: [1, 2, 1, 2, 3, 1, 2, 3, 4, 5]})
    >>> UnrepeatedReco(k=4).calc_per_user(reco).values
    array([1, 0, 0])
    >>> UnrepeatedReco(k=4, deep=True).calc_per_user(reco).values
    array([1.        , 0.66666667, 0.5       ])
    """

    def calc_per_user(self, reco: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        self._check(reco)
        reco_k = reco[reco[Columns.Rank] <= self.k].copy()
        reco_k["__unrepeated"] = ~reco_k.duplicated(subset=Columns.UserItem)
        if self.deep:
            stats = reco_k.groupby(Columns.User).agg(
                __n_unrepeated=("__unrepeated", "sum"), __n_reco=(Columns.User, "size")
            )
            return (stats["__n_unrepeated"] / stats["__n_reco"]).rename(None)
        return reco_k.groupby(Columns.User)["__unrepeated"].all().astype("int").rename(None)


@attr.s
class CoveredUsers(MetricAtK):
    """Share of test users present in the top-k reco (reference dq.py:205-290).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2],
    ...     Columns.Item: [1, 2, 1],
    ...     Columns.Rank: [1, 2, 2]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: [1, 2, 3, 4],
    ...     Columns.Item: [1, 1, 1, 1]})
    >>> CoveredUsers(k=2).calc_per_user(reco, interactions).values
    array([1, 1, 0, 0])
    """

    def calc(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, interactions).mean()

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        self._check(reco, interactions=interactions)
        target_users = interactions[Columns.User].unique()
        reco_users = np.unique(reco.loc[reco[Columns.Rank] <= self.k, Columns.User])
        covered = fast_isin_for_sorted_test_elements(target_users, reco_users)
        return pd.Series(covered, index=pd.Series(target_users, name=Columns.User), dtype="int")


RecoDQMetric = tp.Union[SufficientReco, UnrepeatedReco]
CrossDQMetric = CoveredUsers


def calc_reco_dq_metrics(metrics: tp.Dict[str, RecoDQMetric], reco: pd.DataFrame) -> tp.Dict[str, float]:
    """Family dispatcher."""
    return {name: metric.calc(reco) for name, metric in metrics.items()}


def calc_cross_dq_metrics(
    metrics: tp.Dict[str, CrossDQMetric], reco: pd.DataFrame, interactions: pd.DataFrame
) -> tp.Dict[str, float]:
    """Family dispatcher."""
    return {name: metric.calc(reco, interactions) for name, metric in metrics.items()}
