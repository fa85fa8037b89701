"""Popularity metric: Average Recommendations Popularity.

The port's copy of ``rectools_tpu/metrics/popularity.py``.

Behavioral parity with reference rectools/metrics/popularity.py:28-160.
"""

import typing as tp

import attr
import pandas as pd

from ..columns import Columns
from .base import MetricAtK


@attr.s
class AvgRecPopularity(MetricAtK):
    """Average popularity of recommended items per list
    (reference popularity.py:28-132).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 2, 3, 3],
    ...     Columns.Item: [1, 2, 3, 1, 2, 3, 2],
    ...     Columns.Rank: [1, 2, 1, 2, 3, 1, 2]})
    >>> prev_interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 3, 3],
    ...     Columns.Item: [1, 2, 1, 3, 1, 2]})
    >>> AvgRecPopularity(k=3).calc_per_user(reco, prev_interactions).values
    array([2.5, 2. , 1.5])
    """

    normalize: bool = attr.ib(default=False)

    def calc(self, reco: pd.DataFrame, prev_interactions: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, prev_interactions).mean()

    def calc_per_user(self, reco: pd.DataFrame, prev_interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        item_popularity = prev_interactions[Columns.Item].value_counts(normalize=self.normalize)
        item_popularity.name = "popularity"
        reco_k = reco[reco[Columns.Rank] <= self.k]
        prepared = reco_k.join(item_popularity, on=Columns.Item, how="left")
        prepared = prepared.assign(popularity=prepared["popularity"].fillna(0))
        return prepared.groupby(Columns.User)["popularity"].mean().rename(None)


PopularityMetric = AvgRecPopularity


def calc_popularity_metrics(
    metrics: tp.Dict[str, PopularityMetric],
    reco: pd.DataFrame,
    prev_interactions: pd.DataFrame,
) -> tp.Dict[str, float]:
    """Family dispatcher."""
    return {name: metric.calc(reco, prev_interactions) for name, metric in metrics.items()}
