"""Serendipity metric: relevance-weighted unexpectedness.

The port's copy of ``rectools_tpu/metrics/serendipity.py``.

Behavioral parity with reference rectools/metrics/serendipity.py:29-320.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from .base import Catalog, MetricAtK


@attr.s
class SerendipityFitted:
    """Per-reco serendipity values (reference serendipity.py:29-44)."""

    serendipity_values: pd.DataFrame = attr.ib()
    users: np.ndarray = attr.ib()


@attr.s
class Serendipity(MetricAtK):
    """Combines per-rank relevance and item rarity vs catalog
    (reference serendipity.py:47-320).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: ["u1", "u1", "u2", "u2", "u3", "u4", "u4"],
    ...     Columns.Item: ["i1", "i2", "i2", "i3", "i3", "i2", "i3"],
    ...     Columns.Rank: [1, 2, 1, 2, 1, 1, 2]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: ["u1", "u1", "u2", "u2", "u3", "u4"],
    ...     Columns.Item: ["i1", "i2", "i2", "i3", "i2", "i2"]})
    >>> prev_interactions = pd.DataFrame({
    ...     Columns.User: ["u1", "u1", "u2", "u2", "u3"],
    ...     Columns.Item: ["i1", "i2", "i1", "i2", "i1"]})
    >>> catalog = ("i1", "i2", "i3", "i4")
    >>> Serendipity(k=2).calc_per_user(reco, interactions, prev_interactions, catalog).values
    array([0.   , 0.5  , 0.   , 0.125])
    """

    @classmethod
    def fit(
        cls,
        reco: pd.DataFrame,
        interactions: pd.DataFrame,
        prev_interactions: pd.DataFrame,
        catalog: Catalog,
        k_max: int,
    ) -> SerendipityFitted:
        """Precompute per-reco serendipity values for ranks <= k_max."""
        cls._check(reco, interactions=interactions, prev_interactions=prev_interactions)
        recommendations = reco.loc[reco[Columns.Rank] <= k_max]

        merged = pd.merge(
            recommendations, interactions[Columns.UserItem], how="left", indicator=True
        )
        merged["is_relevant"] = np.where(merged["_merge"] == "both", 1, 0)

        n_items = len(catalog)
        item_popularity_ranks = cls._get_item_popularity_ranks(prev_interactions)
        merged["rank_pop"] = merged[Columns.Item].map(item_popularity_ranks)
        merged["proba_user"] = (n_items + 1 - merged[Columns.Rank]) / n_items
        merged["proba_any_user"] = np.where(
            merged["rank_pop"].notnull(), (n_items + 1 - merged["rank_pop"]) / n_items, 0.0
        )
        merged["proba_diff"] = np.maximum(merged["proba_user"] - merged["proba_any_user"], 0.0)
        merged["serendipity"] = merged["proba_diff"] * merged["is_relevant"]
        return SerendipityFitted(
            merged[[Columns.User, Columns.Rank, "serendipity"]], recommendations[Columns.User].unique()
        )

    @staticmethod
    def _get_item_popularity_ranks(interactions: pd.DataFrame) -> pd.Series:
        """Dense popularity rank per item (1 = most popular count)."""
        item_counts = interactions[Columns.Item].value_counts()
        counts_unique = item_counts.unique()
        count_rank = pd.Series(index=counts_unique, data=np.arange(len(counts_unique)) + 1)
        return item_counts.map(count_rank)

    def calc_per_user_from_fitted(self, fitted: SerendipityFitted) -> pd.Series:
        """Per-user mean serendipity from fitted data."""
        serendipity_at_k = (
            fitted.serendipity_values.loc[fitted.serendipity_values[Columns.Rank] <= self.k]
            .groupby(Columns.User)["serendipity"]
            .agg("mean")
        )
        return serendipity_at_k.reindex(fitted.users).rename(None)

    def calc(
        self,
        reco: pd.DataFrame,
        interactions: pd.DataFrame,
        prev_interactions: pd.DataFrame,
        catalog: Catalog,
    ) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, interactions, prev_interactions, catalog).mean()

    def calc_from_fitted(self, fitted: SerendipityFitted) -> float:
        """Mean metric value from fitted data."""
        return self.calc_per_user_from_fitted(fitted).mean()

    def calc_per_user(
        self,
        reco: pd.DataFrame,
        interactions: pd.DataFrame,
        prev_interactions: pd.DataFrame,
        catalog: Catalog,
    ) -> pd.Series:
        """Per-user metric values."""
        fitted = self.fit(reco, interactions, prev_interactions, catalog, k_max=self.k)
        return self.calc_per_user_from_fitted(fitted)


SerendipityMetric = Serendipity


def calc_serendipity_metrics(
    metrics: tp.Dict[str, SerendipityMetric],
    reco: pd.DataFrame,
    interactions: pd.DataFrame,
    prev_interactions: pd.DataFrame,
    catalog: Catalog,
) -> tp.Dict[str, float]:
    """Family dispatcher sharing one fit at k_max."""
    results = {}
    if metrics:
        k_max = max(metric.k for metric in metrics.values())
        fitted = Serendipity.fit(reco, interactions, prev_interactions, catalog, k_max)
        for name, metric in metrics.items():
            results[name] = metric.calc_from_fitted(fitted)
    return results
