"""Novelty metric: Mean Inverse User Frequency.

The port's copy of ``rectools_tpu/metrics/novelty.py``.

Behavioral parity with reference rectools/metrics/novelty.py:29-215.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from .base import MetricAtK


@attr.s
class MIUFFitted:
    """Per-reco item novelties (reference novelty.py:29-43)."""

    item_novelties: pd.DataFrame = attr.ib()
    users: np.ndarray = attr.ib()


@attr.s
class MeanInvUserFreq(MetricAtK):
    """-log2(item user-frequency) averaged over top-k (reference novelty.py:46-215).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 2, 2, 3, 3],
    ...     Columns.Item: [3, 2, 3, 1, 2],
    ...     Columns.Rank: [1, 1, 2, 1, 2]})
    >>> prev_interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 3],
    ...     Columns.Item: [1, 2, 1, 1]})
    >>> MeanInvUserFreq(k=3).calc_per_user(reco, prev_interactions).values
    array([1.5849625 , 1.5849625 , 0.79248125])
    """

    @classmethod
    def fit(cls, reco: pd.DataFrame, prev_interactions: pd.DataFrame, k_max: int) -> MIUFFitted:
        """Precompute item novelties for ranks <= k_max."""
        cls._check(reco, prev_interactions=prev_interactions)
        n_interacted_users = prev_interactions[Columns.User].nunique()
        n_users_per_item = prev_interactions.groupby(Columns.Item)[Columns.User].nunique()

        recos = reco.loc[reco[Columns.Rank] <= k_max].copy()
        recos["n_users_per_item"] = recos[Columns.Item].map(n_users_per_item).fillna(1)
        recos["item_novelty"] = -np.log2(recos["n_users_per_item"] / n_interacted_users)
        return MIUFFitted(recos[[Columns.User, Columns.Rank, "item_novelty"]], reco[Columns.User].unique())

    def calc(self, reco: pd.DataFrame, prev_interactions: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, prev_interactions).mean()

    def calc_per_user(self, reco: pd.DataFrame, prev_interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        fitted = self.fit(reco, prev_interactions, k_max=self.k)
        return self.calc_per_user_from_fitted(fitted)

    def calc_from_fitted(self, fitted: MIUFFitted) -> float:
        """Mean metric value from fitted data."""
        return self.calc_per_user_from_fitted(fitted).mean()

    def calc_per_user_from_fitted(self, fitted: MIUFFitted) -> pd.Series:
        """Per-user mean item novelty from fitted data."""
        miuf_at_k = (
            fitted.item_novelties.loc[fitted.item_novelties[Columns.Rank] <= self.k]
            .groupby(Columns.User)["item_novelty"]
            .agg("mean")
        )
        return miuf_at_k.reindex(fitted.users).rename(None)


NoveltyMetric = MeanInvUserFreq


def calc_novelty_metrics(
    metrics: tp.Dict[str, NoveltyMetric],
    reco: pd.DataFrame,
    prev_interactions: pd.DataFrame,
) -> tp.Dict[str, float]:
    """Family dispatcher sharing one fit at k_max."""
    results = {}
    if metrics:
        k_max = max(metric.k for metric in metrics.values())
        fitted = MeanInvUserFreq.fit(reco, prev_interactions, k_max)
        for name, metric in metrics.items():
            results[name] = metric.calc_from_fitted(fitted)
    return results
