"""Intersection metric: overlap with a reference model's recommendations.

The port's copy of ``rectools_tpu/metrics/intersection.py``.

Behavioral parity with reference rectools/metrics/intersection.py:28-148.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from .base import MetricAtK
from .classification import Recall


@attr.s
class Intersection(MetricAtK):
    """Share of `reco` (top-k) present in `ref_reco` (top-ref_k)
    (reference intersection.py:28-110)."""

    ref_k: tp.Optional[int] = attr.ib(default=None)

    def calc(self, reco: pd.DataFrame, ref_reco: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, ref_reco).mean()

    def calc_per_user(self, reco: pd.DataFrame, ref_reco: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        self._check(reco, ref_reco=ref_reco)
        if ref_reco.shape[0] == 0:
            return pd.Series(index=pd.Series(name=Columns.User, dtype=int), dtype=np.float64)
        if ref_reco is reco:
            return pd.Series(
                data=1,
                index=pd.Series(data=reco[Columns.User].unique(), name=Columns.User, dtype=int),
                dtype=np.float64,
            )
        filtered_reco = reco[reco[Columns.Rank] <= self.k]
        ref_k = self.ref_k if self.ref_k is not None else self.k
        recall = Recall(k=ref_k)
        return recall.calc_per_user(ref_reco, filtered_reco[Columns.UserItem])


IntersectionMetric = Intersection


def calc_intersection_metrics(
    metrics: tp.Dict[str, IntersectionMetric],
    reco: pd.DataFrame,
    ref_reco: tp.Union[pd.DataFrame, tp.Dict[tp.Hashable, pd.DataFrame]],
) -> tp.Dict[str, float]:
    """Family dispatcher; dict of ref tables -> suffixed result names
    (reference intersection.py:113-148)."""
    results = {}
    for metric_name, metric in metrics.items():
        if isinstance(ref_reco, pd.DataFrame):
            results[metric_name] = metric.calc(reco, ref_reco)
        else:
            for ref_reco_name, ref_reco_df in ref_reco.items():
                results[f"{metric_name}_{ref_reco_name}"] = metric.calc(reco, ref_reco_df)
    return results
