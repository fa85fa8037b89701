"""Intra-list diversity metric.

The port's copy of ``rectools_tpu/metrics/diversity.py``.

Behavioral parity with reference rectools/metrics/diversity.py:32-260; pair
generation is vectorized (template pairs per list length) instead of the
reference's per-user python `combinations` apply.
"""

import typing as tp
from itertools import combinations

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from .base import MetricAtK
from .distances import PairwiseDistanceCalculator


@attr.s
class ILDFitted:
    """All within-list item pairs with their ranks (reference diversity.py:32-47)."""

    recommended_items_paired: pd.DataFrame = attr.ib()
    users: np.ndarray = attr.ib()


@attr.s
class IntraListDiversity(MetricAtK):
    """Mean pairwise distance within each top-k list
    (reference diversity.py:50-260)."""

    distance_calculator: PairwiseDistanceCalculator = attr.ib()

    @classmethod
    def fit(cls, reco: pd.DataFrame, k_max: int) -> ILDFitted:
        """Build all within-user (item, item) pairs for ranks <= k_max."""
        cls._check(reco)
        recommendations = reco.loc[reco[Columns.Rank] <= k_max].sort_values(
            [Columns.User, Columns.Rank], kind="stable"
        )
        users = recommendations[Columns.User].unique()

        user_vals = recommendations[Columns.User].to_numpy()
        items = recommendations[Columns.Item].to_numpy()
        ranks = recommendations[Columns.Rank].to_numpy()

        # segment boundaries per user (sorted by user)
        change = np.concatenate(([True], user_vals[1:] != user_vals[:-1]))
        seg_starts = np.flatnonzero(change)
        seg_lengths = np.diff(np.concatenate((seg_starts, [len(user_vals)])))

        # template (i, j) index pairs per list length
        pair_templates: tp.Dict[int, np.ndarray] = {}
        idx0_parts: tp.List[np.ndarray] = []
        idx1_parts: tp.List[np.ndarray] = []
        pair_users: tp.List[np.ndarray] = []
        for start, length in zip(seg_starts, seg_lengths):
            if length < 2:
                continue
            if length not in pair_templates:
                pair_templates[length] = np.asarray(list(combinations(range(length), 2)), dtype=np.int64)
            template = pair_templates[length]
            idx0_parts.append(template[:, 0] + start)
            idx1_parts.append(template[:, 1] + start)
            pair_users.append(np.full(len(template), user_vals[start]))

        if not idx0_parts:
            paired = pd.DataFrame(columns=[Columns.User, "item_0", "item_1", "rank_0", "rank_1"])
            return ILDFitted(paired, users)

        idx0 = np.concatenate(idx0_parts)
        idx1 = np.concatenate(idx1_parts)
        paired = pd.DataFrame(
            {
                Columns.User: np.concatenate(pair_users),
                "item_0": items[idx0],
                "item_1": items[idx1],
                "rank_0": ranks[idx0],
                "rank_1": ranks[idx1],
            }
        )
        return ILDFitted(paired, users)

    def calc_per_user_from_fitted(self, fitted: ILDFitted) -> pd.Series:
        """Per-user mean pair distance from fitted data."""
        if len(fitted.recommended_items_paired) == 0:
            return pd.Series(index=fitted.users, data=0)
        paired = fitted.recommended_items_paired
        paired = paired.assign(
            dist=self.distance_calculator[paired["item_0"].values, paired["item_1"].values]
        )
        ild_at_k = (
            paired.loc[(paired["rank_0"] <= self.k) & (paired["rank_1"] <= self.k)]
            .groupby(Columns.User)["dist"]
            .agg("mean")
        )
        full = ild_at_k.reindex(fitted.users)
        full.loc[~full.index.isin(ild_at_k.index.values)] = 0
        return full.rename(None)

    def calc(self, reco: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco).mean()

    def calc_from_fitted(self, fitted: ILDFitted) -> float:
        """Mean metric value from fitted data."""
        return self.calc_per_user_from_fitted(fitted).mean()

    def calc_per_user(self, reco: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        fitted = self.fit(reco, k_max=self.k)
        return self.calc_per_user_from_fitted(fitted)


DiversityMetric = IntraListDiversity


def calc_diversity_metrics(
    metrics: tp.Dict[str, DiversityMetric],
    reco: pd.DataFrame,
) -> tp.Dict[str, float]:
    """Family dispatcher sharing one fit at k_max."""
    results = {}
    if metrics:
        k_max = max(metric.k for metric in metrics.values())
        fitted = IntraListDiversity.fit(reco, k_max)
        for name, metric in metrics.items():
            results[name] = metric.calc_from_fitted(fitted)
    return results
