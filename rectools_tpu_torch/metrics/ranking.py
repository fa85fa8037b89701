"""Ranking metrics: MAP, NDCG, MRR.

The port's copy of ``rectools_tpu/metrics/ranking.py``.

Behavioral parity with reference rectools/metrics/ranking.py:109-650.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd
from scipy import sparse

from ..columns import Columns
from ..utils.misc import log_at_base, select_by_type
from .base import merge_reco
from .debias import DebiasableMetrikAtK, calc_debiased_fit_task, debias_for_metric_configs, debias_interactions


@attr.s
class _RankingMetric(DebiasableMetrikAtK):
    """Base class for ranking metrics."""

    def calc(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, interactions).mean()

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        raise NotImplementedError()


@attr.s
class MAPFitted:
    """Precision-at-rank CSR + per-user relevant counts (reference ranking.py:80-106)."""

    precision_at_k: sparse.csr_matrix = attr.ib()
    users: np.ndarray = attr.ib()
    n_relevant_items: np.ndarray = attr.ib()


@attr.s
class MAP(_RankingMetric):
    """Mean Average Precision at k (reference ranking.py:109-307).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4],
    ...     Columns.Item: [7, 8, 1, 2, 1, 2, 3, 4, 1, 2, 3],
    ...     Columns.Rank: [1, 2, 1, 2, 1, 2, 3, 4, 1, 2, 3]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 3, 3, 3, 4, 4, 4],
    ...     Columns.Item: [1, 2, 1, 1, 3, 4, 1, 2, 3]})
    >>> MAP(k=3).calc_per_user(reco, interactions).values
    array([0.        , 1.        , 0.55555556, 1.        ])
    >>> MAP(k=3, divide_by_k=True).calc_per_user(reco, interactions).values
    array([0.        , 0.33333333, 0.55555556, 1.        ])
    """

    divide_by_k: bool = attr.ib(default=False)

    @classmethod
    def fit(cls, merged: pd.DataFrame, k_max: int) -> MAPFitted:
        """Precompute cumulative precision-at-rank rows per user."""
        users = np.unique(merged[Columns.User])
        if users.size == 0:
            return MAPFitted(sparse.csr_matrix(np.array([]).reshape(0, 0)), users, np.array([]))

        n_relevant_items = merged.groupby(Columns.User, sort=False)[Columns.Item].agg("size")[users].values

        user_idx = pd.Series(np.arange(users.size), index=users)
        hits = merged[merged[Columns.Rank] <= k_max]
        csr = sparse.csr_matrix(
            (
                np.ones(len(hits)),
                (hits[Columns.User].map(user_idx), hits[Columns.Rank].round().astype(int)),
            ),
            shape=(users.size, k_max + 1),
        )
        # per-row cumulative count of relevant items at each present rank
        row_lengths = np.diff(csr.indptr)
        global_cumsum = np.cumsum(csr.data)
        row_offsets = np.repeat(
            np.concatenate(([0], np.cumsum(np.asarray(csr.sum(axis=1)).ravel())[:-1])), row_lengths
        )
        csr.data = global_cumsum - row_offsets
        # precision@rank = cum_relevant / rank
        csr.data = csr.data / np.arange(k_max + 1)[csr.indices]
        return MAPFitted(csr, users, n_relevant_items)

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        is_debiased = False
        if self.debias_config is not None:
            interactions = debias_interactions(interactions, self.debias_config)
            is_debiased = True
        self._check(reco, interactions=interactions)
        fitted = self.fit(merge_reco(reco, interactions), k_max=self.k)
        return self.calc_per_user_from_fitted(fitted, is_debiased)

    def calc_per_user_from_fitted(self, fitted: MAPFitted, is_debiased: bool = False) -> pd.Series:
        """Per-user AP@k from fitted precision rows."""
        self._check_debias(is_debiased, obj_name="MAPFitted")
        sum_precisions = np.asarray(fitted.precision_at_k[:, 1 : self.k + 1].sum(axis=1)).reshape(-1)
        if self.divide_by_k:
            sum_precisions = sum_precisions / self.k
        else:
            sum_precisions = sum_precisions / fitted.n_relevant_items
        return pd.Series(sum_precisions, index=pd.Series(fitted.users, name=Columns.User)).rename(None)

    def calc_from_fitted(self, fitted: MAPFitted, is_debiased: bool = False) -> float:
        """Mean metric value from fitted data."""
        return self.calc_per_user_from_fitted(fitted, is_debiased).mean()


@attr.s
class NDCG(_RankingMetric):
    """Normalized DCG at k (reference ranking.py:313-478).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4],
    ...     Columns.Item: [7, 8, 1, 2, 1, 2, 3, 4, 1, 2, 3],
    ...     Columns.Rank: [1, 2, 1, 2, 1, 2, 3, 4, 1, 2, 3]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 3, 3, 3, 4, 4, 4],
    ...     Columns.Item: [1, 2, 1, 1, 3, 4, 1, 2, 3]})
    >>> NDCG(k=3).calc_per_user(reco, interactions).values
    array([0.        , 0.46927873, 0.70391809, 1.        ])
    """

    log_base: int = attr.ib(default=2)
    divide_by_achievable: bool = attr.ib(default=False)

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        self._check(reco, interactions=interactions)
        return self.calc_per_user_from_merged(merge_reco(reco, interactions))

    def calc_from_merged(self, merged: pd.DataFrame, is_debiased: bool = False) -> float:
        """Mean metric value from a merged table."""
        return self.calc_per_user_from_merged(merged, is_debiased).mean()

    def calc_per_user_from_merged(self, merged: pd.DataFrame, is_debiased: bool = False) -> pd.Series:
        """Per-user NDCG from a merged table."""
        if not is_debiased and self.debias_config is not None:
            merged = debias_interactions(merged, self.debias_config)

        dcg_vals = (merged[Columns.Rank] <= self.k).astype(int) / log_at_base(merged[Columns.Rank] + 1, self.log_base)
        ranks = np.arange(1, self.k + 1)
        discounted_gains = 1 / log_at_base(ranks + 1, self.log_base)

        if self.divide_by_achievable:
            frame = pd.DataFrame({Columns.User: merged[Columns.User], "__dcg": dcg_vals, "__item": 1})
            stats = frame.groupby(Columns.User, sort=False).agg(n_items=("__item", "count"), dcg=("__dcg", "sum"))
            idcg_map = dict(zip(ranks, discounted_gains.cumsum()))
            idcg_map[0] = 0
            idcg = stats["n_items"].clip(upper=self.k).map(idcg_map)
            ndcg = stats["dcg"] / idcg
        else:
            idcg = discounted_gains.sum()
            ndcg = (
                pd.DataFrame({Columns.User: merged[Columns.User], "__ndcg": dcg_vals / idcg})
                .groupby(Columns.User, sort=False)["__ndcg"]
                .sum()
            )
        return ndcg.rename(None)


@attr.s
class MRR(_RankingMetric):
    """Mean Reciprocal Rank at k (reference ranking.py:481-594).

    >>> import pandas as pd
    >>> reco = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4],
    ...     Columns.Item: [7, 8, 1, 2, 2, 1, 3, 4, 7, 8, 3],
    ...     Columns.Rank: [1, 2, 1, 2, 1, 2, 3, 4, 1, 2, 3]})
    >>> interactions = pd.DataFrame({
    ...     Columns.User: [1, 1, 2, 3, 3, 3, 4, 4, 4],
    ...     Columns.Item: [1, 2, 1, 1, 3, 4, 1, 2, 3]})
    >>> MRR(k=3).calc_per_user(reco, interactions).values
    array([0.        , 1.        , 0.5       , 0.33333333])
    """

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        self._check(reco, interactions=interactions)
        return self.calc_per_user_from_merged(merge_reco(reco, interactions))

    def calc_from_merged(self, merged: pd.DataFrame, is_debiased: bool = False) -> float:
        """Mean metric value from a merged table."""
        return self.calc_per_user_from_merged(merged, is_debiased).mean()

    def calc_per_user_from_merged(self, merged: pd.DataFrame, is_debiased: bool = False) -> pd.Series:
        """Per-user reciprocal first-relevant rank from a merged table.

        Flat numpy derivation (same idiom as the AUC metrics): the best
        in-window hit per user is a masked segment-min over the user column,
        taken with ``np.minimum.at`` — no groupby, no NaN sentinels.
        """
        if not is_debiased and self.debias_config is not None:
            merged = debias_interactions(merged, self.debias_config)
        user_codes, user_index = pd.factorize(merged[Columns.User], sort=True)
        ranks = merged[Columns.Rank].to_numpy(dtype=float, na_value=np.inf)
        in_window = ranks <= self.k
        best = np.full(len(user_index), np.inf)
        np.minimum.at(best, user_codes[in_window], ranks[in_window])
        rr = np.where(np.isfinite(best), 1.0 / best, 0.0)
        return pd.Series(rr, index=pd.Index(user_index, name=Columns.User), name=None)


RankingMetric = tp.Union[NDCG, MAP, MRR]


def calc_ranking_metrics(
    metrics: tp.Dict[str, RankingMetric],
    merged: pd.DataFrame,
) -> tp.Dict[str, float]:
    """Family dispatcher sharing merges and fitted MAP data
    (reference ranking.py:598-650)."""
    results = {}
    merged_debiased = None
    for metric_cls in (NDCG, MRR):
        selected: tp.Dict[str, tp.Any] = select_by_type(metrics, metric_cls)
        merged_debiased = debias_for_metric_configs(selected.values(), merged, merged_debiased)
        for name, metric in selected.items():
            results[name] = metric.calc_from_merged(merged_debiased[metric.debias_config], is_debiased=True)

    map_metrics: tp.Dict[str, MAP] = select_by_type(metrics, MAP)
    if map_metrics:
        fit_tasks = calc_debiased_fit_task(map_metrics.values(), merged, merged_debiased)
        fitted_debiased = {
            config: MAP.fit(merged_d, k_max_d) for config, (k_max_d, merged_d) in fit_tasks.items()
        }
        for name, metric in map_metrics.items():
            results[name] = metric.calc_from_fitted(fitted_debiased[metric.debias_config], is_debiased=True)
    return results
