"""Popularity model: the port of rectools_tpu/models/popular.py (reference
rectools/models/popular.py).

Fit computes a popularity list on the host (tiny groupby). `recommend` runs
through the SAME GPU top-k engine as every other model, on the model's
``device``: items get an
order-value score (higher = earlier in the popularity list), the kernel
handles seen-filtering and whitelists, then reported scores are looked up from
the fitted popularity values. This removes the reference's per-user Python
loop (popular.py:266-317) entirely.
"""

import typing as tp
from datetime import datetime, timedelta
from enum import Enum

import numpy as np
import pandas as pd
import typing_extensions as tpe
from pydantic import BeforeValidator, PlainSerializer

from ..columns import Columns
from ..dataset import Dataset
from ..utils.device import resolve_device
from .base import FixedColdRecoModelMixin, ModelBase, ModelConfig
from .rank import Distance, TorchRanker


class Popularity(Enum):
    """Ways to measure item popularity."""

    N_USERS = "n_users"
    N_INTERACTIONS = "n_interactions"
    MEAN_WEIGHT = "mean_weight"
    SUM_WEIGHT = "sum_weight"


def _timedelta_from_json(value: tp.Any) -> tp.Any:
    """Accept a timedelta as-is, or rebuild one from its JSON dict form."""
    return timedelta(**value) if isinstance(value, dict) else value


def _timedelta_to_json(td: timedelta) -> dict:
    """JSON form of a timedelta: its nonzero normalized components only."""
    parts = (("days", td.days), ("seconds", td.seconds), ("microseconds", td.microseconds))
    return {name: amount for name, amount in parts if amount}


TimeDelta = tpe.Annotated[
    timedelta,
    BeforeValidator(func=_timedelta_from_json),
    PlainSerializer(func=_timedelta_to_json, return_type=dict, when_used="json"),
]


class PopularModelConfig(ModelConfig):
    """Config for `PopularModel`."""

    popularity: Popularity = Popularity.N_USERS
    period: tp.Optional[TimeDelta] = None
    begin_from: tp.Optional[datetime] = None
    add_cold: bool = False
    inverse: bool = False
    device: str = "cuda"


PopularityOptions = tp.Literal["n_users", "n_interactions", "mean_weight", "sum_weight"]


class PopularModelMixin:
    """Shared popularity helpers (also used by PopularInCategoryModel)."""

    @classmethod
    def _validate_popularity(cls, popularity: tp.Union[str, Popularity]) -> Popularity:
        try:
            return Popularity(popularity)
        except ValueError:
            possible = {item.value for item in Popularity.__members__.values()}
            raise ValueError(f"`popularity` must be one of the {possible}. Got {popularity}.")

    @classmethod
    def _validate_time_attributes(
        cls, period: tp.Optional[timedelta], begin_from: tp.Optional[datetime]
    ) -> None:
        if period is not None and begin_from is not None:
            raise ValueError("Only one of `period` and `begin_from` can be set")

    @classmethod
    def _filter_interactions(
        cls, interactions: pd.DataFrame, period: tp.Optional[timedelta], begin_from: tp.Optional[datetime]
    ) -> pd.DataFrame:
        window_start = begin_from
        if window_start is None and period is not None:
            window_start = interactions[Columns.Datetime].max() - period
        if window_start is None:
            return interactions
        return interactions.loc[interactions[Columns.Datetime] >= window_start]

    @classmethod
    def _score_items(cls, interactions: pd.DataFrame, popularity: Popularity) -> tp.Tuple[np.ndarray, np.ndarray]:
        """(item ids, popularity scores) for every item in the window.

        Pure-numpy segment aggregation over internal item ids — no pandas
        groupby. ``N_USERS`` dedups (item, user) pairs before counting.
        """
        item_ids = interactions[Columns.Item].to_numpy()
        if popularity is Popularity.N_USERS:
            pairs = np.unique(
                np.stack([item_ids, interactions[Columns.User].to_numpy()], axis=1), axis=0
            )
            item_ids = pairs[:, 0]
        counts = np.bincount(item_ids)
        present = np.flatnonzero(counts)
        if popularity is Popularity.N_USERS or popularity is Popularity.N_INTERACTIONS:
            return present, counts[present].astype(np.float64)
        weights = interactions[Columns.Weight].to_numpy(dtype=np.float64)
        valid = ~np.isnan(weights)
        # skip NaN weights in both the numerator and the mean denominator —
        # pandas-groupby semantics (sum of an all-NaN group is 0.0, mean is NaN)
        weight_sums = np.bincount(item_ids[valid], weights=weights[valid], minlength=len(counts))
        if popularity is Popularity.SUM_WEIGHT:
            return present, weight_sums[present]
        if popularity is Popularity.MEAN_WEIGHT:
            valid_counts = np.bincount(item_ids[valid], minlength=len(counts))[present]
            with np.errstate(invalid="ignore"):
                return present, weight_sums[present] / valid_counts
        raise ValueError(f"Unexpected popularity {popularity}")


class PopularModel(FixedColdRecoModelMixin, PopularModelMixin, ModelBase[PopularModelConfig]):
    """Recommend items by popularity.

    popularity: how to score items; period/begin_from restrict the time window;
    add_cold appends zero-score cold items; inverse selects least popular.
    """

    recommends_for_warm = False
    recommends_for_cold = True

    config_class = PopularModelConfig

    def __init__(
        self,
        popularity: PopularityOptions = "n_users",
        period: tp.Optional[timedelta] = None,
        begin_from: tp.Optional[datetime] = None,
        add_cold: bool = False,
        inverse: bool = False,
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.popularity = self._validate_popularity(popularity)
        self._validate_time_attributes(period, begin_from)
        self.period = period
        self.begin_from = begin_from
        self.add_cold = add_cold
        self.inverse = inverse
        self.popularity_list: tp.Tuple[np.ndarray, np.ndarray]

    def _get_config(self) -> PopularModelConfig:
        return PopularModelConfig(
            cls=self.__class__,
            popularity=self.popularity,
            period=self.period,
            begin_from=self.begin_from,
            add_cold=self.add_cold,
            inverse=self.inverse,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: PopularModelConfig) -> tpe.Self:
        return cls(
            popularity=config.popularity.value,
            period=config.period,
            begin_from=config.begin_from,
            add_cold=config.add_cold,
            inverse=config.inverse,
            verbose=config.verbose,
            device=config.device,
        )

    def _fit(self, dataset: Dataset) -> None:
        interactions = self._filter_interactions(dataset.interactions.df, self.period, self.begin_from)
        items, scores = self._score_items(interactions, self.popularity)
        # Final ordering goes through pandas' descending sort so tied scores
        # land in the exact order downstream users of the reference library
        # are used to (its tie permutation is not a stable/reversed argsort).
        ranked = pd.Series(scores, index=items).sort_values(ascending=False)
        items = ranked.index.to_numpy()
        scores = ranked.to_numpy().astype(float)

        if self.add_cold:
            catalog = dataset.item_id_map.internal_ids
            unseen = catalog[~np.isin(catalog, items)]
            items = np.append(items, unseen)
            scores = np.append(scores, np.zeros_like(unseen, dtype=float))

        if self.inverse:
            items, scores = items[::-1], scores[::-1]

        self.popularity_list = (items, scores)

    def _get_filtered_popularity_list(
        self, sorted_item_ids_to_recommend: tp.Optional[np.ndarray]
    ) -> tp.Tuple[np.ndarray, np.ndarray]:
        items, scores = self.popularity_list
        if sorted_item_ids_to_recommend is not None:
            mask = np.isin(items, sorted_item_ids_to_recommend)
            items, scores = items[mask], scores[mask]
        return items, scores

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        items, scores = self._get_filtered_popularity_list(sorted_item_ids_to_recommend)
        if len(items) == 0:
            return np.array([]), np.array([]), np.array([])

        n_total = dataset.item_id_map.size
        # Order value: position in the popularity list, higher = better.
        order_val = np.zeros((n_total, 1), dtype=np.float32)
        order_val[items, 0] = np.arange(len(items), 0, -1, dtype=np.float32)
        score_lookup = np.zeros(n_total, dtype=np.float32)
        score_lookup[items] = scores

        if filter_viewed:
            user_items = dataset.get_user_item_matrix(include_weights=False)
            filter_csr = user_items[user_ids]
        else:
            filter_csr = None

        subjects = np.ones((dataset.user_id_map.size, 1), dtype=np.float32)
        ranker = TorchRanker(Distance.DOT, subjects, order_val, device=self.device)
        subj, obj, _ = ranker.rank(
            subject_ids=user_ids,
            k=k,
            filter_pairs_csr=filter_csr,
            sorted_object_whitelist=np.sort(items),
        )
        return subj, obj, score_lookup[obj]

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        items, scores = self._get_filtered_popularity_list(sorted_item_ids_to_recommend)
        single_reco = items[:k]
        single_scores = scores[:k]
        n_targets = len(target_ids)
        return (
            np.repeat(target_ids, len(single_reco)),
            np.tile(single_reco, n_targets),
            np.tile(single_scores, n_targets),
        )

    def _get_cold_reco(
        self, dataset: Dataset, k: int, sorted_item_ids_to_recommend: tp.Optional[np.ndarray]
    ) -> tp.Tuple[np.ndarray, np.ndarray]:
        items, scores = self._get_filtered_popularity_list(sorted_item_ids_to_recommend)
        return items[:k], scores[:k]
