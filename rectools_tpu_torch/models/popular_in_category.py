"""Category-balanced popularity model: the port of
rectools_tpu/models/popular_in_category.py.

Behavioral parity with reference rectools/models/popular_in_category.py
(quota strategies ``proportional``/``equal``, mixing ``rotate``/``group``,
fallback fill, cold targets served the fixed mixed list — see reference
lines 240-332 for the pinned behavior), with a device-first execution plan
instead of the reference's per-category pandas pipeline:

* fit builds per-category popularity arrays with numpy segment ops
  (bincount / unique), not per-category DataFrame copies;
* ``recommend`` ranks ALL (user, category) pairs in ONE top-k engine call —
  categories become columns of an (n_items, n_categories) order-value matrix
  and subjects become one-hot CSR rows selecting a category, so the whole
  per-category ranking (including seen-item filtering) is a single batched
  matmul + top-k on the model's ``device``;
* quota assignment, deduplication, fallback fill and list mixing are
  vectorized numpy over the flat result triplets (lexsort + segment
  cumcounts), not groupby/concat chains.
"""

import typing as tp
import warnings
from datetime import datetime, timedelta
from enum import Enum

import numpy as np
import pandas as pd
import typing_extensions as tpe
from scipy import sparse

from ..columns import Columns
from ..dataset import Dataset
from ..dataset import features
from ..utils.device import resolve_device
from .base import FixedColdRecoModelMixin, ModelBase
from .popular import PopularModelConfig, PopularModelMixin, Popularity, PopularityOptions
from .rank import Distance, TorchRanker


class MixingStrategy(Enum):
    """How per-category lists are interleaved in the final ranking."""

    ROTATE = "rotate"
    GROUP = "group"


class RatioStrategy(Enum):
    """How the per-category quotas are derived from category scores."""

    EQUAL = "equal"
    PROPORTIONAL = "proportional"


class PopularInCategoryModelConfig(PopularModelConfig):
    """Config for `PopularInCategoryModel`."""

    category_feature: str
    n_categories: tp.Optional[int] = None
    mixing_strategy: MixingStrategy = MixingStrategy.ROTATE
    ratio_strategy: RatioStrategy = RatioStrategy.PROPORTIONAL


def _group_cumcount(new_group: np.ndarray) -> np.ndarray:
    """Positions within consecutive groups: ``new_group`` marks group starts."""
    idx = np.arange(len(new_group))
    return idx - np.maximum.accumulate(np.where(new_group, idx, 0))


class PopularInCategoryModel(FixedColdRecoModelMixin, PopularModelMixin, ModelBase[PopularInCategoryModelConfig]):
    """Popularity recommendations balanced across values of one categorical
    item feature."""

    recommends_for_warm = False
    recommends_for_cold = True

    config_class = PopularInCategoryModelConfig

    def __init__(
        self,
        category_feature: str,
        n_categories: tp.Optional[int] = None,
        mixing_strategy: tp.Literal["rotate", "group"] = "rotate",
        ratio_strategy: tp.Literal["proportional", "equal"] = "proportional",
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
        self.category_feature = category_feature
        self.mixing_strategy = self._parse_enum(MixingStrategy, "mixing_strategy", mixing_strategy)
        self.ratio_strategy = self._parse_enum(RatioStrategy, "ratio_strategy", ratio_strategy)
        if n_categories is not None and n_categories <= 0:
            raise ValueError(f"`n_categories` must be a positive number. Got {n_categories}")
        self.n_categories = n_categories

        # fitted state: per category (priority order = category score desc)
        self.category_columns: tp.List[int] = []  # feature-column numbers
        self.category_scores: pd.Series = pd.Series(dtype=float)  # score per column
        self.n_effective_categories: int = 0
        self._cat_items: tp.List[np.ndarray] = []  # popularity-ordered item ids
        self._cat_item_scores: tp.List[np.ndarray] = []  # aligned true scores

    @staticmethod
    def _parse_enum(enum_cls: tp.Type[Enum], arg_name: str, raw: tp.Any) -> tp.Any:
        try:
            return enum_cls(raw)
        except ValueError:
            options = sorted(member.value for member in enum_cls)
            raise ValueError(f"`{arg_name}` must be one of {options}. Got {raw}.")

    def _get_config(self) -> PopularInCategoryModelConfig:
        return PopularInCategoryModelConfig(
            cls=self.__class__,
            category_feature=self.category_feature,
            n_categories=self.n_categories,
            mixing_strategy=self.mixing_strategy,
            ratio_strategy=self.ratio_strategy,
            popularity=self.popularity,
            period=self.period,
            begin_from=self.begin_from,
            add_cold=self.add_cold,
            inverse=self.inverse,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: PopularInCategoryModelConfig) -> tpe.Self:
        return cls(
            category_feature=config.category_feature,
            n_categories=config.n_categories,
            mixing_strategy=config.mixing_strategy.value,
            ratio_strategy=config.ratio_strategy.value,
            popularity=config.popularity.value,
            period=config.period,
            begin_from=config.begin_from,
            add_cold=config.add_cold,
            inverse=config.inverse,
            verbose=config.verbose,
            device=config.device,
        )

    # ---------------------------------------------------------------------- fit

    def _category_feature_columns(self, dataset: Dataset) -> tp.List[int]:
        """Columns of the sparse item-feature matrix that one-hot-encode the
        requested categorical feature."""
        if not dataset.item_features:
            raise ValueError(
                "Dataset must have `item_features` for PopularInCategoryModel. "
                "Specify `item_features_df` when creating Dataset"
            )
        if not isinstance(dataset.item_features, features.SparseFeatures):
            raise TypeError("Only sparse features are supported for PopularInCategoryModel. ")
        columns = [
            col
            for col, (name, value) in enumerate(dataset.item_features.names)
            if name == self.category_feature and value != features.DIRECT_FEATURE_VALUE
        ]
        if not columns:
            raise ValueError("`category_feature` must be present in `cat_item_features` when creating Dataset")
        return columns

    def _category_agg_score(self, users: np.ndarray, weights: np.ndarray) -> float:
        """One scalar per category — drives priority order and quotas."""
        if self.popularity == Popularity.N_USERS:
            return float(len(np.unique(users)))
        if self.popularity == Popularity.N_INTERACTIONS:
            return float(len(users))
        if self.popularity == Popularity.MEAN_WEIGHT:
            return float(weights.mean())
        return float(weights.sum())

    def _item_popularity_scores(
        self, items: np.ndarray, users: np.ndarray, weights: np.ndarray, n_items: int, n_users: int
    ) -> np.ndarray:
        """Dense per-item popularity over one category's interactions
        (items without interactions get score 0)."""
        if self.popularity == Popularity.N_USERS:
            pair_keys = np.unique(items.astype(np.int64) * n_users + users.astype(np.int64))
            return np.bincount((pair_keys // n_users).astype(np.int64), minlength=n_items).astype(np.float64)
        if self.popularity == Popularity.N_INTERACTIONS:
            return np.bincount(items, minlength=n_items).astype(np.float64)
        sums = np.bincount(items, weights=weights, minlength=n_items)
        if self.popularity == Popularity.SUM_WEIGHT:
            return sums
        counts = np.bincount(items, minlength=n_items)
        return np.divide(sums, counts, out=np.zeros_like(sums), where=counts > 0)

    def _fit(self, dataset: Dataset) -> None:
        candidate_columns = self._category_feature_columns(dataset)

        df = self._filter_interactions(dataset.interactions.df, self.period, self.begin_from)
        item_arr = df[Columns.Item].to_numpy()
        user_arr = df[Columns.User].to_numpy()
        weight_arr = df[Columns.Weight].to_numpy()
        n_items = dataset.item_id_map.size
        n_users = dataset.user_id_map.size

        # per-category member items from the one-hot feature columns
        csc = dataset.item_features.values.tocsc()
        kept_columns: tp.List[int] = []
        agg_scores: tp.List[float] = []
        masks: tp.List[np.ndarray] = []
        for col in candidate_columns:
            lo, hi = csc.indptr[col], csc.indptr[col + 1]
            member_items = csc.indices[lo:hi][csc.data[lo:hi] != 0]
            mask = np.isin(item_arr, member_items)
            if not mask.any():
                continue  # categories without interactions in the window are dropped
            kept_columns.append(col)
            agg_scores.append(self._category_agg_score(user_arr[mask], weight_arr[mask]))
            masks.append(mask)

        # priority order: category score descending, ties by column order
        priority = np.argsort(-np.asarray(agg_scores), kind="stable") if kept_columns else np.array([], dtype=int)
        if self.n_categories is not None:
            if len(kept_columns) < self.n_categories:
                warnings.warn(
                    "`n_categories` exceeds number of unique category values. "
                    f"Only {len(kept_columns)} categories will be analysed"
                )
            priority = priority[: self.n_categories]

        self.category_columns = [kept_columns[p] for p in priority]
        self.category_scores = pd.Series(
            [agg_scores[p] for p in priority], index=self.category_columns, dtype=float
        )
        self.n_effective_categories = len(self.category_columns)

        self._cat_items = []
        self._cat_item_scores = []
        for p in priority:
            mask = masks[p]
            dense_scores = self._item_popularity_scores(
                item_arr[mask], user_arr[mask], weight_arr[mask], n_items, n_users
            )
            active = np.flatnonzero(np.bincount(item_arr[mask], minlength=n_items))
            order = np.argsort(-dense_scores[active], kind="stable")
            cat_items = active[order]
            cat_scores = dense_scores[cat_items]
            if self.add_cold:
                # reference parity: a per-category popularity model with
                # add_cold appends every id-map item absent from the
                # category's interactions, score 0 (popular.py add_cold)
                cold = np.setdiff1d(np.arange(n_items), cat_items)
                cat_items = np.concatenate([cat_items, cold])
                cat_scores = np.concatenate([cat_scores, np.zeros(cold.size)])
            if self.inverse:
                cat_items = cat_items[::-1]
                cat_scores = cat_scores[::-1]
            self._cat_items.append(cat_items)
            self._cat_item_scores.append(cat_scores)

    # ------------------------------------------------------------------ quotas

    def _quotas(self, k: int) -> np.ndarray:
        """Per-category rec quotas in priority order; sums to min(k-ish) with
        the reference's remainder and zero-fix rules."""
        n_cat = self.n_effective_categories
        if self.ratio_strategy == RatioStrategy.PROPORTIONAL:
            scores = self.category_scores.to_numpy()
            quotas = np.floor(k * scores / scores.sum()).astype(np.int64)
            quotas[: k - quotas.sum()] += 1
            # every category deserves at least one slot, funded by the
            # lowest-priority categories that can spare one
            zero_pos = np.flatnonzero(quotas == 0)
            donor_pos = np.flatnonzero(quotas > 1)
            n_fix = min(len(zero_pos), len(donor_pos))
            if n_fix > 0:
                quotas[zero_pos[:n_fix]] = 1
                quotas[donor_pos[-n_fix:]] -= 1
        else:
            quotas = np.full(n_cat, k // n_cat, dtype=np.int64)
            quotas[: k - quotas.sum()] += 1
        return quotas

    # --------------------------------------------------------------- selection

    def _whitelisted_lists(
        self, sorted_item_ids_to_recommend: tp.Optional[np.ndarray]
    ) -> tp.Tuple[tp.List[np.ndarray], tp.List[np.ndarray]]:
        if sorted_item_ids_to_recommend is None:
            return self._cat_items, self._cat_item_scores
        items_out, scores_out = [], []
        for cat_items, cat_scores in zip(self._cat_items, self._cat_item_scores):
            keep = np.isin(cat_items, sorted_item_ids_to_recommend)
            items_out.append(cat_items[keep])
            scores_out.append(cat_scores[keep])
        return items_out, scores_out

    def _mix_and_fill(
        self,
        u_pos: np.ndarray,  # user positions 0..n_subjects-1
        items: np.ndarray,
        scores: np.ndarray,
        cat: np.ndarray,  # category priority index per row
        cat_rank: np.ndarray,  # 0-based rank within (user, category)
        n_subjects: int,
        k: int,
    ) -> np.ndarray:
        """Quota split, dedup, fallback fill and final mixing over flat rows.

        Returns row indices in final per-user rank order. Selection rules
        mirror the reference recommend pipeline (popular_in_category.py
        main/fallback merge): a row is "main" when its within-category rank
        fits the category quota; duplicated (user, item) pairs keep the
        occurrence with (main wins, then lowest category priority); users
        whose deduped main rows cover k keep exactly those, everyone else is
        topped up from fallback rows ordered by (main first, category rank,
        priority); final order is per-user (priority, rank) for ``group``
        mixing or a round-robin across categories for ``rotate``.
        """
        quotas = self._quotas(k)
        is_main = cat_rank < quotas[cat]

        # --- dedup (user, item): keep main over fallback, then lowest priority
        order = np.lexsort((cat, ~is_main, items, u_pos))
        u_sorted = u_pos[order]
        i_sorted = items[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = (u_sorted[1:] != u_sorted[:-1]) | (i_sorted[1:] != i_sorted[:-1])
        kept = order[first]

        u_k, main_k, rank_k, cat_k = u_pos[kept], is_main[kept], cat_rank[kept], cat[kept]

        # --- sufficiency: users whose main rows already fill k slots
        main_per_user = np.bincount(u_k[main_k], minlength=n_subjects)
        needs_fill = main_per_user < k

        from_sufficient = kept[main_k & ~needs_fill[u_k]]

        # --- fallback fill for the rest: per-user head-k of
        #     (main desc, category rank, priority)
        fill_rows = np.flatnonzero(needs_fill[u_k])
        fill_order = np.lexsort((cat_k[fill_rows], rank_k[fill_rows], ~main_k[fill_rows], u_k[fill_rows]))
        fill_sorted = fill_rows[fill_order]
        starts = np.ones(len(fill_sorted), dtype=bool)
        starts[1:] = u_k[fill_sorted[1:]] != u_k[fill_sorted[:-1]]
        within_user = _group_cumcount(starts)
        from_fill = kept[fill_sorted[within_user < k]]

        final = np.concatenate([from_sufficient, from_fill])
        if len(final) == 0:
            return final

        # --- mixing
        u_f, cat_f, rank_f = u_pos[final], cat[final], cat_rank[final]
        if self.mixing_strategy == MixingStrategy.GROUP:
            return final[np.lexsort((rank_f, cat_f, u_f))]
        # rotate: renumber ranks densely within (user, category) — surviving
        # rows keep their relative order but close the gaps dedup/fill left —
        # then interleave categories round-robin
        dense_order = np.lexsort((rank_f, cat_f, u_f))
        starts = np.ones(len(dense_order), dtype=bool)
        starts[1:] = (u_f[dense_order[1:]] != u_f[dense_order[:-1]]) | (
            cat_f[dense_order[1:]] != cat_f[dense_order[:-1]]
        )
        dense_rank = np.empty(len(final), dtype=np.int64)
        dense_rank[dense_order] = _group_cumcount(starts)
        return final[np.lexsort((cat_f, dense_rank, u_f))]

    # --------------------------------------------------------------- recommend

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cat_items, cat_scores = self._whitelisted_lists(sorted_item_ids_to_recommend)
        n_cat = self.n_effective_categories
        n_items = dataset.item_id_map.size
        n_users = len(user_ids)

        # (n_items, n_cat) order values: larger = earlier in the category's
        # popularity list, 0 = not in this category's list. True scores go in
        # a parallel lookup used after ranking.
        order_values = np.zeros((n_items, n_cat), dtype=np.float32)
        score_lookup = np.zeros((n_items, n_cat), dtype=np.float32)
        for c, (c_items, c_scores) in enumerate(zip(cat_items, cat_scores)):
            order_values[c_items, c] = np.arange(len(c_items), 0, -1, dtype=np.float32)
            score_lookup[c_items, c] = c_scores

        # one top-k call for ALL (user, category) pairs: subject row u*C + c
        # is the c-th basis vector, so its scores are category c's order
        # values; the engine handles seen-item masking per row
        n_rows = n_users * n_cat
        subjects = sparse.csr_matrix(
            (
                np.ones(n_rows, dtype=np.float32),
                np.tile(np.arange(n_cat), n_users),
                np.arange(n_rows + 1),
            ),
            shape=(n_rows, n_cat),
        )
        filter_csr = None
        if filter_viewed:
            user_rows = dataset.get_user_item_matrix(include_weights=False)[user_ids]
            filter_csr = user_rows[np.repeat(np.arange(n_users), n_cat)]

        ranker = TorchRanker(Distance.DOT, subjects, order_values, device=self.device)
        flat_pos, rec_items, rec_order = ranker.rank(
            subject_ids=np.arange(n_rows), k=k, filter_pairs_csr=filter_csr
        )

        # decode (user, category) and drop non-member hits (order value 0)
        member = rec_order >= 1.0
        flat_pos, rec_items = flat_pos[member], rec_items[member]
        u_pos = flat_pos // n_cat
        cat = flat_pos % n_cat
        # rows arrive grouped per flat subject in rank order
        starts = np.ones(len(flat_pos), dtype=bool)
        starts[1:] = flat_pos[1:] != flat_pos[:-1]
        cat_rank = _group_cumcount(starts)
        true_scores = score_lookup[rec_items, cat]

        chosen = self._mix_and_fill(u_pos, rec_items, true_scores, cat, cat_rank, n_users, k)
        return (
            np.asarray(user_ids)[u_pos[chosen]],
            rec_items[chosen].astype(np.int64),
            true_scores[chosen],
        )

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        single_reco, single_scores = self._get_cold_reco(dataset, k, sorted_item_ids_to_recommend)
        n_targets = len(target_ids)
        return (
            np.repeat(target_ids, len(single_reco)),
            np.tile(single_reco, n_targets),
            np.tile(single_scores, n_targets),
        )

    def _get_cold_reco(
        self, dataset: Dataset, k: int, sorted_item_ids_to_recommend: tp.Optional[np.ndarray]
    ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """Fixed list for cold targets: the same quota/mix pipeline applied to
        the raw category list heads (one pseudo-user, no filtering)."""
        cat_items, cat_scores = self._whitelisted_lists(sorted_item_ids_to_recommend)
        items_parts, scores_parts, cat_parts, rank_parts = [], [], [], []
        for c, (c_items, c_scores) in enumerate(zip(cat_items, cat_scores)):
            head = min(k, len(c_items))
            items_parts.append(c_items[:head])
            scores_parts.append(c_scores[:head])
            cat_parts.append(np.full(head, c, dtype=np.int64))
            rank_parts.append(np.arange(head, dtype=np.int64))
        items = np.concatenate(items_parts) if items_parts else np.array([], dtype=np.int64)
        scores = np.concatenate(scores_parts) if scores_parts else np.array([], dtype=np.float64)
        cat = np.concatenate(cat_parts) if cat_parts else np.array([], dtype=np.int64)
        cat_rank = np.concatenate(rank_parts) if rank_parts else np.array([], dtype=np.int64)

        chosen = self._mix_and_fill(
            np.zeros(len(items), dtype=np.int64), items, scores, cat, cat_rank, 1, k
        )
        return items[chosen].astype(np.int64), scores[chosen].astype(np.float32)
