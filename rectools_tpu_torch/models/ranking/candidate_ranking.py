"""Two-stage candidate-ranking pipeline.

Port of rectools_tpu/models/ranking/candidate_ranking.py over the port's
``ModelBase``, ``Dataset`` and ``Splitter``: the generators are the port's
models, so their recommend runs on their ``device``. Behavioral parity with
reference rectools/models/ranking/candidate_ranking.py:17-868 (same
capability surface: pluggable first-stage generators over any ModelBase, a
one-fold splitter carving reranker train targets out of history, per-user
negative downsampling, a feature-collector hook, and a sklearn-style
reranker), built on this repo's own orchestration:

* first-stage outputs are pooled via an incremental outer-join keyed on
  (user, item), with missing-rank/score defaults applied once as a fill map;
* target labels come from a MultiIndex membership probe rather than an
  indicator merge;
* per-user top-k is a vectorized lexsort + cumcount (no groupby-apply).
"""

import typing as tp
import warnings
from collections import Counter

import numpy as np
import pandas as pd
import typing_extensions as tpe

from ...columns import Columns
from ...dataset import Dataset
from ...exceptions import NotFittedForStageError
from ...model_selection import Splitter
from ...types import ExternalIds
from ..base import ErrorBehaviour, ModelBase


@tp.runtime_checkable
class ClassifierBase(tp.Protocol):
    """Classifier protocol: fit + predict_proba (column 1 = positive class)."""

    def fit(self, *args: tp.Any, **kwargs: tp.Any) -> tpe.Self: ...  # noqa: D102
    def predict_proba(self, *args: tp.Any, **kwargs: tp.Any) -> np.ndarray: ...  # noqa: D102


@tp.runtime_checkable
class RankerBase(tp.Protocol):
    """Ranker protocol: fit + predict (ranking scores)."""

    def fit(self, *args: tp.Any, **kwargs: tp.Any) -> tpe.Self: ...  # noqa: D102
    def predict(self, *args: tp.Any, **kwargs: tp.Any) -> np.ndarray: ...  # noqa: D102


def _top_k_per_user(scored: pd.DataFrame, k: int, add_rank_col: bool) -> pd.DataFrame:
    """Vectorized per-user top-k of a (user, item, score) table.

    Stable lexsort keyed on (user, -score) followed by a per-user running
    count; rows past position k are dropped in one boolean mask.
    """
    keys = (-scored[Columns.Score].to_numpy(), scored[Columns.User].to_numpy())
    ranked = scored.iloc[np.lexsort(keys)].reset_index(drop=True)
    within_user = ranked.groupby(Columns.User, sort=False).cumcount()
    out = ranked[within_user < k].reset_index(drop=True)
    if add_rank_col:
        out[Columns.Rank] = out.groupby(Columns.User, sort=False).cumcount() + 1
    return out


class Reranker:
    """Second-stage scorer over candidate features
    (capability parity: reference candidate_ranking.py:117-237)."""

    def __init__(
        self,
        model: tp.Union[ClassifierBase, RankerBase],
        fit_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
    ):
        self.model = model
        self.fit_kwargs = fit_kwargs

    def prepare_fit_kwargs(self, candidates_with_target: pd.DataFrame) -> tp.Dict[str, tp.Any]:
        """Split candidate table into X / y fit arguments."""
        feature_table = candidates_with_target.drop(columns=Columns.UserItem)
        prepared: tp.Dict[str, tp.Any] = {
            "X": feature_table.drop(columns=Columns.Target),
            "y": feature_table[Columns.Target],
        }
        prepared.update(self.fit_kwargs or {})
        return prepared

    def fit(self, candidates_with_target: pd.DataFrame) -> None:
        """Fit the underlying model on candidates with targets."""
        self.model.fit(**self.prepare_fit_kwargs(candidates_with_target))

    def predict_scores(self, candidates: pd.DataFrame) -> np.ndarray:
        """Scores for candidates; classifiers report positive-class proba."""
        features = candidates.drop(columns=Columns.UserItem)
        if isinstance(self.model, ClassifierBase):
            return self.model.predict_proba(features)[:, 1]
        return self.model.predict(features)

    @classmethod
    def recommend(cls, scored_pairs: pd.DataFrame, k: int, add_rank_col: bool = True) -> pd.DataFrame:
        """Top-k per user by score."""
        return _top_k_per_user(scored_pairs, k, add_rank_col)


class CandidateFeatureCollector:
    """Feature hook for candidate (user, item) pairs; the base implementation
    adds nothing (capability parity: reference candidate_ranking.py:240-296)."""

    # Overridable hooks; each returns a frame keyed on the column(s) it joins by.
    def _get_user_features(self, users: ExternalIds, dataset: Dataset, fold_info: tp.Optional[dict]) -> pd.DataFrame:
        return pd.DataFrame(columns=[Columns.User])

    def _get_item_features(self, items: ExternalIds, dataset: Dataset, fold_info: tp.Optional[dict]) -> pd.DataFrame:
        return pd.DataFrame(columns=[Columns.Item])

    def _get_user_item_features(
        self, useritem: pd.DataFrame, dataset: Dataset, fold_info: tp.Optional[dict]
    ) -> pd.DataFrame:
        return pd.DataFrame(columns=Columns.UserItem)

    def collect_features(
        self, useritem: pd.DataFrame, dataset: Dataset, fold_info: tp.Optional[tp.Dict[str, tp.Any]]
    ) -> pd.DataFrame:
        """Left-join user / item / pair features onto the candidate table."""
        enriched = useritem
        for frame, keys in (
            (self._get_user_features(useritem[Columns.User].unique(), dataset, fold_info), Columns.User),
            (self._get_item_features(useritem[Columns.Item].unique(), dataset, fold_info), Columns.Item),
            (self._get_user_item_features(useritem, dataset, fold_info), Columns.UserItem),
        ):
            enriched = enriched.merge(frame, on=keys, how="left")
        return enriched


class NegativeSamplerBase:
    """Base class for negative sampling of reranker train pairs."""

    def sample_negatives(self, train: pd.DataFrame) -> pd.DataFrame:
        """Return the downsampled train table."""
        raise NotImplementedError()


class PerUserNegativeSampler(NegativeSamplerBase):
    """Keep all positives + at most n_negatives random negatives per user
    (capability parity: reference candidate_ranking.py:317-380)."""

    def __init__(self, n_negatives: int = 3, random_state: tp.Optional[int] = None):
        self.n_negatives = n_negatives
        self.random_state = random_state

    def sample_negatives(self, train: pd.DataFrame) -> pd.DataFrame:
        """Sample negatives per user without replacement: global shuffle,
        then keep each user's first ``n_negatives`` negative rows.

        Users holding ``n_negatives`` or fewer negatives keep all of them
        (the shuffle+head cap is then a no-op for those users).
        """
        is_negative = (train[Columns.Target] == 0).to_numpy()
        shuffled_negatives = train[is_negative].sample(frac=1.0, random_state=self.random_state)
        kept_negatives = shuffled_negatives.groupby(Columns.User, sort=False).head(self.n_negatives)
        combined = pd.concat([train[~is_negative], kept_negatives], ignore_index=True)
        return combined.sample(frac=1.0, random_state=self.random_state)


class CandidateGenerator:
    """First-stage model + candidate-generation policy
    (capability parity: reference candidate_ranking.py:383-495)."""

    def __init__(
        self,
        model: ModelBase,
        num_candidates: int,
        keep_ranks: bool,
        keep_scores: bool,
        scores_fillna_value: tp.Optional[float] = None,
        ranks_fillna_value: tp.Optional[float] = None,
    ):
        self.is_fitted_for_train = False
        self.is_fitted_for_recommend = False
        self.model = model
        self.num_candidates = num_candidates
        self.keep_ranks = keep_ranks
        self.keep_scores = keep_scores
        self.scores_fillna_value = scores_fillna_value
        self.ranks_fillna_value = ranks_fillna_value

    def fit(self, dataset: Dataset, for_train: bool) -> None:
        """Fit the first-stage model for the train or recommend stage."""
        self.model.fit(dataset)
        self.is_fitted_for_train = for_train
        self.is_fitted_for_recommend = not for_train

    def generate_candidates(
        self,
        users: ExternalIds,
        dataset: Dataset,
        filter_viewed: bool,
        for_train: bool,
        items_to_recommend: tp.Optional[ExternalIds] = None,
        on_unsupported_targets: ErrorBehaviour = "raise",
    ) -> pd.DataFrame:
        """Per-user candidates with optional rank/score columns."""
        stage = "train" if for_train else "recommend"
        stage_ready = self.is_fitted_for_train if for_train else self.is_fitted_for_recommend
        if not stage_ready:
            raise NotFittedForStageError(self.model.__class__.__name__, stage)

        candidates = self.model.recommend(
            users,
            dataset,
            k=self.num_candidates,
            filter_viewed=filter_viewed,
            items_to_recommend=items_to_recommend,
            add_rank_col=self.keep_ranks,
            on_unsupported_targets=on_unsupported_targets,
        )
        return candidates if self.keep_scores else candidates.drop(columns=Columns.Score)


class CandidateRankingModel(ModelBase):
    """Two-stage recommender: first-stage generators + trainable reranker
    (capability parity: reference candidate_ranking.py:497-868)."""

    def __init__(
        self,
        candidate_generators: tp.List[CandidateGenerator],
        splitter: Splitter,
        reranker: Reranker,
        sampler: tp.Optional[NegativeSamplerBase] = None,
        feature_collector: tp.Optional[CandidateFeatureCollector] = None,
        verbose: int = 0,
    ) -> None:
        super().__init__(verbose=verbose)
        n_splits = getattr(splitter, "n_splits", 1)
        if n_splits != 1:
            raise ValueError(
                f"CandidateRankingModel carves reranker targets from a single history fold; "
                f"got a splitter with n_splits={n_splits}."
            )
        self.splitter = splitter
        self.sampler = sampler or PerUserNegativeSampler()
        self.reranker = reranker
        self.cand_gen_dict = self._name_generators(candidate_generators)
        self.feature_collector = feature_collector or CandidateFeatureCollector()

    @staticmethod
    def _name_generators(
        candidate_generators: tp.List[CandidateGenerator],
    ) -> tp.Dict[str, CandidateGenerator]:
        """Assign each generator a stable feature-column prefix:
        ``{ModelClass}_{ordinal}`` in construction order."""
        seen: Counter = Counter()
        named = {}
        for generator in candidate_generators:
            cls_name = type(generator.model).__name__
            seen[cls_name] += 1
            named[f"{cls_name}_{seen[cls_name]}"] = generator
        return named

    def split_to_history_dataset_and_train_targets(
        self, dataset: Dataset, splitter: Splitter
    ) -> tp.Tuple[Dataset, pd.DataFrame, tp.Dict[str, tp.Any]]:
        """One-fold split into (history dataset, train targets, fold info)."""
        history_ids, target_ids, fold_info = next(iter(splitter.split(dataset.interactions, collect_fold_stats=True)))
        return (
            dataset.filter_interactions(history_ids),
            dataset.get_raw_interactions().iloc[target_ids],
            fold_info,
        )

    def _fit(self, dataset: Dataset, *args: tp.Any, refit_candidate_generators: bool = True, **kwargs: tp.Any) -> None:
        self.reranker.fit(self.get_train_with_targets_for_reranker(dataset), **kwargs)
        if refit_candidate_generators:
            self._fit_candidate_generators(dataset, for_train=False)

    def get_train_with_targets_for_reranker(self, dataset: Dataset) -> pd.DataFrame:
        """History split -> candidates -> targets -> negative sampling ->
        feature collection."""
        history_dataset, train_targets, fold_info = self.split_to_history_dataset_and_train_targets(
            dataset, self.splitter
        )
        labeled = self.get_full_candidates_with_targets(train_targets, history_dataset)
        downsampled = self.sampler.sample_negatives(labeled)
        return self.feature_collector.collect_features(downsampled, history_dataset, fold_info)

    def get_full_candidates_with_targets(self, train_targets: pd.DataFrame, history_dataset: Dataset) -> pd.DataFrame:
        """Candidates from all generators with binary targets attached."""
        self._fit_candidate_generators(history_dataset, for_train=True)
        pooled = self._pool_first_stage_candidates(
            users=train_targets[Columns.User].unique(),
            dataset=history_dataset,
            filter_viewed=self.splitter.filter_already_seen,
            for_train=True,
        )
        return self._label_candidates(pooled, train_targets)

    @staticmethod
    def _label_candidates(candidates: pd.DataFrame, train_targets: pd.DataFrame) -> pd.DataFrame:
        """Binary target = membership of the (user, item) pair in the target
        interactions, probed through a MultiIndex (no merge needed).

        Deliberate deviation from the reference's left-merge-with-indicator
        (reference ranking/candidate_ranking.py:641-696): when
        ``train_targets`` contains duplicate (user, item) rows the reference
        duplicates the matching candidate rows, feeding the reranker repeated
        positives; membership probing labels each candidate once regardless.
        One candidate row per proposed pair is the intended contract here —
        interaction multiplicity belongs in feature engineering (e.g. a
        weight/count feature), not in silently repeated training rows."""
        candidate_pairs = pd.MultiIndex.from_frame(candidates[Columns.UserItem])
        target_pairs = pd.MultiIndex.from_frame(train_targets[Columns.UserItem])
        labeled = candidates.copy()
        labeled[Columns.Target] = candidate_pairs.isin(target_pairs).astype("int32")
        return labeled

    def _fit_candidate_generators(self, dataset: Dataset, for_train: bool) -> None:
        for generator in self.cand_gen_dict.values():
            generator.fit(dataset, for_train)

    def _pool_first_stage_candidates(
        self,
        users: ExternalIds,
        dataset: Dataset,
        filter_viewed: bool,
        for_train: bool,
        items_to_recommend: tp.Optional[ExternalIds] = None,
        on_unsupported_targets: ErrorBehaviour = "raise",
    ) -> pd.DataFrame:
        """Union all generators' candidates into one feature table.

        Each generator contributes ``{name}_rank`` / ``{name}_score`` columns;
        the union is an incremental outer join on (user, item), and pairs a
        generator did not propose get that generator's configured fill values
        (applied once as a single fill map at the end).
        """
        pooled: tp.Optional[pd.DataFrame] = None
        fill_map: tp.Dict[str, float] = {}
        for name, generator in self.cand_gen_dict.items():
            proposal = generator.generate_candidates(
                users=users,
                dataset=dataset,
                filter_viewed=filter_viewed,
                for_train=for_train,
                items_to_recommend=items_to_recommend,
                on_unsupported_targets=on_unsupported_targets,
            )
            renames = {Columns.Rank: f"{name}_rank", Columns.Score: f"{name}_score"}
            proposal = proposal.rename(columns=renames)
            if generator.keep_ranks and generator.ranks_fillna_value is not None:
                fill_map[f"{name}_rank"] = generator.ranks_fillna_value
            if generator.keep_scores and generator.scores_fillna_value is not None:
                fill_map[f"{name}_score"] = generator.scores_fillna_value
            pooled = proposal if pooled is None else pooled.merge(proposal, how="outer", on=Columns.UserItem)
        assert pooled is not None, "at least one candidate generator is required"
        return pooled.fillna(fill_map) if fill_map else pooled

    def _ensure_generators_ready_for_serving(self, dataset: Dataset, force_fit: bool) -> None:
        """Refit first-stage models on the full dataset when any of them is
        still in its train-stage fit (or when the caller forces it)."""
        if force_fit or not all(g.is_fitted_for_recommend for g in self.cand_gen_dict.values()):
            self._fit_candidate_generators(dataset, for_train=False)

    def recommend(  # type: ignore[override]
        self,
        users: ExternalIds,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        items_to_recommend: tp.Optional[ExternalIds] = None,
        add_rank_col: bool = True,
        on_unsupported_targets: ErrorBehaviour = "raise",
        context: tp.Optional[pd.DataFrame] = None,
        force_fit_candidate_generators: bool = False,
    ) -> pd.DataFrame:
        """Two-stage recommend: pool first-stage candidates, score them with
        the reranker, keep each user's top-k."""
        self._check_is_fitted()
        self._check_k(k)
        if context is not None:
            warnings.warn(
                "CandidateRankingModel ignores `context`: neither stage is context-aware.",
                UserWarning,
            )
        self._ensure_generators_ready_for_serving(dataset, force_fit_candidate_generators)

        pooled = self._pool_first_stage_candidates(
            users=users,
            dataset=dataset,
            filter_viewed=filter_viewed,
            items_to_recommend=items_to_recommend,
            for_train=False,
            on_unsupported_targets=on_unsupported_targets,
        )
        featured = self.feature_collector.collect_features(pooled, dataset, fold_info=None)
        scored = pooled.reindex(columns=Columns.UserItem)
        scored[Columns.Score] = self.reranker.predict_scores(featured)
        return self.reranker.recommend(scored, k=k, add_rank_col=add_rank_col)
