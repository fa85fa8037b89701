"""The port's two-stage pipeline (``rectools_tpu_torch/models/ranking``)
held against the JAX package's on the CPU: the cases of
tests/models/ranking/test_{candidate_ranking,catboost_reranker}.py run
through both packages, then the pipeline stage by stage and end to end.

Tolerances:
- the history split, the train targets, the pooled candidates' users,
  items, ranks and row order, the labels, the sampled rows and their order:
  identical;
- generator scores and the features built from them: within 1e-5 relative
  and 1e-6 absolute (EASE's weights are f32 solves, each package its own
  way; PopularModel's scores are exact counts and equal);
- end to end, only with generators whose scores are exact (PopularModel) or
  a reranker whose output is a fixed function of exact features: the final
  recommendations identical, scores included.
"""

import typing as tp
import warnings

import numpy as np
import pandas as pd
import pytest
from sklearn.linear_model import LogisticRegression

from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.exceptions import NotFittedForStageError
from rectools_tpu_torch.model_selection import LastNSplitter, TimeRangeSplitter
from rectools_tpu_torch.models import EASEModel, PopularModel, load_model
from rectools_tpu_torch.models.ranking import (
    CandidateFeatureCollector,
    CandidateGenerator,
    CandidateRankingModel,
    CatBoostReranker,
    PerUserNegativeSampler,
    Reranker,
)
from rectools_tpu_torch.models.ranking import catboost_reranker as port_catboost

from .models.data import INTERACTIONS

SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def _frame() -> pd.DataFrame:
    """tests/models/ranking/test_candidate_ranking.py's frame (50 users, 30
    items, one interaction a day), in nanoseconds as the JAX package reads it."""
    rng = np.random.default_rng(0)
    rows = []
    for u in range(50):
        n = rng.integers(4, 12)
        for t, i in enumerate(rng.integers(0, 30, size=n)):
            rows.append((u, int(i), 1.0, pd.Timestamp("2021-01-01") + pd.Timedelta(days=int(t))))
    return pd.DataFrame(rows, columns=Columns.Interactions).astype({Columns.Datetime: "datetime64[ns]"})


def _datasets(df: tp.Optional[pd.DataFrame] = None) -> tp.Tuple[tp.Any, tp.Any]:
    from rectools_tpu.dataset import Dataset as JaxDataset

    df = _frame() if df is None else df
    return Dataset.construct(df), JaxDataset.construct(df)


def _jax_ranking() -> tp.Any:
    import rectools_tpu.models.ranking as jax_ranking

    return jax_ranking


GENERATORS = {
    "popular": (PopularModel, {}),
    "popular_interactions": (PopularModel, {"popularity": "n_interactions"}),
    "ease": (EASEModel, {"regularization": 10.0}),
}


def _generators(names: tp.Sequence[str], package: str, num_candidates: int = 10,
                **kwargs: tp.Any) -> tp.List[tp.Any]:
    import rectools_tpu.models as jax_models

    ranking = _jax_ranking() if package == "jax" else None
    out = []
    for name in names:
        cls, model_kwargs = GENERATORS[name]
        options = dict(num_candidates=num_candidates, keep_ranks=True, keep_scores=True, scores_fillna_value=0.0,
                       ranks_fillna_value=100.0)
        options.update(kwargs)
        if package == "port":
            out.append(CandidateGenerator(cls(**model_kwargs, device="cpu"), **options))
        else:
            out.append(ranking.CandidateGenerator(getattr(jax_models, cls.__name__)(**model_kwargs), **options))
    return out


def _pipelines(names: tp.Sequence[str] = ("popular", "ease"), reranker: tp.Callable[[], tp.Any] = LogisticRegression,
               splitter: tp.Tuple[tp.Any, ...] = ("2D", 1), sampler_seed: tp.Optional[int] = 0,
               **generator_kwargs: tp.Any) -> tp.Tuple[tp.Any, tp.Any]:
    """(the port's CandidateRankingModel, the JAX package's), the same
    configuration, each over its own package's classes."""
    import rectools_tpu.model_selection as jax_selection

    jr = _jax_ranking()
    port = CandidateRankingModel(
        candidate_generators=_generators(names, "port", **generator_kwargs),
        splitter=TimeRangeSplitter(*splitter),
        reranker=Reranker(reranker()),
        sampler=PerUserNegativeSampler(n_negatives=3, random_state=sampler_seed),
    )
    ref = jr.CandidateRankingModel(
        candidate_generators=_generators(names, "jax", **generator_kwargs),
        splitter=jax_selection.TimeRangeSplitter(*splitter),
        reranker=jr.Reranker(reranker()),
        sampler=jr.PerUserNegativeSampler(n_negatives=3, random_state=sampler_seed),
    )
    return port, ref


def _assert_frames_close(got: pd.DataFrame, ref: pd.DataFrame) -> None:
    """Same columns, row order and non-float values; float columns within
    SCORE_RTOL / SCORE_ATOL."""
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for col in got.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if np.issubdtype(a.dtype, np.floating) and not col.endswith("_rank"):
            np.testing.assert_allclose(a, b.astype(a.dtype), rtol=SCORE_RTOL, atol=SCORE_ATOL, err_msg=col)
        else:
            np.testing.assert_array_equal(a, b, err_msg=col)


# ------------------------------------------------ tests/models/ranking/test_candidate_ranking.py


class TestCandidateRankingModel:
    def test_fit_recommend(self) -> None:
        dataset, jax_dataset = _datasets()
        port, ref = _pipelines()
        port.fit(dataset)
        ref.fit(jax_dataset)
        kwargs = dict(k=5, filter_viewed=True, on_unsupported_targets="ignore")
        reco = port.recommend(np.arange(10), dataset, **kwargs)
        assert set(reco.columns) == set(Columns.Recommendations)
        for _, grp in reco.groupby(Columns.User):
            assert list(grp[Columns.Rank]) == list(range(1, len(grp) + 1))
            assert grp[Columns.Score].is_monotonic_decreasing
        ref_reco = ref.recommend(np.arange(10), jax_dataset, **kwargs)
        np.testing.assert_array_equal(reco[Columns.User], ref_reco[Columns.User])
        np.testing.assert_allclose(reco[Columns.Score], ref_reco[Columns.Score], rtol=1e-4, atol=1e-6)

    def test_train_table_has_generator_features(self) -> None:
        dataset, jax_dataset = _datasets()
        port, ref = _pipelines()
        train = port.get_train_with_targets_for_reranker(dataset)
        expected = {
            Columns.User, Columns.Item, Columns.Target,
            "PopularModel_1_rank", "PopularModel_1_score", "EASEModel_1_rank", "EASEModel_1_score",
        }
        assert expected <= set(train.columns)
        assert set(train[Columns.Target].unique()) <= {0, 1}
        _assert_frames_close(train, ref.get_train_with_targets_for_reranker(jax_dataset))

    def test_multi_fold_splitter_rejected(self) -> None:
        with pytest.raises(ValueError, match="n_splits=2"):
            CandidateRankingModel(
                candidate_generators=_generators(["popular"], "port"),
                splitter=TimeRangeSplitter("1D", 2),
                reranker=Reranker(LogisticRegression()),
            )
        with pytest.raises(ValueError, match="n_splits=2"):
            _pipelines(["popular"], splitter=("1D", 2))

    def test_generator_stage_guard(self) -> None:
        dataset, jax_dataset = _datasets()
        for gen, data in ((_generators(["popular"], "port")[0], dataset), (_generators(["popular"], "jax")[0],
                                                                           jax_dataset)):
            gen.fit(data, for_train=True)
            with pytest.raises(Exception) as info:
                gen.generate_candidates(np.arange(3), data, filter_viewed=False, for_train=False)
            assert type(info.value).__name__ == NotFittedForStageError.__name__
            assert str(info.value) == str(NotFittedForStageError("PopularModel", "recommend"))


class TestPerUserNegativeSampler:
    def test_limits_negatives_per_user(self) -> None:
        train = pd.DataFrame(
            {
                Columns.User: [1] * 10 + [2] * 2,
                Columns.Item: list(range(10)) + [0, 1],
                Columns.Target: [1, 0, 0, 0, 0, 0, 0, 0, 0, 0] + [1, 0],
            }
        )
        sampled = PerUserNegativeSampler(n_negatives=3, random_state=0).sample_negatives(train)
        counts = sampled[sampled[Columns.Target] == 0].groupby(Columns.User).size()
        assert counts.loc[1] == 3
        assert counts.loc[2] == 1  # fewer negatives than requested: keep all
        assert (sampled[Columns.Target] == 1).sum() == 2
        ref = _jax_ranking().PerUserNegativeSampler(n_negatives=3, random_state=0).sample_negatives(train)
        pd.testing.assert_frame_equal(sampled, ref)


# ------------------------------------------------ tests/models/ranking/test_catboost_reranker.py


class FakePool:
    """Records the kwargs catboost.Pool would receive."""

    def __init__(self, data, label=None, group_id=None, **kwargs):
        self.data = pd.DataFrame(data).reset_index(drop=True)
        self.label = np.asarray(label) if label is not None else None
        self.group_id = np.asarray(group_id) if group_id is not None else None
        self.extra = kwargs


class FakeRanker:
    """CatBoostRanker-shaped trainer: fit(X=Pool), predict(df)."""

    def __init__(self):
        self.fitted_pool = None

    def fit(self, X, **kwargs):
        assert isinstance(X, FakePool)
        self.fitted_pool = X

    def predict(self, data):
        return np.asarray(data["score"]) if "score" in data else np.zeros(len(data))


class FakeClassifier(FakeRanker):
    def predict_proba(self, data):
        pos = self.predict(data)
        return np.stack([1 - pos, pos], axis=1)


def _candidates_with_target() -> pd.DataFrame:
    rng = np.random.default_rng(0)
    n = 30
    return pd.DataFrame(
        {
            Columns.User: rng.integers(0, 5, n),
            Columns.Item: rng.integers(0, 10, n),
            "score": rng.random(n),
            Columns.Target: rng.integers(0, 2, n),
        }
    )


def _rerankers(model: tp.Callable[[], tp.Any], **kwargs: tp.Any) -> tp.Tuple[tp.Any, tp.Any]:
    return (CatBoostReranker(model(), pool_factory=FakePool, **kwargs),
            _jax_ranking().CatBoostReranker(model(), pool_factory=FakePool, **kwargs))


def _same_pool(got: FakePool, ref: FakePool) -> None:
    pd.testing.assert_frame_equal(got.data, ref.data)
    for a, b in ((got.label, ref.label), (got.group_id, ref.group_id)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert got.extra == ref.extra


class TestPoolConstruction:
    def test_classifier_pool_has_no_groups(self) -> None:
        port, ref = _rerankers(FakeClassifier)
        assert port.is_classifier and ref.is_classifier
        pool = port.prepare_training_pool(_candidates_with_target())
        assert pool.group_id is None
        assert set(pool.data.columns) == {"score"}  # ids and target dropped
        assert pool.label is not None and len(pool.label) == 30
        _same_pool(pool, ref.prepare_training_pool(_candidates_with_target()))

    def test_ranker_pool_grouped_and_sorted_by_user(self) -> None:
        port, ref = _rerankers(FakeRanker)
        assert not port.is_classifier
        pool = port.prepare_training_pool(_candidates_with_target())
        assert pool.group_id is not None
        assert (np.diff(pool.group_id) >= 0).all()  # user-sorted groups
        assert set(pool.data.columns) == {"score"}
        _same_pool(pool, ref.prepare_training_pool(_candidates_with_target()))

    def test_pool_kwargs_forwarded(self) -> None:
        port, ref = _rerankers(FakeRanker, pool_kwargs={"cat_features": ["score"]})
        pool = port.prepare_training_pool(_candidates_with_target())
        assert pool.extra == {"cat_features": ["score"]}
        _same_pool(pool, ref.prepare_training_pool(_candidates_with_target()))

    def test_fit_passes_pool_and_fit_kwargs(self) -> None:
        captured: tp.List[tp.Dict[str, tp.Any]] = []

        class RecordingRanker(FakeRanker):
            def fit(self, X, **kwargs):
                super().fit(X)
                captured.append(kwargs)

        port, ref = _rerankers(RecordingRanker, fit_kwargs={"verbose": False})
        port.fit(_candidates_with_target())
        ref.fit(_candidates_with_target())
        assert port.model.fitted_pool is not None
        assert captured == [{"verbose": False}, {"verbose": False}]
        _same_pool(port.model.fitted_pool, ref.model.fitted_pool)

    def test_predict_scores_dispatch(self) -> None:
        cands = _candidates_with_target().drop(columns=[Columns.Target])
        for model in (FakeClassifier, FakeRanker):
            port, ref = _rerankers(model)
            np.testing.assert_allclose(port.predict_scores(cands), cands["score"])
            np.testing.assert_array_equal(port.predict_scores(cands), ref.predict_scores(cands))

    def test_missing_catboost_without_factory_raises(self) -> None:
        assert not port_catboost.HAS_CATBOOST  # catboost is absent here, as on the card's machine
        with pytest.raises(ImportError, match="pool_factory"):
            CatBoostReranker(FakeRanker())
        with pytest.raises(ImportError, match="pool_factory"):
            _jax_ranking().CatBoostReranker(FakeRanker())


class TestTwoStageWithCatBoostContract:
    def test_end_to_end_recommend(self) -> None:
        """tests/models/data.py's frame, PopularModel's five candidates, the
        fake ranker's group-wise pool: the same recommendations in both."""
        import rectools_tpu.model_selection as jax_selection
        import rectools_tpu.models as jax_models
        from rectools_tpu.dataset import Dataset as JaxDataset

        jr = _jax_ranking()
        dataset, jax_dataset = Dataset.construct(INTERACTIONS), JaxDataset.construct(INTERACTIONS)
        port = CandidateRankingModel(
            candidate_generators=[CandidateGenerator(PopularModel(device="cpu"), 5, keep_ranks=True,
                                                     keep_scores=True)],
            splitter=LastNSplitter(n=1, n_splits=1),
            reranker=CatBoostReranker(FakeRanker(), pool_factory=FakePool),
            sampler=PerUserNegativeSampler(random_state=1),  # seeded, so that both packages draw the same rows
        )
        ref = jr.CandidateRankingModel(
            candidate_generators=[jr.CandidateGenerator(jax_models.PopularModel(), 5, keep_ranks=True,
                                                        keep_scores=True)],
            splitter=jax_selection.LastNSplitter(n=1, n_splits=1),
            reranker=jr.CatBoostReranker(FakeRanker(), pool_factory=FakePool),
            sampler=jr.PerUserNegativeSampler(random_state=1),
        )
        port.fit(dataset)
        ref.fit(jax_dataset)
        users = INTERACTIONS[Columns.User].unique()
        reco = port.recommend(users, dataset, k=3, filter_viewed=False)
        assert set(reco.columns) == set(Columns.Recommendations)
        assert (reco.groupby(Columns.User).size() <= 3).all()
        _same_pool(port.reranker.model.fitted_pool, ref.reranker.model.fitted_pool)
        pd.testing.assert_frame_equal(reco, ref.recommend(users, jax_dataset, k=3, filter_viewed=False))


# ------------------------------------------------------------------ stage by stage, end to end


def test_stages_match_jax() -> None:
    """Split, pooled candidates (outer join, fill maps), labels, the sampled
    frame and the features, stage by stage, from Popular and EASE."""
    dataset, jax_dataset = _datasets()
    port, ref = _pipelines()
    history, targets, fold = port.split_to_history_dataset_and_train_targets(dataset, port.splitter)
    jax_history, jax_targets, jax_fold = ref.split_to_history_dataset_and_train_targets(jax_dataset, ref.splitter)
    pd.testing.assert_frame_equal(history.get_raw_interactions(), jax_history.get_raw_interactions())
    pd.testing.assert_frame_equal(targets, jax_targets)
    assert fold.keys() == jax_fold.keys()

    port._fit_candidate_generators(history, for_train=True)
    ref._fit_candidate_generators(jax_history, for_train=True)
    users = targets[Columns.User].unique()
    pooled = port._pool_first_stage_candidates(users, history, filter_viewed=True, for_train=True)
    jax_pooled = ref._pool_first_stage_candidates(users, jax_history, filter_viewed=True, for_train=True)
    assert pooled["PopularModel_1_rank"].isin([100.0]).any() and pooled["EASEModel_1_rank"].isin([100.0]).any()
    _assert_frames_close(pooled, jax_pooled)

    labeled = port._label_candidates(pooled, targets)
    jax_labeled = ref._label_candidates(jax_pooled, jax_targets)
    np.testing.assert_array_equal(labeled[Columns.Target], jax_labeled[Columns.Target])
    assert 0 < labeled[Columns.Target].sum() < len(labeled)

    sampled = port.sampler.sample_negatives(labeled)
    jax_sampled = ref.sampler.sample_negatives(jax_labeled)
    np.testing.assert_array_equal(sampled.index, jax_sampled.index)
    _assert_frames_close(sampled, jax_sampled)

    featured = port.feature_collector.collect_features(sampled, history, fold)
    _assert_frames_close(featured, ref.feature_collector.collect_features(jax_sampled, jax_history, jax_fold))


def test_labels_probe_membership_once_per_candidate() -> None:
    """The documented deviation from the reference: duplicate target rows
    label a candidate once (no repeated positives), in both packages."""
    candidates = pd.DataFrame({Columns.User: [1, 1, 2, 2], Columns.Item: [10, 11, 10, 12], "f": [0.1, 0.2, 0.3, 0.4]})
    targets = pd.DataFrame({Columns.User: [1, 1, 1, 2], Columns.Item: [10, 10, 13, 12], Columns.Weight: 1.0})
    labeled = CandidateRankingModel._label_candidates(candidates, targets)
    assert labeled[Columns.Target].tolist() == [1, 0, 0, 1]
    pd.testing.assert_frame_equal(labeled, _jax_ranking().CandidateRankingModel._label_candidates(candidates, targets))


@pytest.mark.parametrize("reranker", ["logistic", "fixed"])
def test_end_to_end_matches_jax(reranker: str) -> None:
    """``logistic``: two PopularModel generators (exact counts) and
    sklearn's LogisticRegression: identical features, so identical
    recommendations. ``fixed``: Popular and EASE, the reranker a fixed
    function of Popular's exact rank feature: identical recommendations."""
    dataset, jax_dataset = _datasets()
    if reranker == "logistic":
        port, ref = _pipelines(["popular", "popular_interactions"])
    else:
        class ByPopularRank(FakeClassifier):
            def fit(self, X, y=None, **kwargs):
                self.fitted_pool = X

            def predict(self, data):
                return 1.0 / data["PopularModel_1_rank"].to_numpy()

        port, ref = _pipelines(["popular", "ease"], reranker=ByPopularRank)
    port.fit(dataset)
    ref.fit(jax_dataset)
    users = np.arange(0, 50, 3)
    for kwargs in (dict(k=5, filter_viewed=True), dict(k=8, filter_viewed=False, items_to_recommend=np.arange(20))):
        reco = port.recommend(users, dataset, **kwargs)
        pd.testing.assert_frame_equal(reco, ref.recommend(users, jax_dataset, **kwargs))
        assert len(reco) > 0


def test_serving_refit_rule_and_context_warning() -> None:
    """Generators fitted only for the train stage are refitted on the full
    dataset before serving, as in JAX; ``context`` is warned about and
    ignored; ``force_fit_candidate_generators`` refits."""
    dataset, jax_dataset = _datasets()
    port, ref = _pipelines(["popular"])
    for model, data in ((port, dataset), (ref, jax_dataset)):
        model.fit(data, refit_candidate_generators=False)
        gen = next(iter(model.cand_gen_dict.values()))
        assert gen.is_fitted_for_train and not gen.is_fitted_for_recommend
        context = pd.DataFrame({Columns.User: [0], Columns.Datetime: [pd.Timestamp("2021-02-01")]})
        with pytest.warns(UserWarning, match="ignores `context`"):
            model.recommend([0, 1], data, k=3, filter_viewed=True, context=context)
        assert gen.is_fitted_for_recommend and not gen.is_fitted_for_train
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = port.recommend(np.arange(20), dataset, k=4, filter_viewed=True, force_fit_candidate_generators=True)
    pd.testing.assert_frame_equal(got, ref.recommend(np.arange(20), jax_dataset, k=4, filter_viewed=True,
                                                     force_fit_candidate_generators=True))


def test_feature_collector_hooks_join_like_jax() -> None:
    class Collector(CandidateFeatureCollector):
        def _get_user_features(self, users, dataset, fold_info):
            return pd.DataFrame({Columns.User: users, "user_len": np.asarray(users) % 4})

        def _get_item_features(self, items, dataset, fold_info):
            return pd.DataFrame({Columns.Item: items, "item_parity": np.asarray(items) % 2})

    jax_base = _jax_ranking().CandidateFeatureCollector

    class JaxCollector(jax_base):
        _get_user_features = Collector._get_user_features
        _get_item_features = Collector._get_item_features

    dataset, jax_dataset = _datasets()
    useritem = pd.DataFrame({Columns.User: [3, 1, 3, 2], Columns.Item: [5, 5, 7, 9]})
    got = Collector().collect_features(useritem, dataset, None)
    assert list(got.columns) == [Columns.User, Columns.Item, "user_len", "item_parity"]
    pd.testing.assert_frame_equal(got, JaxCollector().collect_features(useritem, jax_dataset, None))


def test_save_load_model_recommends_the_same(tmp_path: tp.Any) -> None:
    dataset, _ = _datasets()
    port, _ = _pipelines()
    port.fit(dataset)
    port.save(tmp_path / "two_stage.pkl")
    reloaded = load_model(tmp_path / "two_stage.pkl")
    assert type(reloaded) is CandidateRankingModel
    kwargs = dict(k=5, filter_viewed=True)
    pd.testing.assert_frame_equal(reloaded.recommend(np.arange(30), dataset, **kwargs),
                                  port.recommend(np.arange(30), dataset, **kwargs))
