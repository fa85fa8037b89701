"""The port's heuristic and linear-algebra models (Popular,
PopularInCategory, Random, EASE, PureSVD, ItemKNN) held against the JAX
package's on the CPU, on tests/models/data.py's dataset ("tiny") and on a
seeded 300-user frame ("seeded").

Tolerances: fitted popularity lists, category lists, item ids and the plain
kNN co-counts equal; EASE weights and the weighted kNN similarities within
1e-5 of their largest entry (f32 sums in another order), with the kNN
support equal; PureSVD by its reconstruction (1e-4 of the largest entry) and
singular values (1e-4 relative), since eigenvector signs are free. Served
from JAX's own fitted arrays (``models/convert.py``): identical items and
ranks, scores within 1e-5 relative; RandomModel there draws JAX's own
uniform blocks. RandomModel's own draws: properties (no seen item, no
repeat, scores n..1, a chi-square bound over 2,000 draws, repeatability).
"""

import pickle
import typing as tp

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import stats

import rectools_tpu_torch.models.random as port_random
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import (
    EASEModel,
    ImplicitItemKNNWrapperModel,
    ItemKNNModel,
    PopularInCategoryModel,
    PopularModel,
    PureSVDModel,
    RandomModel,
    model_from_config,
)
from rectools_tpu_torch.models.convert import fitted_arrays, load_fitted_arrays
from rectools_tpu_torch.models.item_knn import _truncate_topk_rows
from rectools_tpu_torch.ops.topk_select import FALLBACKS

from .models.data import INTERACTIONS

FRAMES = ("tiny", "seeded")  # the seeded frame: 300 users, 120 items, integer weights 1-5
# name: (port class, its keyword arguments); the JAX class has the same name
MODELS = {
    "popular": (PopularModel, {}),
    "popular_in_category": (PopularInCategoryModel, {"category_feature": "genre"}),
    "random": (RandomModel, {"random_state": 3}),
    "ease": (EASEModel, {"regularization": 50.0}),
    "pure_svd": (PureSVDModel, {"factors": 3}),
    "item_knn_plain": (ItemKNNModel, {"K": 4, "variant": "plain"}),
    "item_knn_cosine": (ItemKNNModel, {"K": 4, "variant": "cosine"}),
    "item_knn_tfidf": (ItemKNNModel, {"K": 4, "variant": "tfidf"}),
    "item_knn_bm25": (ItemKNNModel, {"K": 4, "variant": "bm25"}),
}
SIX = ("popular", "popular_in_category", "random", "ease", "pure_svd", "item_knn_plain")
COLD_USER = 10**6  # an external id no frame holds
WARM_USER = 10**6 + 1  # a user with features and no interactions


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: the iterative solvers run hundreds of
    small ops, and with other test workers holding the cores each parallel
    region waits for its slowest thread, which turns seconds into minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _interactions(frame: str) -> pd.DataFrame:
    if frame == "tiny":
        return INTERACTIONS
    rng = np.random.default_rng(16)
    n = 3000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 300, n),
        Columns.Item: (rng.zipf(1.3, n) * 7) % 120,
        Columns.Weight: rng.integers(1, 6, n).astype(float),  # integer weights: plain kNN co-counts tie
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    })
    return df.drop_duplicates([Columns.User, Columns.Item]).astype({Columns.Datetime: "datetime64[ns]"})


def _item_features(df: pd.DataFrame) -> pd.DataFrame:
    items = np.unique(df[Columns.Item])
    return pd.DataFrame({"id": items, "feature": "genre", "value": items % 4})


def _user_features(df: pd.DataFrame) -> pd.DataFrame:
    """One categorical feature for every user and for WARM_USER, who has no
    interactions."""
    users = np.append(np.unique(df[Columns.User]), WARM_USER)
    return pd.DataFrame({"id": users, "feature": "segment", "value": users % 3})


def _datasets(frame: str, name: str) -> tp.Tuple[tp.Any, tp.Any]:
    """(the port's Dataset, the JAX package's) from the same frames."""
    from rectools_tpu.dataset import Dataset as JaxDataset

    df = _interactions(frame)
    kwargs = {"user_features_df": _user_features(df), "cat_user_features": ["segment"]}
    if name == "popular_in_category":
        kwargs.update(item_features_df=_item_features(df), cat_item_features=["genre"])
    return Dataset.construct(df, **kwargs), JaxDataset.construct(df, **kwargs)


def _models(name: str) -> tp.Tuple[tp.Any, tp.Any]:
    import rectools_tpu.models as jax_models

    cls, kwargs = MODELS[name]
    return cls(**kwargs, device="cpu"), getattr(jax_models, cls.__name__)(**kwargs)


class _JaxKeyChain:
    """Stands in for ``uniform_draws`` in the port's random module: every call
    takes the JAX model's next key (``_next_key``) and draws JAX's block for
    it, so the port's RandomModel ranks on JAX's own numbers (catalogs and
    whitelists under 128 items, one batch a call: the port's padded width is
    then JAX's)."""

    def __init__(self, jax_model: tp.Any) -> None:
        self.key = jax_model._key

    def __call__(self, generator: torch.Generator) -> tp.Callable[[int, tp.Tuple[int, int]], torch.Tensor]:
        import jax
        import jax.numpy as jnp

        from rectools_tpu.ops.topk import _next_pow2

        self.key, sub = jax.random.split(self.key)
        key = jax.random.split(sub, 1)[0]

        def draw(bi: int, shape: tp.Tuple[int, int]) -> torch.Tensor:
            assert bi == 0 and shape[1] == 128, shape
            block = jax.random.uniform(key, (_next_pow2(shape[0], minimum=8), 128), dtype=jnp.float32)
            return torch.from_numpy(np.array(block)[: shape[0]])

        return draw


def _assert_reco_equal(got: pd.DataFrame, expected: pd.DataFrame) -> None:
    got, expected = got.reset_index(drop=True), expected.reset_index(drop=True)
    assert list(got.columns) == list(expected.columns)
    assert len(got) == len(expected)
    for column in got.columns:
        if column == Columns.Score:
            np.testing.assert_allclose(got[column].to_numpy(), expected[column].to_numpy(), rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(got[column].to_numpy(), expected[column].to_numpy(), err_msg=column)


# ------------------------------------------------------------------ fit


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fitted_arrays_match_jax(name: str, frame: str) -> None:
    dataset, jax_dataset = _datasets(frame, name)
    port, jax_model = _models(name)
    port.fit(dataset)
    jax_model.fit(jax_dataset)
    if name == "popular":
        for got, expected in zip(port.popularity_list, jax_model.popularity_list):
            np.testing.assert_array_equal(got, expected)
    elif name == "popular_in_category":
        assert port.category_columns == jax_model.category_columns
        pd.testing.assert_series_equal(port.category_scores, jax_model.category_scores)
        for attr in ("_cat_items", "_cat_item_scores"):
            for got, expected in zip(getattr(port, attr), getattr(jax_model, attr), strict=True):
                np.testing.assert_array_equal(got, expected)
    elif name == "random":
        np.testing.assert_array_equal(port.all_item_ids, jax_model.all_item_ids)
    elif name == "ease":
        assert port.weight.dtype == np.float32 and not np.diag(port.weight).any()
        np.testing.assert_allclose(port.weight, jax_model.weight, rtol=0, atol=1e-5 * np.abs(jax_model.weight).max())
    elif name == "pure_svd":
        recon, expected = port.user_factors @ port.item_factors.T, jax_model.user_factors @ jax_model.item_factors.T
        np.testing.assert_allclose(recon, expected, rtol=0, atol=1e-4 * np.abs(expected).max())
        sigma = np.linalg.norm(port.item_factors, axis=0)
        np.testing.assert_allclose(sigma, np.linalg.norm(jax_model.item_factors, axis=0), rtol=1e-4)
        assert np.all(np.diff(sigma) <= 0)
    else:
        got, expected = port.similarity, jax_model.similarity
        assert got.dtype == np.float32 and ((got != 0).sum(axis=1) <= port.K).all()
        np.testing.assert_array_equal(got != 0, expected != 0)
        if port.variant == "plain":
            np.testing.assert_array_equal(got, expected)
        else:
            np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5 * np.abs(expected).max())


# ------------------------------------------------------------------ serving from JAX's fitted arrays


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_serving_from_jax_fitted_arrays_matches_jax(name: str, frame: str, monkeypatch) -> None:
    dataset, jax_dataset = _datasets(frame, name)
    port, jax_model = _models(name)
    jax_model.fit(jax_dataset)
    load_fitted_arrays(port, fitted_arrays(jax_model))
    if name == "random":
        monkeypatch.setattr(port_random, "uniform_draws", _JaxKeyChain(jax_model))
    users = np.unique(_interactions(frame)[Columns.User])
    items = np.unique(_interactions(frame)[Columns.Item])
    whitelist = items[::2]
    hot_warm_cold = np.append(users[:5], [WARM_USER, COLD_USER])
    calls = [
        ("recommend", dict(users=users, k=3, filter_viewed=True)),
        ("recommend", dict(users=users, k=3, filter_viewed=False)),
        ("recommend", dict(users=users, k=3, filter_viewed=True, items_to_recommend=whitelist)),
        ("recommend", dict(users=hot_warm_cold, k=3, filter_viewed=True, on_unsupported_targets="ignore")),
        ("recommend_to_items", dict(target_items=items, k=3)),
        ("recommend_to_items", dict(target_items=items[:4], k=2, items_to_recommend=whitelist, filter_itself=False)),
    ]
    for method, kwargs in calls:
        got = getattr(port, method)(dataset=dataset, **kwargs)
        expected = getattr(jax_model, method)(dataset=jax_dataset, **kwargs)
        assert len(got) > 0, (method, kwargs)
        _assert_reco_equal(got, expected)
    if port.recommends_for_cold:  # the others drop both
        served = set(port.recommend(hot_warm_cold, dataset, 3, True, on_unsupported_targets="ignore")[Columns.User])
        assert {WARM_USER, COLD_USER} <= served


@pytest.mark.parametrize("name", ["ease", "popular"])
def test_load_fitted_arrays_checks_names_shapes_and_dtypes(name: str) -> None:
    port, _ = _models(name)
    bad = {
        "ease": [{"weight": np.zeros((3, 4), np.float32)}, {"weight": np.zeros((3, 3), np.float64)}, {"w": None}],
        "popular": [{"popularity_list": (np.arange(3), np.ones(2))},
                    {"popularity_list": (np.arange(3.0), np.ones(3))}],
    }[name]
    for arrays in bad:
        with pytest.raises(ValueError, match="load_fitted_arrays"):
            load_fitted_arrays(port, arrays)
    assert not port.is_fitted


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_round_trip_and_jax_config(name: str) -> None:
    port, jax_model = _models(name)
    config = port.get_config()
    assert config["device"] == "cpu" and config["cls"] is type(port)
    assert type(port).from_config(config).get_config() == config
    assert model_from_config(port.get_config(simple_types=True)).get_config() == config
    # a JAX config (class by its short name, no device) loads into the port class
    jax_config = jax_model.get_config(simple_types=True)
    loaded = model_from_config({**jax_config, "device": "cpu"})
    assert type(loaded) is type(port)
    assert {k: v for k, v in loaded.get_config(simple_types=True).items() if k != "device"} == jax_config


@pytest.mark.parametrize("name", SIX)
def test_dumps_loads_keep_the_fitted_model(name: str) -> None:
    dataset, _ = _datasets("seeded", name)
    port, _ = _models(name)
    port.fit(dataset)
    users = np.unique(_interactions("seeded")[Columns.User])
    restored = pickle.loads(pickle.dumps(port))
    _assert_reco_equal(restored.recommend(users, dataset, 3, True), port.recommend(users, dataset, 3, True))


def test_reference_alias_and_class_names() -> None:
    assert ImplicitItemKNNWrapperModel is ItemKNNModel
    assert type(model_from_config({"cls": "ImplicitItemKNNWrapperModel", "device": "cpu"})) is ItemKNNModel


@pytest.mark.parametrize("name", ["ease", "pure_svd"])
def test_mesh_shape_stays_in_the_config_and_fit_refuses_it(name: str) -> None:
    cls, kwargs = MODELS[name]
    model = cls(**kwargs, mesh_shape=(2, 2), device="cpu")
    assert cls.from_config(model.get_config()).mesh_shape == (2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 6"):
        model.fit(_datasets("tiny", name)[0])


@pytest.mark.parametrize("name", SIX)
def test_default_device_is_the_card(name: str) -> None:
    cls, kwargs = MODELS[name]
    if torch.cuda.is_available():
        assert cls(**kwargs).get_config()["device"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cls(**kwargs)


# ------------------------------------------------------------------ RandomModel's own draws


def test_random_model_draws_are_uniform() -> None:
    """2,000 users each draw one of 20 items: the counts pass a chi-square
    test at 0.1% (19 degrees of freedom)."""
    n_items, n_users = 20, 2000
    df = pd.DataFrame({Columns.User: np.arange(n_users), Columns.Item: np.arange(n_users) % n_items,
                       Columns.Weight: 1.0, Columns.Datetime: pd.Timestamp("2021-01-01")})
    dataset = Dataset.construct(df)
    reco = RandomModel(random_state=11, device="cpu").fit(dataset).recommend(np.arange(n_users), dataset, 1, False)
    counts = np.bincount(reco[Columns.Item], minlength=n_items)
    assert counts.sum() == n_users
    assert stats.chisquare(counts).statistic < stats.chi2.ppf(0.999, n_items - 1)


def test_random_model_properties_and_repeatability() -> None:
    dataset, _ = _datasets("seeded", "random")
    users = np.unique(_interactions("seeded")[Columns.User])
    k = 10
    model = RandomModel(random_state=5, device="cpu").fit(dataset)
    first = model.recommend(users, dataset, k, filter_viewed=True)
    seen = set(zip(*(_interactions("seeded")[c] for c in (Columns.User, Columns.Item))))
    assert not seen & set(zip(first[Columns.User], first[Columns.Item]))
    for _, rows in first.groupby(Columns.User):
        assert rows[Columns.Item].is_unique
        np.testing.assert_array_equal(rows[Columns.Score], np.arange(len(rows), 0, -1))
        assert len(rows) == k
    second = model.recommend(users, dataset, k, filter_viewed=True)
    assert not first.equals(second)  # the generator moves on
    _assert_reco_equal(RandomModel(random_state=5, device="cpu").fit(dataset).recommend(users, dataset, k, True), first)
    _assert_reco_equal(model.fit(dataset).recommend(users, dataset, k, True), first)  # fit resets the generator


# ------------------------------------------------------------------ ItemKNN's ties


@pytest.mark.parametrize("case", ["integer_ties", "distinct"])
def test_item_knn_truncation_keeps_jax_indices(case: str) -> None:
    """Top-K rows of a co-count matrix with many ties keep ``lax.top_k``'s
    lowest-index-first order, from the grouped selection alone: no block is
    sorted again."""
    import jax.numpy as jnp

    from rectools_tpu.models.item_knn import _truncate_topk_rows as jax_truncate

    rng = np.random.default_rng(4)
    if case == "integer_ties":
        x = (rng.random((200, 300)) < 0.02).astype(np.float32)
        s = x.T @ x
    else:
        s = rng.normal(size=(300, 300)).astype(np.float32)
    expected = np.asarray(jax_truncate(jnp.asarray(s), 6))
    before = FALLBACKS["exact_top_k"]
    got = _truncate_topk_rows(torch.tensor(s), 6, block_rows=64)
    np.testing.assert_array_equal(got.numpy(), expected)
    assert FALLBACKS["exact_top_k"] == before  # six candidates a group: the certificate cannot fail
