"""The port's model selection (``rectools_tpu_torch.model_selection``) held
against the JAX package's on the same seeded frame.

The splitters' folds (train and test row indexes, and the fold statistics)
equal the JAX splitters' for every filter setting; ``get_not_seen_mask``
equals JAX's. ``cross_validate`` with tiny port models on ``device="cpu"``
(SASRec, and HSTU with its recommend context) gives, fold by fold, the metrics
of the same loop written by hand: split, ``fit``, ``recommend``,
``calc_metrics``. The fits run on one CPU thread so that two fits of one fold
give the same bits (see ``tests/test_torch_training.py::one_thread``).
"""

import itertools
import typing as tp

import numpy as np
import pandas as pd
import pytest
import torch

import rectools_tpu.model_selection as jms
from rectools_tpu.dataset import Dataset as JaxDataset
import rectools_tpu_torch.model_selection as pms
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.dataset.context import get_context
from rectools_tpu_torch.metrics import MAP, NDCG, CatalogCoverage, MeanInvUserFreq, Recall, SufficientReco, calc_metrics
from rectools_tpu_torch.models import HSTUModel, SASRecModel

TINY = dict(n_blocks=1, n_heads=2, n_factors=16, session_max_len=10, batch_size=64, epochs=1, seed=3, device="cpu")
K = 5


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(17)
    n = 3000
    return pd.DataFrame(
        {
            Columns.User: rng.integers(0, 150, n),
            Columns.Item: rng.zipf(1.3, n) % 120,
            Columns.Weight: 1.0,
            Columns.Datetime: pd.Timestamp("2021-03-01") + pd.to_timedelta(rng.integers(0, 10 * 86400, n), unit="s"),
        }
    ).astype({Columns.Datetime: "datetime64[ns]"})


FRAME = _frame()
FILTERS = list(itertools.product([True, False], repeat=3))


def _splitters(mod) -> tp.Dict[str, tp.Callable[..., tp.Any]]:
    return {
        "time_1d_x3": lambda **f: mod.TimeRangeSplitter("1D", 3, **f),
        "time_12h_x2": lambda **f: mod.TimeRangeSplitter("12H", 2, **f),
        "last_1_x2": lambda **f: mod.LastNSplitter(1, 2, **f),
        "last_3": lambda **f: mod.LastNSplitter(3, **f),
        "random_x3": lambda **f: mod.RandomSplitter(0.1, 3, random_state=5, **f),
    }


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: "cu{}_ci{}_seen{}".format(*map(int, f)))
@pytest.mark.parametrize("name", sorted(_splitters(pms)))
def test_splitter_folds_match_jax(name: str, filters: tp.Tuple[bool, bool, bool]) -> None:
    kwargs = dict(zip(("filter_cold_users", "filter_cold_items", "filter_already_seen"), filters))
    port_folds = list(_splitters(pms)[name](**kwargs).split(Dataset.construct(FRAME).interactions, True))
    jax_folds = list(_splitters(jms)[name](**kwargs).split(JaxDataset.construct(FRAME).interactions, True))
    assert len(port_folds) == len(jax_folds) > 0
    for (train, test, info), (jtrain, jtest, jinfo) in zip(port_folds, jax_folds):
        np.testing.assert_array_equal(train, jtrain)
        np.testing.assert_array_equal(test, jtest)
        assert info == jinfo
        assert len(test) > 0


def test_get_not_seen_mask_matches_jax() -> None:
    rng = np.random.default_rng(2)
    args = [rng.integers(0, 20, size=n) for n in (300, 300, 200, 200)]
    np.testing.assert_array_equal(pms.get_not_seen_mask(*args), jms.get_not_seen_mask(*args))


def test_public_names_are_the_jax_packages() -> None:
    assert set(pms.__all__) == set(jms.__all__)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


METRICS = {
    "recall": Recall(k=K),
    "ndcg": NDCG(k=K),
    "map": MAP(k=K),
    "miuf": MeanInvUserFreq(k=K),
    "coverage": CatalogCoverage(k=K),
    "sufficient": SufficientReco(k=K),
}


def _by_hand(dataset: Dataset, splitter, models: tp.Dict[str, tp.Any]) -> tp.List[tp.Dict[str, tp.Any]]:
    """split -> fit -> recommend -> calc_metrics, written out."""
    rows = []
    for train_rows, test_rows, info in splitter.split(dataset.interactions, collect_fold_stats=True):
        train = dataset.filter_interactions(train_rows, keep_external_ids=True)
        test = dataset.interactions.df.loc[test_rows].copy()
        test[Columns.User] = dataset.user_id_map.convert_to_external(test[Columns.User])
        test[Columns.Item] = dataset.item_id_map.convert_to_external(test[Columns.Item])
        history = train.get_raw_interactions()
        for name, model in models.items():
            context = get_context(test) if model.require_recommend_context else None
            reco = model.fit(train).recommend(test[Columns.User].unique(), train, k=K, filter_viewed=True,
                                              context=context)
            values = calc_metrics(METRICS, reco, test, history, history[Columns.Item].unique())
            rows.append({"model": name, "i_split": info["i_split"], **values})
    return rows


@pytest.mark.parametrize("family", ["sasrec", "hstu"])
def test_cross_validate_equals_the_loop_by_hand(family: str, one_thread) -> None:
    dataset = Dataset.construct(FRAME)
    build = {"sasrec": lambda: SASRecModel(**TINY), "hstu": lambda: HSTUModel(**TINY)}[family]
    splitter = pms.TimeRangeSplitter("1D", 2)
    got = pms.cross_validate(dataset, splitter, METRICS, {family: build()}, k=K, filter_viewed=True)
    expected = _by_hand(dataset, splitter, {family: build()})
    assert [info["i_split"] for info in got["splits"]] == [0, 1]
    assert len(got["metrics"]) == len(expected) == 2
    for row, ref in zip(got["metrics"], expected):
        assert row == ref  # the same floats: every fit and recommend gives the same bits
        assert 0 < row["recall"] <= 1 and row["sufficient"] > 0


def test_cross_validate_splits_match_jax_splitter() -> None:
    """cross_validate reports the JAX splitter's fold statistics; its
    reference-model path scores intersections against the reference."""
    dataset = Dataset.construct(FRAME)
    splitter = pms.LastNSplitter(1, 2)
    models = {"ref": SASRecModel(**TINY), "other": SASRecModel(**{**TINY, "seed": 4})}
    from rectools_tpu_torch.metrics import Intersection

    got = pms.cross_validate(dataset, splitter, {"recall": Recall(k=K), "inter": Intersection(k=K)}, models, k=K,
                             filter_viewed=True, ref_models=["ref"])
    jax_infos = [info for _, _, info in jms.LastNSplitter(1, 2).split(JaxDataset.construct(FRAME).interactions, True)]
    assert got["splits"] == jax_infos
    assert [row["model"] for row in got["metrics"]] == ["other", "other"]
    assert all(0 <= row["inter_ref"] <= 1 for row in got["metrics"])
