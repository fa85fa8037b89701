"""The port's metrics (``rectools_tpu_torch.metrics``) held against the JAX
package's (``rectools_tpu.metrics``) on the same seeded frames.

Every metric class, its debiased and AUC variants included, is scored with
``calc`` and ``calc_per_user`` by both packages on seven frames (random, the
edge-case frames of ``tests/metrics/test_edge_cases.py``, an empty
recommendation table, empty ground truth) and through ``calc_metrics``:
counts (catalog coverage, covered users) are held exactly, floats to 1e-12
relative with NaN where JAX has NaN; an input JAX refuses must raise the same
exception type in the port. The port's doctests run too.
"""

import doctest
import importlib
import inspect
import typing as tp

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

import rectools_tpu.metrics as jm
from rectools_tpu import Columns as JaxColumns
from rectools_tpu.dataset import IdMap as JaxIdMap
from rectools_tpu.dataset import SparseFeatures as JaxSparseFeatures
from rectools_tpu.utils import array_ops as jax_array_ops
import rectools_tpu_torch.metrics as pm
from rectools_tpu_torch import Columns
from rectools_tpu_torch.dataset import IdMap, SparseFeatures
from rectools_tpu_torch.utils import array_ops

RTOL = 1e-12
K = 5
N_ITEMS = 40

assert JaxColumns.User == Columns.User and JaxColumns.Item == Columns.Item


def _random_frames(seed: int) -> tp.Dict[str, tp.Any]:
    """Recommendations (some users short of k, one repeated item), test
    interactions (some users without recommendations), history, catalog and
    item features from one seed."""
    rng = np.random.default_rng(seed)
    rows = []
    for user in range(60):
        n = int(rng.integers(1, K + 3))
        items = rng.choice(N_ITEMS, size=n, replace=False)
        if user % 13 == 0 and n > 1:
            items[1] = items[0]  # a repeated item for UnrepeatedReco
        rows += [[user, int(item), rank + 1, float(rng.random())] for rank, item in enumerate(items)]
    reco = pd.DataFrame(rows, columns=[Columns.User, Columns.Item, Columns.Rank, Columns.Score])
    test_users = rng.integers(20, 75, size=150)  # users 60-74 got no recommendations
    interactions = pd.DataFrame(
        {Columns.User: test_users, Columns.Item: rng.zipf(1.5, 150) % N_ITEMS}
    ).drop_duplicates(ignore_index=True)
    prev = pd.DataFrame(
        {Columns.User: rng.integers(0, 90, size=600), Columns.Item: rng.zipf(1.3, 600) % (N_ITEMS + 10)}
    )
    ref_reco = reco.sample(frac=0.7, random_state=seed).reset_index(drop=True)
    return {
        "reco": reco,
        "interactions": interactions,
        "prev_interactions": prev,
        "catalog": np.arange(N_ITEMS + 10),
        "ref_reco": ref_reco,
    }


def _edge_frames() -> tp.Dict[str, tp.Any]:
    """``tests/metrics/test_edge_cases.py``'s RECO / INTER: a user in the
    ground truth only, a user in the recommendations only, k beyond a list."""
    reco = pd.DataFrame(
        [[1, 10, 1], [1, 11, 2], [2, 10, 1], [3, 12, 1]], columns=[Columns.User, Columns.Item, Columns.Rank]
    )
    inter = pd.DataFrame([[1, 10], [1, 12], [2, 99], [4, 10]], columns=[Columns.User, Columns.Item])
    prev = pd.DataFrame([[1, 10], [2, 10], [3, 10], [1, 12], [4, 11]], columns=[Columns.User, Columns.Item])
    return {"reco": reco, "interactions": inter, "prev_interactions": prev, "catalog": np.arange(100), "ref_reco": reco}


def _frames(reco_rows: list, inter_rows: list) -> tp.Dict[str, tp.Any]:
    """The edge frames' history and catalog around other recommendations and
    ground truth."""
    reco = pd.DataFrame(reco_rows, columns=[Columns.User, Columns.Item, Columns.Rank])
    inter = pd.DataFrame(inter_rows, columns=[Columns.User, Columns.Item])
    return {**_edge_frames(), "reco": reco, "interactions": inter, "ref_reco": reco}


def _scenarios() -> tp.Dict[str, tp.Dict[str, tp.Any]]:
    random = _random_frames(7)
    return {
        "random": random,
        "edge": _edge_frames(),
        "empty_reco": {**random, "reco": random["reco"].iloc[:0]},
        "empty_truth": {**random, "interactions": random["interactions"].iloc[:0]},
        # TestKLargerThanList / TestRankingEdge of tests/metrics/test_edge_cases.py
        "rank_beyond_k": _frames([[1, 12, 3]], [[1, 12]]),
        "first_relevant_second": _frames([[1, 10, 1], [1, 11, 2], [1, 12, 3]], [[1, 11], [1, 12]]),
        "more_relevant_than_k": _frames([[1, 10, 1]], [[1, 10], [1, 11], [1, 12]]),
    }


SCENARIOS = _scenarios()


def _features_df() -> pd.DataFrame:
    rng = np.random.default_rng(3)
    return pd.DataFrame(rng.integers(0, 3, size=(N_ITEMS, 4)), index=np.arange(N_ITEMS), columns=list("abcd"))


def _sparse_calculator(mod, features_cls, id_map_cls):
    values = sparse.csr_matrix(_features_df().to_numpy()[: N_ITEMS - 5])  # the last 5 items have no features
    features = features_cls(values=values, names=tuple(("f", i) for i in range(values.shape[1])))
    return mod.SparsePairwiseHammingDistanceCalculator(features, id_map_cls.from_values(np.arange(N_ITEMS)))


# name -> a function of the metrics module (and extra constructor arguments) that builds the metric
METRICS: tp.Dict[str, tp.Callable[..., tp.Any]] = {
    "precision": lambda m, **kw: m.Precision(k=K, **kw),
    "precision_r": lambda m, **kw: m.Precision(k=K, r_precision=True, **kw),
    "recall": lambda m, **kw: m.Recall(k=K, **kw),
    "f1beta": lambda m, **kw: m.F1Beta(k=K, beta=0.5, **kw),
    "hitrate": lambda m, **kw: m.HitRate(k=3, **kw),
    "accuracy": lambda m, **kw: m.Accuracy(k=K, **kw),
    "mcc": lambda m, **kw: m.MCC(k=K, **kw),
    "map": lambda m, **kw: m.MAP(k=K, **kw),
    "map_divide_by_k": lambda m, **kw: m.MAP(k=K, divide_by_k=True, **kw),
    "ndcg": lambda m, **kw: m.NDCG(k=K, **kw),
    "ndcg_log3_achievable": lambda m, **kw: m.NDCG(k=K, log_base=3, divide_by_achievable=True, **kw),
    "mrr": lambda m, **kw: m.MRR(k=K, **kw),
    "partial_auc": lambda m, **kw: m.PartialAUC(k=K, **kw),
    "partial_auc_exclude": lambda m, **kw: m.PartialAUC(k=K, insufficient_handling="exclude", **kw),
    "pap": lambda m, **kw: m.PAP(k=K, **kw),
    "miuf": lambda m: m.MeanInvUserFreq(k=K),
    "arp": lambda m: m.AvgRecPopularity(k=K),
    "arp_normalized": lambda m: m.AvgRecPopularity(k=K, normalize=True),
    "serendipity": lambda m: m.Serendipity(k=K),
    "catalog_coverage": lambda m: m.CatalogCoverage(k=K),
    "catalog_coverage_normalized": lambda m: m.CatalogCoverage(k=K, normalize=True),
    "ild_dense": lambda m: m.IntraListDiversity(k=K, distance_calculator=m.PairwiseHammingDistanceCalculator(
        _features_df())),
    "ild_sparse": lambda m: m.IntraListDiversity(k=K, distance_calculator=_sparse_calculator(
        m, *((SparseFeatures, IdMap) if m is pm else (JaxSparseFeatures, JaxIdMap)))),
    "sufficient_reco": lambda m: m.SufficientReco(k=K),
    "sufficient_reco_deep": lambda m: m.SufficientReco(k=K, deep=True),
    "unrepeated_reco": lambda m: m.UnrepeatedReco(k=K),
    "covered_users": lambda m: m.CoveredUsers(k=K),
    "intersection": lambda m: m.Intersection(k=K),
    "intersection_ref_k": lambda m: m.Intersection(k=K, ref_k=3),
}
DEBIASED = ("precision", "recall", "f1beta", "hitrate", "accuracy", "mcc", "map", "ndcg", "mrr", "partial_auc", "pap")
for _name in DEBIASED:
    METRICS[f"{_name}_debiased"] = lambda m, build=METRICS[_name]: build(
        m, debias_config=m.DebiasConfig(iqr_coef=1.0, random_state=32))
COUNT_METRICS = {"catalog_coverage", "covered_users"}


def _call(fn: tp.Callable, frames: tp.Dict[str, tp.Any]) -> tp.Any:
    params = inspect.signature(fn).parameters
    return fn(**{name: frames[name] for name in params if name in frames})


def _outcome(fn: tp.Callable) -> tp.Tuple[str, tp.Any]:
    try:
        return "value", fn()
    except Exception as exc:  # noqa: BLE001 - the port must raise what JAX raises
        return "raised", type(exc).__name__


def _assert_float_equal(got: tp.Any, ref: tp.Any, exact: bool) -> None:
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name: str, scenario: str) -> None:
    frames = SCENARIOS[scenario]
    port_metric, jax_metric = METRICS[name](pm), METRICS[name](jm)
    assert type(port_metric).__name__ == type(jax_metric).__name__
    got_kind, got = _outcome(lambda: _call(port_metric.calc, frames))
    ref_kind, ref = _outcome(lambda: _call(jax_metric.calc, frames))
    assert (got_kind, got if got_kind == "raised" else None) == (ref_kind, ref if ref_kind == "raised" else None)
    if ref_kind == "value":
        _assert_float_equal(got, ref, exact=name in COUNT_METRICS)
    if hasattr(jax_metric, "calc_per_user"):
        got_kind, got = _outcome(lambda: _call(port_metric.calc_per_user, frames))
        ref_kind, ref = _outcome(lambda: _call(jax_metric.calc_per_user, frames))
        assert got_kind == ref_kind
        if ref_kind == "value":
            assert got.index.equals(ref.index)
            _assert_float_equal(got.to_numpy(), ref.to_numpy(), exact=name in COUNT_METRICS)
        else:
            assert got == ref


@pytest.mark.parametrize("scenario", ["random", "edge"])
def test_calc_metrics_matches_jax(scenario: str) -> None:
    """All metrics at once, with two reference models for the intersections."""
    frames = SCENARIOS[scenario]
    ref_reco = {"one": frames["ref_reco"], "two": frames["reco"].iloc[::2]}
    port_out = pm.calc_metrics({n: b(pm) for n, b in METRICS.items()}, frames["reco"], frames["interactions"],
                               frames["prev_interactions"], frames["catalog"], ref_reco)
    jax_out = jm.calc_metrics({n: b(jm) for n, b in METRICS.items()}, frames["reco"], frames["interactions"],
                              frames["prev_interactions"], frames["catalog"], ref_reco)
    assert port_out.keys() == jax_out.keys()
    assert len(port_out) > len(METRICS)  # each intersection metric gives a value per reference model
    for key, value in jax_out.items():
        _assert_float_equal(port_out[key], value, exact=key in COUNT_METRICS)


def test_calc_metrics_refuses_what_jax_refuses() -> None:
    frames = SCENARIOS["random"]
    for mod in (pm, jm):
        with pytest.raises(ValueError):
            mod.calc_metrics({"recall": mod.Recall(k=K)}, frames["reco"])  # no interactions
        with pytest.raises(ValueError):
            mod.calc_metrics({"serendipity": mod.Serendipity(k=K)}, frames["reco"], frames["interactions"])


def test_debias_interactions_matches_jax() -> None:
    frames = SCENARIOS["random"]
    merged_port = pm.merge_reco(frames["reco"], frames["interactions"])
    merged_jax = jm.merge_reco(frames["reco"], frames["interactions"])
    pd.testing.assert_frame_equal(merged_port, merged_jax, check_exact=True)
    got = pm.debias_interactions(merged_port, pm.DebiasConfig(iqr_coef=1.0, random_state=32))
    ref = jm.debias_interactions(merged_jax, jm.DebiasConfig(iqr_coef=1.0, random_state=32))
    pd.testing.assert_frame_equal(got, ref, check_exact=True)


@pytest.mark.parametrize(
    "fn",
    ["fast_isin", "fast_isin_for_sorted_test_elements", "fast_2d_int_unique", "fast_2d_2col_int_unique",
     "isin_2d_int"],
)
def test_array_ops_match_jax(fn: str) -> None:
    rng = np.random.default_rng(11)
    pairs = rng.integers(0, 6, size=(50, 2))
    elements = rng.integers(0, 30, size=40)
    sorted_test = np.unique(rng.integers(0, 30, size=12))
    args = {
        "fast_isin": (elements, sorted_test),
        "fast_isin_for_sorted_test_elements": (elements, sorted_test),
        "fast_2d_int_unique": (pairs,),
        "fast_2d_2col_int_unique": (pairs,),
        "isin_2d_int": (pairs, pairs[::3]),
    }[fn]
    got, ref = getattr(array_ops, fn)(*args), getattr(jax_array_ops, fn)(*args)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_public_names_are_the_jax_packages() -> None:
    assert set(pm.__all__) == set(jm.__all__)


PORT_DOCTEST_MODULES = [
    "rectools_tpu_torch.metrics.auc",
    "rectools_tpu_torch.metrics.distances",
    "rectools_tpu_torch.metrics.dq",
    "rectools_tpu_torch.metrics.novelty",
    "rectools_tpu_torch.metrics.popularity",
    "rectools_tpu_torch.metrics.ranking",
    "rectools_tpu_torch.metrics.scoring",
    "rectools_tpu_torch.metrics.serendipity",
    "rectools_tpu_torch.model_selection.last_n_split",
    "rectools_tpu_torch.model_selection.random_split",
    "rectools_tpu_torch.model_selection.time_split",
    "rectools_tpu_torch.utils.array_ops",
]


@pytest.mark.parametrize("module_name", PORT_DOCTEST_MODULES)
def test_port_doctests(module_name: str) -> None:
    results = doctest.testmod(importlib.import_module(module_name), verbose=False)
    assert results.failed == 0 and results.attempted > 0
