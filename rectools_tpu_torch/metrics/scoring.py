"""``calc_metrics``: one entry point that scores a heterogeneous bag of metrics.

The port's copy of ``rectools_tpu/metrics/scoring.py``.

Behavioral parity target: reference rectools/metrics/scoring.py
(``calc_metrics``). Organised as a table of metric families — each row names
the classes it owns, the inputs it needs, and the batch calculator to call —
so merges and per-family fits are shared across metrics of the same family.
"""

import typing as tp
import warnings

import pandas as pd

from ..utils.misc import select_by_type
from .auc import AucMetric, calc_auc_metrics
from .base import Catalog, MetricAtK, merge_reco
from .catalog import CatalogMetric, calc_catalog_metrics
from .classification import ClassificationMetric, SimpleClassificationMetric, calc_classification_metrics
from .diversity import DiversityMetric, calc_diversity_metrics
from .dq import CrossDQMetric, RecoDQMetric, calc_cross_dq_metrics, calc_reco_dq_metrics
from .intersection import IntersectionMetric, calc_intersection_metrics
from .novelty import NoveltyMetric, calc_novelty_metrics
from .popularity import PopularityMetric, calc_popularity_metrics
from .ranking import RankingMetric, calc_ranking_metrics
from .serendipity import SerendipityMetric, calc_serendipity_metrics


class _Inputs:
    """The optional inputs of one calc_metrics call, with a memoized reco-to-
    interactions merge shared by the families that consume it."""

    def __init__(
        self,
        reco: pd.DataFrame,
        interactions: tp.Optional[pd.DataFrame],
        prev_interactions: tp.Optional[pd.DataFrame],
        catalog: tp.Optional[Catalog],
        ref_reco: tp.Optional[tp.Union[pd.DataFrame, tp.Dict[tp.Hashable, pd.DataFrame]]],
    ) -> None:
        self.reco = reco
        self.interactions = interactions
        self.prev_interactions = prev_interactions
        self.catalog = catalog
        self.ref_reco = ref_reco
        self._merged: tp.Optional[pd.DataFrame] = None

    def require(self, family: str, *arg_names: str) -> None:
        for arg in arg_names:
            if getattr(self, arg) is None:
                raise ValueError(f"{family} metrics need the `{arg}` argument of calc_metrics")
        if "ref_reco" in arg_names and isinstance(self.ref_reco, dict) and not self.ref_reco:
            raise ValueError("intersection metrics need a non-empty `ref_reco`")

    @property
    def merged(self) -> pd.DataFrame:
        if self._merged is None:
            self._merged = merge_reco(self.reco, self.interactions)
        return self._merged


# (family name, metric classes, required inputs, batch calculator over _Inputs)
_FAMILIES: tp.Tuple[tp.Tuple[str, tp.Any, tp.Tuple[str, ...], tp.Any], ...] = (
    (
        "classification",
        (ClassificationMetric, SimpleClassificationMetric),
        ("interactions",),
        lambda sel, inp: calc_classification_metrics(sel, inp.merged, inp.catalog),
    ),
    ("ranking", RankingMetric, ("interactions",), lambda sel, inp: calc_ranking_metrics(sel, inp.merged)),
    ("AUC", AucMetric, ("interactions",), lambda sel, inp: calc_auc_metrics(sel, inp.reco, inp.interactions)),
    (
        "novelty",
        NoveltyMetric,
        ("prev_interactions",),
        lambda sel, inp: calc_novelty_metrics(sel, inp.reco, inp.prev_interactions),
    ),
    ("catalog", CatalogMetric, ("catalog",), lambda sel, inp: calc_catalog_metrics(sel, inp.reco, inp.catalog)),
    (
        "popularity",
        PopularityMetric,
        ("prev_interactions",),
        lambda sel, inp: calc_popularity_metrics(sel, inp.reco, inp.prev_interactions),
    ),
    ("diversity", DiversityMetric, (), lambda sel, inp: calc_diversity_metrics(sel, inp.reco)),
    (
        "serendipity",
        SerendipityMetric,
        ("interactions", "prev_interactions", "catalog"),
        lambda sel, inp: calc_serendipity_metrics(
            sel, inp.reco, inp.interactions, inp.prev_interactions, inp.catalog
        ),
    ),
    (
        "intersection",
        IntersectionMetric,
        ("ref_reco",),
        lambda sel, inp: calc_intersection_metrics(sel, inp.reco, inp.ref_reco),
    ),
    ("cross-DQ", CrossDQMetric, ("interactions",),
     lambda sel, inp: calc_cross_dq_metrics(sel, inp.reco, inp.interactions)),
    ("reco-DQ", RecoDQMetric, (), lambda sel, inp: calc_reco_dq_metrics(sel, inp.reco)),
)


def calc_metrics(
    metrics: tp.Mapping[str, MetricAtK],
    reco: pd.DataFrame,
    interactions: tp.Optional[pd.DataFrame] = None,
    prev_interactions: tp.Optional[pd.DataFrame] = None,
    catalog: tp.Optional[Catalog] = None,
    ref_reco: tp.Optional[tp.Union[pd.DataFrame, tp.Dict[tp.Hashable, pd.DataFrame]]] = None,
) -> tp.Dict[str, float]:
    """Score every metric in ``metrics`` against one recommendation table.

    Metrics are grouped by family so shared work (the reco/interactions merge,
    per-family fits) happens once, and each family validates the inputs it
    needs up front.

    >>> import pandas as pd
    >>> from rectools_tpu_torch import Columns
    >>> from rectools_tpu_torch.metrics import Recall, MeanInvUserFreq
    >>> reco = pd.DataFrame({
    ...     Columns.User: [7, 7, 9, 9],
    ...     Columns.Item: [100, 200, 100, 300],
    ...     Columns.Rank: [1, 2, 1, 2]})
    >>> truth = pd.DataFrame({
    ...     Columns.User: [7, 9],
    ...     Columns.Item: [200, 300]})
    >>> history = pd.DataFrame({
    ...     Columns.User: [7, 9, 9],
    ...     Columns.Item: [100, 100, 300]})
    >>> out = calc_metrics(
    ...     {"recall@2": Recall(k=2), "miuf@2": MeanInvUserFreq(k=2)},
    ...     reco=reco, interactions=truth, prev_interactions=history)
    >>> {name: round(value, 4) for name, value in sorted(out.items())}
    {'miuf@2': 0.5, 'recall@2': 1.0}
    """
    inputs = _Inputs(reco, interactions, prev_interactions, catalog, ref_reco)
    values: tp.Dict[str, float] = {}
    n_expected = len(metrics)

    for family, classes, needs, run in _FAMILIES:
        selected = select_by_type(metrics, classes)
        if not selected:
            continue
        inputs.require(family, *needs)
        family_values = run(selected, inputs)
        values.update(family_values)
        if classes is IntersectionMetric:
            # one intersection metric yields one value per reference model
            n_expected += len(family_values) - len(selected)

    if len(values) < n_expected:
        warnings.warn("Some metrics could not be scored: unknown metric types were skipped.")

    return {name: value.item() if hasattr(value, "item") else value for name, value in values.items()}
