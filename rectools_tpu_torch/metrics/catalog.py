"""Catalog coverage metric.

The port's copy of ``rectools_tpu/metrics/catalog.py``.

Behavioral parity with reference rectools/metrics/catalog.py:28-95.
"""

import typing as tp

import attr
import pandas as pd

from ..columns import Columns
from .base import Catalog, MetricAtK


@attr.s
class CatalogCoverage(MetricAtK):
    """Number (or share) of unique items in top-k recommendations
    (reference catalog.py:28-62)."""

    normalize: bool = attr.ib(default=False)

    def calc(self, reco: pd.DataFrame, catalog: Catalog) -> float:
        """Aggregate metric value."""
        res = reco.loc[reco[Columns.Rank] <= self.k, Columns.Item].nunique()
        if self.normalize:
            return res / len(catalog)
        return res


CatalogMetric = CatalogCoverage


def calc_catalog_metrics(
    metrics: tp.Dict[str, CatalogMetric],
    reco: pd.DataFrame,
    catalog: Catalog,
) -> tp.Dict[str, float]:
    """Family dispatcher."""
    return {name: metric.calc(reco, catalog) for name, metric in metrics.items()}
