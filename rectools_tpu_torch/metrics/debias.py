"""Popularity debiasing of interactions for metric computation.

The port's copy of ``rectools_tpu/metrics/debias.py``.

Behavioral parity with reference rectools/metrics/debias.py:29-205:
IQR-based popularity border; items above it are down-sampled to the border.
"""

import typing as tp
from collections import defaultdict

import attr
import pandas as pd

from ..columns import Columns
from .base import MetricAtK


@attr.s(frozen=True)
class DebiasConfig:
    """Debias parameters: IQR coefficient + down-sampling random state."""

    iqr_coef: float = attr.ib(default=1.5)
    random_state: tp.Optional[int] = attr.ib(default=None)


@attr.s
class DebiasableMetrikAtK(MetricAtK):
    """Base class for metrics supporting popularity debiasing."""

    debias_config: tp.Optional[DebiasConfig] = attr.ib(default=None)

    def _check_debias(self, is_debiased: bool, obj_name: str) -> None:
        if not is_debiased and self.debias_config is not None:
            raise ValueError(
                "You have specified `debias_config` for metric "
                f"but `{obj_name}` is not de-biased. "
                f"Please make de-biasing for `{obj_name}` "
                "and specify `is_debiased` as `True` "
                "or otherwise use `calc` and `calc_per_user` methods for auto de-biasing."
            )


def debias_interactions(interactions: pd.DataFrame, config: DebiasConfig) -> pd.DataFrame:
    """Down-sample interactions of items whose popularity (unique users)
    exceeds Q3 + iqr_coef * IQR (reference debias.py:75-132)."""
    if len(interactions) == 0:
        return interactions

    interactions = interactions.copy()
    item_popularity = interactions.groupby(Columns.Item, sort=False)[Columns.User].nunique()
    quantiles = item_popularity.quantile(q=[0.25, 0.75])
    q1, q3 = quantiles.loc[0.25], quantiles.loc[0.75]
    max_border = int(q3 + config.iqr_coef * (q3 - q1))

    items_above = item_popularity[item_popularity > max_border].index
    mask_above = interactions[Columns.Item].isin(items_above)
    kept = interactions[~mask_above]
    downsampled = (
        interactions[mask_above]
        .sample(frac=1.0, random_state=config.random_state)
        .groupby(Columns.Item)
        .head(max_border)
    )
    return pd.concat([kept, downsampled], ignore_index=True)


def debias_for_metric_configs(
    metrics: tp.Iterable[DebiasableMetrikAtK],
    interactions: pd.DataFrame,
    prev_debiased_interactions: tp.Optional[tp.Dict[tp.Optional[DebiasConfig], pd.DataFrame]] = None,
) -> tp.Dict[tp.Optional[DebiasConfig], pd.DataFrame]:
    """Debiased interactions per unique debias config (reference debias.py:172-205)."""
    configs_new = set(getattr(metric, "debias_config", None) for metric in metrics)
    if prev_debiased_interactions is not None:
        configs_new -= set(prev_debiased_interactions.keys())
    debiased = {
        config: debias_interactions(interactions, config) if config is not None else interactions
        for config in configs_new
    }
    if prev_debiased_interactions is not None:
        debiased = {**prev_debiased_interactions, **debiased}
    return debiased


def calc_debiased_fit_task(
    metrics: tp.Iterable[DebiasableMetrikAtK],
    interactions: pd.DataFrame,
    prev_debiased_interactions: tp.Optional[tp.Dict[tp.Optional[DebiasConfig], pd.DataFrame]] = None,
) -> tp.Dict[tp.Optional[DebiasConfig], tp.Tuple[int, pd.DataFrame]]:
    """(k_max, debiased interactions) per unique debias config
    (reference debias.py:135-169)."""
    metrics = list(metrics)
    debiased = debias_for_metric_configs(metrics, interactions, prev_debiased_interactions)
    max_k: tp.Dict[tp.Optional[DebiasConfig], int] = defaultdict(int)
    for metric in metrics:
        config = getattr(metric, "debias_config", None)
        max_k[config] = max(max_k[config], metric.k)
    return {config: (max_k[config], d) for config, d in debiased.items()}
