"""Classification metrics: Precision, Recall, F1Beta, HitRate, Accuracy, MCC.

The port's copy of ``rectools_tpu/metrics/classification.py``.

Behavioral parity with reference rectools/metrics/classification.py:36-533.
All computed from per-user confusion counts (LIKED/TP/FP/FN[/TN]).
"""

import typing as tp

import attr
import numpy as np
import pandas as pd

from ..columns import Columns
from .base import Catalog, merge_reco
from .debias import DebiasableMetrikAtK, debias_for_metric_configs, debias_interactions

TP = "__TP"
FP = "__FP"
FN = "__FN"
TN = "__TN"
LIKED = "__LIKED"


def calc_confusions(merged: pd.DataFrame, k: int) -> pd.DataFrame:
    """Per-user confusion counts from a merged table
    (reference classification.py:503-538)."""
    grouped = merged.groupby(Columns.User)
    confusion_df = grouped[Columns.Item].agg("size").rename(LIKED).to_frame()
    is_hit = (merged[Columns.Rank] <= k).to_numpy()
    confusion_df[TP] = pd.Series(is_hit, index=merged[Columns.User].to_numpy()).groupby(level=0).sum()
    confusion_df[FP] = k - confusion_df[TP]
    confusion_df[FN] = confusion_df[LIKED] - confusion_df[TP]
    confusion_df.index.name = Columns.User
    return confusion_df


def make_confusions(reco: pd.DataFrame, interactions: pd.DataFrame, k: int) -> pd.DataFrame:
    """Confusion counts from raw reco + interactions
    (reference classification.py:541-570)."""
    merged = merge_reco(reco, interactions)
    return calc_confusions(merged, k)


@attr.s
class ClassificationMetric(DebiasableMetrikAtK):
    """Metrics needing the catalog size for TN (reference classification.py:36-152)."""

    def calc(self, reco: pd.DataFrame, interactions: pd.DataFrame, catalog: Catalog) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, interactions, catalog).mean()

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame, catalog: Catalog) -> pd.Series:
        """Per-user metric values."""
        is_debiased = False
        if self.debias_config is not None:
            interactions = debias_interactions(interactions, self.debias_config)
            is_debiased = True
        self._check(reco, interactions=interactions)
        confusion_df = make_confusions(reco, interactions, self.k)
        return self.calc_per_user_from_confusion_df(confusion_df, catalog, is_debiased)

    def calc_from_confusion_df(self, confusion_df: pd.DataFrame, catalog: Catalog, is_debiased: bool = False) -> float:
        """Mean metric value from a prepared confusion table."""
        return self.calc_per_user_from_confusion_df(confusion_df, catalog, is_debiased).mean()

    def calc_per_user_from_confusion_df(
        self, confusion_df: pd.DataFrame, catalog: Catalog, is_debiased: bool = False
    ) -> pd.Series:
        """Per-user metric values from a prepared confusion table."""
        self._check_debias(is_debiased, obj_name="confusion_df")
        if TN not in confusion_df:
            confusion_df[TN] = len(catalog) - self.k - confusion_df[FN]
        return self._calc_per_user_from_confusion_df(confusion_df, catalog).rename(None)

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame, catalog: Catalog) -> pd.Series:
        raise NotImplementedError()


@attr.s
class SimpleClassificationMetric(DebiasableMetrikAtK):
    """Metrics computable from TP/FP/FN alone (reference classification.py:155-260)."""

    def calc(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> float:
        """Mean metric value over users."""
        return self.calc_per_user(reco, interactions).mean()

    def calc_per_user(self, reco: pd.DataFrame, interactions: pd.DataFrame) -> pd.Series:
        """Per-user metric values."""
        is_debiased = False
        if self.debias_config is not None:
            interactions = debias_interactions(interactions, self.debias_config)
            is_debiased = True
        self._check(reco, interactions=interactions)
        confusion_df = make_confusions(reco, interactions, self.k)
        return self.calc_per_user_from_confusion_df(confusion_df, is_debiased)

    def calc_from_confusion_df(self, confusion_df: pd.DataFrame, is_debiased: bool = False) -> float:
        """Mean metric value from a prepared confusion table."""
        return self.calc_per_user_from_confusion_df(confusion_df, is_debiased).mean()

    def calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame, is_debiased: bool = False) -> pd.Series:
        """Per-user metric values from a prepared confusion table."""
        self._check_debias(is_debiased, obj_name="confusion_df")
        return self._calc_per_user_from_confusion_df(confusion_df).rename(None)

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame) -> pd.Series:
        raise NotImplementedError()


@attr.s
class Precision(SimpleClassificationMetric):
    """tp / k; R-Precision: tp / min(k, tp+fn) (reference classification.py:264-295)."""

    r_precision: bool = attr.ib(default=False)

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame) -> pd.Series:
        denominator = np.minimum(self.k, confusion_df[TP] + confusion_df[FN]) if self.r_precision else self.k
        return confusion_df[TP] / denominator


@attr.s
class Recall(SimpleClassificationMetric):
    """tp / liked (reference classification.py:296-318)."""

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame) -> pd.Series:
        return confusion_df[TP] / confusion_df[LIKED]


@attr.s
class Accuracy(ClassificationMetric):
    """(tp + tn) / n_items (reference classification.py:320-345)."""

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame, catalog: Catalog) -> pd.Series:
        return (confusion_df[TP] + confusion_df[TN]) / len(catalog)


@attr.s
class F1Beta(SimpleClassificationMetric):
    """F-beta of precision@k and recall@k (reference classification.py:346-384)."""

    beta: float = attr.ib(default=1.0)

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame) -> pd.Series:
        beta_sqr = self.beta**2
        p_k = confusion_df[TP] / self.k
        r_k = confusion_df[TP] / confusion_df[LIKED]
        f1 = (1 + beta_sqr) * p_k * r_k / (beta_sqr * p_k + r_k)
        f1.loc[(p_k == 0.0) & (r_k == 0.0)] = 0.0
        return f1


@attr.s
class MCC(ClassificationMetric):
    """Matthews correlation coefficient (reference classification.py:386-420)."""

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame, catalog: Catalog) -> pd.Series:
        tp_, tn_, fp_, fn_ = confusion_df[TP], confusion_df[TN], confusion_df[FP], confusion_df[FN]
        numerator = tp_ * tn_ - fp_ * fn_
        denominator = np.sqrt((tp_ + fp_) * (tp_ + fn_) * (tn_ + fp_) * (tn_ + fn_))
        mcc = numerator / denominator
        mcc.loc[denominator == 0.0] = 0.0
        return mcc


@attr.s
class HitRate(SimpleClassificationMetric):
    """1 if tp > 0 else 0 (reference classification.py:422-443)."""

    def _calc_per_user_from_confusion_df(self, confusion_df: pd.DataFrame) -> pd.Series:
        return (confusion_df[TP] > 0).astype(float)


def calc_classification_metrics(
    metrics: tp.Dict[str, tp.Union[ClassificationMetric, SimpleClassificationMetric]],
    merged: pd.DataFrame,
    catalog: tp.Optional[Catalog] = None,
) -> tp.Dict[str, float]:
    """Family dispatcher: shares confusion tables across same (k, debias config)
    (reference classification.py:446-500)."""
    results = {}
    merged_debiased = debias_for_metric_configs(metrics.values(), merged)
    confusions: tp.Dict[tp.Any, pd.DataFrame] = {}
    for metric_name, metric in metrics.items():
        task = (metric.k, metric.debias_config)
        is_debiased = metric.debias_config is not None
        if task not in confusions:
            confusions[task] = calc_confusions(merged=merged_debiased[metric.debias_config], k=metric.k)
        confusion_df = confusions[task]
        if isinstance(metric, SimpleClassificationMetric):
            res = metric.calc_from_confusion_df(confusion_df, is_debiased=is_debiased)
        elif isinstance(metric, ClassificationMetric):
            if catalog is None:
                raise ValueError(f"For calculating '{metric.__class__.__name__}' it's necessary to set `catalog`")
            res = metric.calc_from_confusion_df(confusion_df, catalog, is_debiased=is_debiased)
        else:  # pragma: no cover
            raise TypeError(f"Unexpected metric {metric}")
        results[metric_name] = res
    return results
