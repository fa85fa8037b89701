"""Metrics suite — behavioral parity with reference rectools/metrics.

The port's copy of ``rectools_tpu/metrics/__init__.py``.
"""

from .auc import PAP, AUCFitted, InsufficientHandling, PartialAUC
from .base import Catalog, MetricAtK, merge_reco, outer_merge_reco
from .catalog import CatalogCoverage
from .classification import (
    MCC,
    Accuracy,
    ClassificationMetric,
    F1Beta,
    HitRate,
    Precision,
    Recall,
    SimpleClassificationMetric,
    calc_confusions,
    make_confusions,
)
from .debias import DebiasConfig, DebiasableMetrikAtK, calc_debiased_fit_task, debias_interactions
from .distances import (
    PairwiseDistanceCalculator,
    PairwiseHammingDistanceCalculator,
    SparsePairwiseHammingDistanceCalculator,
)
from .diversity import IntraListDiversity
from .dq import CoveredUsers, SufficientReco, UnrepeatedReco
from .intersection import Intersection
from .novelty import MeanInvUserFreq
from .popularity import AvgRecPopularity
from .ranking import MAP, MRR, NDCG
from .scoring import calc_metrics
from .serendipity import Serendipity

__all__ = [
    "PAP",
    "AUCFitted",
    "InsufficientHandling",
    "PartialAUC",
    "Catalog",
    "MetricAtK",
    "merge_reco",
    "outer_merge_reco",
    "CatalogCoverage",
    "MCC",
    "Accuracy",
    "ClassificationMetric",
    "F1Beta",
    "HitRate",
    "Precision",
    "Recall",
    "SimpleClassificationMetric",
    "calc_confusions",
    "make_confusions",
    "DebiasConfig",
    "DebiasableMetrikAtK",
    "calc_debiased_fit_task",
    "debias_interactions",
    "PairwiseDistanceCalculator",
    "PairwiseHammingDistanceCalculator",
    "SparsePairwiseHammingDistanceCalculator",
    "IntraListDiversity",
    "CoveredUsers",
    "SufficientReco",
    "UnrepeatedReco",
    "Intersection",
    "MeanInvUserFreq",
    "AvgRecPopularity",
    "MAP",
    "MRR",
    "NDCG",
    "calc_metrics",
    "Serendipity",
]
