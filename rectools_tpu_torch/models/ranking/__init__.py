"""Two-stage candidate-ranking pipeline (port of rectools_tpu/models/ranking)."""

from .candidate_ranking import (
    CandidateFeatureCollector,
    CandidateGenerator,
    CandidateRankingModel,
    ClassifierBase,
    NegativeSamplerBase,
    PerUserNegativeSampler,
    RankerBase,
    Reranker,
)
from .catboost_reranker import CatBoostReranker

__all__ = [
    "CandidateFeatureCollector",
    "CandidateGenerator",
    "CandidateRankingModel",
    "ClassifierBase",
    "NegativeSamplerBase",
    "PerUserNegativeSampler",
    "RankerBase",
    "Reranker",
    "CatBoostReranker",
]
