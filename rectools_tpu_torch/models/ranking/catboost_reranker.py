"""CatBoost-backed reranker (port of rectools_tpu/models/ranking/catboost_reranker.py;
reference rectools/models/ranking/catboost_reranker.py:15-98).

CatBoost is an optional host-side dependency (C++ GBDT). The class itself is
importable without it: the Pool construction goes through an injectable
``pool_factory``, so environments without catboost can plug any
Pool-compatible trainer (and the contract tests exercise the real
grouping/label logic with a fake). With catboost installed, the default
factory is ``catboost.Pool`` and behavior matches the reference exactly.
"""

import typing as tp

import numpy as np
import pandas as pd

from ...columns import Columns
from .candidate_ranking import Reranker

try:  # pragma: no cover - environment-dependent
    from catboost import CatBoostClassifier, Pool as _CatBoostPool

    HAS_CATBOOST = True
except ImportError:
    CatBoostClassifier = None  # type: ignore[assignment]
    _CatBoostPool = None  # type: ignore[assignment]
    HAS_CATBOOST = False


class CatBoostReranker(Reranker):
    """Reranker over CatBoostClassifier or CatBoostRanker (group-wise Pool).

    Classifier models (anything exposing ``predict_proba``) train on a
    (data, label) pool and score with the positive-class probability;
    rankers train on a per-user ``group_id`` pool sorted by user and score
    with ``predict``.
    """

    def __init__(
        self,
        model: tp.Any,
        fit_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        pool_kwargs: tp.Optional[tp.Dict[str, tp.Any]] = None,
        pool_factory: tp.Optional[tp.Callable[..., tp.Any]] = None,
    ):
        super().__init__(model)
        self.is_classifier = hasattr(model, "predict_proba")
        self.fit_kwargs = fit_kwargs
        self.pool_kwargs = pool_kwargs
        if pool_factory is None:
            if not HAS_CATBOOST:
                raise ImportError(
                    "catboost is not installed. Install it, or pass `pool_factory` "
                    "(any callable accepting data/label/group_id like catboost.Pool) "
                    "to use CatBoostReranker with a compatible trainer."
                )
            pool_factory = _CatBoostPool
        self.pool_factory = pool_factory

    def prepare_training_pool(self, candidates_with_target: pd.DataFrame) -> tp.Any:
        """Classifier: data+label; ranker: plus per-user group ids."""
        if self.is_classifier:
            pool_kwargs = {
                "data": candidates_with_target.drop(columns=Columns.UserItem + [Columns.Target]),
                "label": candidates_with_target[Columns.Target],
            }
        else:
            candidates_with_target = candidates_with_target.sort_values(by=[Columns.User])
            pool_kwargs = {
                "data": candidates_with_target.drop(columns=Columns.UserItem + [Columns.Target]),
                "label": candidates_with_target[Columns.Target],
                "group_id": candidates_with_target[Columns.User].values,
            }
        if self.pool_kwargs is not None:
            pool_kwargs.update(self.pool_kwargs)
        return self.pool_factory(**pool_kwargs)

    def fit(self, candidates_with_target: pd.DataFrame) -> None:
        """Fit on a prepared training Pool."""
        training_pool = self.prepare_training_pool(candidates_with_target)
        fit_kwargs = {"X": training_pool}
        if self.fit_kwargs is not None:
            fit_kwargs.update(self.fit_kwargs)
        self.model.fit(**fit_kwargs)

    def predict_scores(self, candidates: pd.DataFrame) -> np.ndarray:
        """Positive-class probability for classifiers, raw score for rankers."""
        x_full = candidates.drop(columns=Columns.UserItem)
        if self.is_classifier:
            return self.model.predict_proba(x_full)[:, 1]
        return self.model.predict(x_full)
