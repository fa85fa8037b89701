"""Cross-validation over models and metrics.

The port's copy of ``rectools_tpu/model_selection/cross_validate.py``.

Behavioral parity target: reference rectools/model_selection/cross_validate.py
(``cross_validate``). Structured as one function that materializes a fold
plus one unified fit/recommend plan (reference models first, then the rest),
so every model is fitted exactly once per fold.

With the port's models every fit and recommend runs where the model's own
``device`` says (the card by default): nothing here moves a model or its
data to the CPU.
"""

import typing as tp
from dataclasses import dataclass

import numpy as np
import pandas as pd

from ..columns import Columns
from ..dataset import Dataset
from ..dataset.context import get_context
from ..metrics import MetricAtK
from ..metrics.scoring import calc_metrics
from ..models.base import ErrorBehaviour, ModelBase
from ..types import ExternalIds
from .splitter import Splitter


@dataclass
class _Fold:
    """Everything one fold's fit/recommend/score cycle needs."""

    index: int
    info: tp.Dict[str, tp.Any]
    train: Dataset
    test: pd.DataFrame
    target_users: np.ndarray
    history: pd.DataFrame
    catalog: np.ndarray
    context: tp.Optional[tp.Any]


def _build_fold(
    dataset: Dataset,
    train_rows: np.ndarray,
    test_rows: np.ndarray,
    info: tp.Dict[str, tp.Any],
    keep_unused_features: bool,
    need_context: bool,
) -> _Fold:
    """Materialize one fold: a train-only Dataset plus the external-id test frame."""
    train = dataset.filter_interactions(
        row_indexes_to_keep=train_rows,
        keep_external_ids=True,
        keep_features_for_removed_entities=keep_unused_features,
    )
    test = dataset.interactions.df.loc[test_rows].copy()
    test[Columns.User] = dataset.user_id_map.convert_to_external(test[Columns.User])
    test[Columns.Item] = dataset.item_id_map.convert_to_external(test[Columns.Item])
    history = train.get_raw_interactions()
    return _Fold(
        index=info["i_split"],
        info=info,
        train=train,
        test=test,
        target_users=test[Columns.User].unique(),
        history=history,
        catalog=history[Columns.Item].unique(),
        context=get_context(test) if need_context else None,
    )


def cross_validate(
    dataset: Dataset,
    splitter: Splitter,
    metrics: tp.Dict[str, MetricAtK],
    models: tp.Dict[str, ModelBase],
    k: int,
    filter_viewed: bool,
    items_to_recommend: tp.Optional[ExternalIds] = None,
    prefer_warm_inference_over_cold: bool = True,
    ref_models: tp.Optional[tp.List[str]] = None,
    validate_ref_models: bool = False,
    on_unsupported_targets: ErrorBehaviour = "warn",
) -> tp.Dict[str, tp.Any]:
    """Fit and score every model on every fold of ``splitter``.

    ``ref_models`` are fitted first on each fold; their recommendations feed
    intersection metrics of the remaining models (and are themselves scored
    only when ``validate_ref_models``). Returns
    ``{"splits": [fold info, ...], "metrics": [{"model", "i_split", **values}, ...]}``.
    """
    ref_names = list(ref_models or [])
    scored_names = [name for name in models if name not in ref_names or validate_ref_models]
    need_context = any(m.require_recommend_context for m in models.values())

    fold_infos: tp.List[tp.Dict[str, tp.Any]] = []
    rows: tp.List[tp.Dict[str, tp.Any]] = []

    for train_rows, test_rows, info in splitter.split(dataset.interactions, collect_fold_stats=True):
        fold_infos.append(info)
        fold = _build_fold(
            dataset, train_rows, test_rows, info, prefer_warm_inference_over_cold, need_context
        )

        def _reco_of(name: str) -> pd.DataFrame:
            model = models[name]
            model.fit(fold.train)
            return model.recommend(
                users=fold.target_users,
                dataset=fold.train,
                k=k,
                filter_viewed=filter_viewed,
                items_to_recommend=items_to_recommend,
                on_unsupported_targets=on_unsupported_targets,
                context=fold.context if model.require_recommend_context else None,
            )

        ref_reco = {name: _reco_of(name) for name in ref_names}

        for name in scored_names:
            values = calc_metrics(
                metrics,
                reco=ref_reco.get(name) if name in ref_reco else _reco_of(name),
                interactions=fold.test,
                prev_interactions=fold.history,
                catalog=fold.catalog,
                ref_reco=ref_reco,
            )
            rows.append({"model": name, "i_split": fold.index, **values})

    return {"splits": fold_infos, "metrics": rows}
