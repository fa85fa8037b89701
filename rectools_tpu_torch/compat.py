"""Compatibility helpers: dummy classes for optional extras (reference
rectools/compat.py:19-94) and a config translator for users migrating from
the reference library.

Port of rectools_tpu/compat.py; it resolves classes through the port's
``models/base.py``.
"""

import typing as tp
import warnings


class RequirementUnavailable:
    """Placeholder raising an informative error when the optional dependency
    backing a feature is not installed."""

    requirement: str = ""

    def __init__(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise ImportError(
            f"Requirement `{self.requirement}` is not satisfied. "
            f"Install the missing package to use `{self.__class__.__name__}`."
        )


class CatBoostRerankerUnavailable(RequirementUnavailable):
    """Dummy for CatBoostReranker when catboost is not installed."""

    requirement = "catboost"


# --- Reference-config migration -------------------------------------------

# Inner `model.cls` names of the reference's wrapped implicit kNN variants
# (reference rectools/models/implicit_knn.py:38-41) -> our `variant` literal.
_KNN_VARIANTS = {
    "ItemItemRecommender": "plain",
    "CosineRecommender": "cosine",
    "TFIDFRecommender": "tfidf",
    "BM25Recommender": "bm25",
}


def translate_reference_config(config: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """Translate a reference (RecTools) model config dict into the equivalent
    config dict for this framework.

    Handles the structural differences between the two libraries:

    - reference class paths / wrapper class names (``rectools.models.…``,
      ``ImplicitALSWrapperModel``) map to the native model classes here;
    - the wrappers' nested ``model: {…}`` hyperparameter dicts (reference
      implicit_als.py:90-98, implicit_bpr.py:88-95, implicit_knn.py:83-88,
      lightfm.py:81-90) are flattened into our flat configs, with the kNN
      inner ``cls`` becoming our ``variant`` literal;
    - host/accelerator knobs with no counterpart in the port's configs
      (``num_threads``, ``use_gpu``, ``recommend_n_threads``, …) are dropped
      with a warning; ``use_gpu`` is not mapped onto ``device``.

    Returns a dict accepted by `model_from_config` / `cls.from_config`.
    """
    from .models.base import _deserialize_model_class, _serialize_model_class

    cfg: tp.Dict[str, tp.Any] = dict(config)
    spec = cfg.pop("cls", None)
    if spec is None:
        raise ValueError("`cls` must be present in the reference config")
    target_cls = _deserialize_model_class(spec)

    inner = cfg.pop("model", None)
    if isinstance(inner, tp.Mapping):
        inner = dict(inner)
        inner_cls = inner.pop("cls", None)
        if inner_cls is not None:
            name = inner_cls if isinstance(inner_cls, str) else getattr(inner_cls, "__name__", str(inner_cls))
            name = name.rsplit(".", 1)[-1]
            if name in _KNN_VARIANTS:
                inner["variant"] = _KNN_VARIANTS[name]
        for key, value in inner.items():
            cfg.setdefault(key, value)

    if cfg.get("random_state", 0) is None:
        cfg.pop("random_state")  # target defaults differ; None means "unseeded"

    allowed = set(target_cls.config_class.model_fields)
    dropped = sorted(key for key in cfg if key not in allowed)
    if dropped:
        warnings.warn(
            f"Reference config keys {dropped} have no equivalent in "
            f"{target_cls.__name__} and were dropped.",
            UserWarning,
        )
    translated = {key: value for key, value in cfg.items() if key in allowed}
    translated["cls"] = _serialize_model_class(target_cls)
    return translated
