"""Model base class: fit/recommend orchestration, hot/warm/cold target
handling, typed configs and serialization.

Port of rectools_tpu/models/base.py (behavioral parity with reference
rectools/models/base.py:88-867). The compute behind the `_recommend_*` hooks
runs on the GPU (see ops/topk.py); this layer is the host-side orchestration:
id bookkeeping, target splitting, policy checks, external-id tables.
"""

import pickle
import typing as tp
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import typing_extensions as tpe
from pydantic import BeforeValidator, PlainSerializer
from pydantic_core import PydanticSerializationError

from ..columns import Columns
from ..dataset import Dataset
from ..exceptions import NotFittedError
from ..types import ExternalIds
from ..utils.config import BaseConfig
from ..utils.misc import get_class_or_function_full_path, import_object, make_dict_flat, unflatten_dict
from ..utils.serialization import PICKLE_PROTOCOL, FileLike, read_bytes

T = tp.TypeVar("T", bound="ModelBase")
Scores = tp.Union[tp.Sequence[float], np.ndarray]
ErrorBehaviour = tp.Literal["ignore", "warn", "raise"]
InternalIdsArray = np.ndarray
ExternalIdsArray = np.ndarray

InternalRecoTriplet = tp.Tuple[tp.Any, tp.Any, tp.Any]
SemiInternalRecoTriplet = tp.Tuple[tp.Any, tp.Any, tp.Any]
ExternalRecoTriplet = tp.Tuple[tp.Any, tp.Any, tp.Any]
RecoTriplet = tp.Tuple[np.ndarray, np.ndarray, np.ndarray]

STANDARD_MODEL_PATH_PREFIX = "rectools_tpu_torch.models"

# Reference (RecTools) class names accepted as aliases so configs written for
# the reference library resolve to the native equivalents here. The wrapped
# native solvers are first-class models in this framework, hence the renames.
REFERENCE_MODEL_ALIASES: tp.Dict[str, str] = {
    "ImplicitALSWrapperModel": "ALSModel",
    "ImplicitBPRWrapperModel": "BPRModel",
    "ImplicitItemKNNWrapperModel": "ItemKNNModel",
    "LightFMWrapperModel": "HybridMFModel",
}

REFERENCE_MODEL_PATH_PREFIX = "rectools.models"


def _deserialize_model_class(spec: tp.Any) -> tp.Any:
    if not isinstance(spec, str):
        return spec
    if spec.startswith(REFERENCE_MODEL_PATH_PREFIX + "."):
        # Accept class paths from reference-library configs
        # (e.g. "rectools.models.implicit_als.ImplicitALSWrapperModel").
        spec = spec.rsplit(".", 1)[-1]
    if "." not in spec:
        spec = REFERENCE_MODEL_ALIASES.get(spec, spec)
        spec = f"{STANDARD_MODEL_PATH_PREFIX}.{spec}"
    return import_object(spec)


def _serialize_model_class(cls: tp.Type["ModelBase"]) -> str:
    path = get_class_or_function_full_path(cls)
    if path.startswith(STANDARD_MODEL_PATH_PREFIX):
        return path.split(".")[-1]
    return path


ModelClass = tpe.Annotated[
    tp.Type["ModelBase"],
    BeforeValidator(_deserialize_model_class),
    PlainSerializer(func=_serialize_model_class, return_type=str, when_used="json"),
]


class ModelConfig(BaseConfig):
    """Base typed model config. `cls` round-trips as a class path."""

    cls: tp.Optional[ModelClass] = None
    verbose: int = 0


ModelConfig_T = tp.TypeVar("ModelConfig_T", bound=ModelConfig)


class ModelBase(tp.Generic[ModelConfig_T]):
    """Base class for every recommendation model.

    Subclasses implement `_fit` and the `_recommend_*` hooks; this class owns
    the public `fit` / `recommend` / `recommend_to_items` contract.
    """

    recommends_for_warm: bool = False
    recommends_for_cold: bool = False

    config_class: tp.Type[ModelConfig_T]

    def __init__(self, *args: tp.Any, verbose: int = 0, **kwargs: tp.Any) -> None:
        self.is_fitted = False
        self.verbose = verbose

    @property
    def require_recommend_context(self) -> bool:
        """Whether `recommend` requires a `context` dataframe (e.g. time-aware HSTU)."""
        return False

    # ------------------------------------------------------------------ config

    def get_config(
        self, mode: tp.Literal["pydantic", "dict"] = "dict", simple_types: bool = False
    ) -> tp.Union[ModelConfig_T, tp.Dict[str, tp.Any]]:
        """Typed config; `simple_types=True` gives a JSON-serializable dict."""
        config = self._get_config()
        if mode == "pydantic":
            if simple_types:
                raise ValueError("`simple_types` is not compatible with `mode='pydantic'`")
            return config
        if mode != "dict":
            raise ValueError(f"Unknown mode: {mode}")
        pydantic_mode = "json" if simple_types else "python"
        try:
            return config.model_dump(mode=pydantic_mode)
        except PydanticSerializationError as e:  # pragma: no cover
            if e.__cause__ is not None:
                raise e.__cause__
            raise e

    def _get_config(self) -> ModelConfig_T:
        raise NotImplementedError(f"`get_config` method is not implemented for `{self.__class__.__name__}` model")

    def get_params(self, simple_types: bool = False, sep: str = ".") -> tp.Dict[str, tp.Any]:
        """Flat-dict view of the config."""
        return make_dict_flat(self.get_config(mode="dict", simple_types=simple_types), sep=sep)

    @classmethod
    def from_config(cls, config: tp.Union[dict, ModelConfig_T]) -> tpe.Self:
        """Instantiate from a typed config or a plain dict."""
        try:
            config_cls = cls.config_class
        except AttributeError:
            raise NotImplementedError(f"`from_config` method is not implemented for `{cls.__name__}` model.") from None
        if not isinstance(config, config_cls):
            config_obj = config_cls.model_validate(config)
        else:
            config_obj = config
        if config_obj.cls is not None and config_obj.cls is not cls:
            raise TypeError(f"`{cls.__name__}` is used, but config is for `{config_obj.cls.__name__}`")
        return cls._from_config(config_obj)

    @classmethod
    def from_params(cls, params: tp.Dict[str, tp.Any], sep: str = ".") -> tpe.Self:
        return cls.from_config(unflatten_dict(params, sep=sep))

    @classmethod
    def _from_config(cls, config: ModelConfig_T) -> tpe.Self:
        raise NotImplementedError()

    # ---------------------------------------------------------------- save/load

    def save(self, f: FileLike) -> int:
        data = self.dumps()
        if isinstance(f, (str, Path)):
            return Path(f).write_bytes(data)
        return f.write(data)

    def dumps(self) -> bytes:
        return pickle.dumps(self, protocol=PICKLE_PROTOCOL)

    @classmethod
    def load(cls, f: FileLike) -> tpe.Self:
        return cls.loads(read_bytes(f))

    @classmethod
    def loads(cls, data: bytes) -> tpe.Self:
        loaded = pickle.loads(data)
        if loaded.__class__ is not cls:
            raise TypeError(f"Loaded object is not a direct instance of `{cls.__name__}`")
        return loaded

    # ----------------------------------------------------------------------- fit

    def fit(self: T, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> T:
        """Fit from scratch."""
        self._fit(dataset, *args, **kwargs)
        self.is_fitted = True
        return self

    def _fit(self, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError()

    def fit_partial(self, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> tpe.Self:
        """Resume training from current state."""
        self._fit_partial(dataset, *args, **kwargs)
        self.is_fitted = True
        return self

    def _fit_partial(self, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(f"Partial fitting is not supported in {self.__class__.__name__}")

    # ------------------------------------------------------------- dataset hooks

    def _custom_transform_dataset_u2i(
        self,
        dataset: Dataset,
        users: ExternalIds,
        on_unsupported_targets: ErrorBehaviour,
        context: tp.Optional[pd.DataFrame] = None,
    ) -> Dataset:
        return dataset

    def _custom_transform_dataset_i2i(
        self, dataset: Dataset, target_items: ExternalIds, on_unsupported_targets: ErrorBehaviour
    ) -> Dataset:
        return dataset

    # ------------------------------------------------------------------ recommend

    def warmup(
        self,
        dataset: Dataset,
        k: int,
        filter_viewed: tp.Union[bool, tp.Tuple[bool, ...]] = (True, False),
        items_to_recommend: tp.Optional[ExternalIds] = None,
        context: tp.Optional[pd.DataFrame] = None,
        n_users: int = 4096,
    ) -> "ModelBase":
        """Pre-compile the serving path so the first real query is warm.

        The first ``recommend`` builds the CUDA kernels (or loads them from
        the build cache) and warms PyTorch's allocator. This runs a throwaway
        serving-sized recommend for each ``filter_viewed`` variant so a
        server's first real query does not pay for that. Pass the same
        ``items_to_recommend`` / ``context`` the server will use.
        """
        hot_users = dataset.user_id_map.external_ids[: dataset.n_hot_users]
        if len(hot_users) == 0:
            raise ValueError("warmup needs a dataset with at least one hot user")
        variants = (filter_viewed,) if isinstance(filter_viewed, bool) else tuple(filter_viewed)
        for fv in variants:
            self.recommend(
                users=hot_users[:n_users],
                dataset=dataset,
                k=k,
                filter_viewed=fv,
                items_to_recommend=items_to_recommend,
                context=context,
                on_unsupported_targets="ignore",
            )
        return self

    def recommend(
        self,
        users: ExternalIds,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        items_to_recommend: tp.Optional[ExternalIds] = None,
        add_rank_col: bool = True,
        on_unsupported_targets: ErrorBehaviour = "raise",
        context: tp.Optional[pd.DataFrame] = None,
    ) -> pd.DataFrame:
        """U2I recommendations table (user_id, item_id, score[, rank]).

        Orchestration per reference base.py:385-519: context validation ->
        custom dataset transform -> whitelist to sorted internal ids ->
        hot/warm/cold target split -> per-class recommend -> external ids ->
        rank column.
        """
        if self.require_recommend_context and context is None:
            raise ValueError(
                "This model requires `context` to be provided for recommendations generation. "
                "Check docs and examples for details."
            )
        if not self.require_recommend_context and context is not None:
            context = None
            warnings.warn(
                "You are providing context to a model that does not require it. Context is set to 'None'",
                UserWarning,
            )
        self._check_is_fitted()
        self._check_k(k)
        original_user_type = dataset.user_id_map.external_dtype
        original_item_type = dataset.item_id_map.external_dtype
        dataset = self._custom_transform_dataset_u2i(dataset, users, on_unsupported_targets, context)

        sorted_item_ids_to_recommend = self._get_sorted_item_ids_to_recommend(items_to_recommend, dataset)

        hot_ids, warm_ids, cold_ids = self._split_targets_by_hot_warm_cold(users, dataset, "user")
        hot_ids, warm_ids, cold_ids = self._check_targets_are_valid(
            hot_ids, warm_ids, cold_ids, "user", on_unsupported_targets
        )

        reco_hot: InternalRecoTriplet = ([], [], [])
        reco_warm: InternalRecoTriplet = ([], [], [])
        reco_cold: SemiInternalRecoTriplet = ([], [], [])

        if hot_ids.size > 0:
            reco_hot = self._recommend_u2i(hot_ids, dataset, k, filter_viewed, sorted_item_ids_to_recommend)
        if warm_ids.size > 0:
            if self.recommends_for_warm:
                reco_warm = self._recommend_u2i_warm(warm_ids, dataset, k, sorted_item_ids_to_recommend)
            else:
                reco_warm = self._recommend_cold(warm_ids, dataset, k, sorted_item_ids_to_recommend)
        if cold_ids.size > 0:
            reco_cold = self._recommend_cold(cold_ids, dataset, k, sorted_item_ids_to_recommend)

        reco_hot = self._adjust_reco_types(reco_hot)
        reco_warm = self._adjust_reco_types(reco_warm)
        reco_cold = self._adjust_reco_types(reco_cold, target_type=dataset.user_id_map.external_dtype)

        reco_hot_final = self._reco_to_external(reco_hot, dataset.user_id_map, dataset.item_id_map)
        reco_warm_final = self._reco_to_external(reco_warm, dataset.user_id_map, dataset.item_id_map)
        reco_cold_final = self._reco_items_to_external(reco_cold, dataset.item_id_map)

        reco_hot_final = self._adjust_reco_types(reco_hot_final, original_user_type, original_item_type)
        reco_warm_final = self._adjust_reco_types(reco_warm_final, original_user_type, original_item_type)
        reco_cold_final = self._adjust_reco_types(reco_cold_final, original_user_type, original_item_type)

        reco_all = self._concat_reco((reco_hot_final, reco_warm_final, reco_cold_final))
        return self._make_reco_table(reco_all, Columns.User, add_rank_col)

    def recommend_to_items(
        self,
        target_items: ExternalIds,
        dataset: Dataset,
        k: int,
        filter_itself: bool = True,
        items_to_recommend: tp.Optional[ExternalIds] = None,
        add_rank_col: bool = True,
        on_unsupported_targets: ErrorBehaviour = "raise",
    ) -> pd.DataFrame:
        """I2I recommendations table (target_item_id, item_id, score[, rank]).

        With `filter_itself`, k+1 items are requested and the target itself is
        dropped (reference base.py:521-646, 744-753).
        """
        self._check_is_fitted()
        self._check_k(k)
        original_item_type = dataset.item_id_map.external_dtype
        dataset = self._custom_transform_dataset_i2i(dataset, target_items, on_unsupported_targets)

        sorted_item_ids_to_recommend = self._get_sorted_item_ids_to_recommend(items_to_recommend, dataset)

        hot_ids, warm_ids, cold_ids = self._split_targets_by_hot_warm_cold(target_items, dataset, "item")
        hot_ids, warm_ids, cold_ids = self._check_targets_are_valid(
            hot_ids, warm_ids, cold_ids, "item", on_unsupported_targets
        )

        requested_k = k + 1 if filter_itself else k

        reco_hot: InternalRecoTriplet = ([], [], [])
        reco_warm: InternalRecoTriplet = ([], [], [])
        reco_cold: SemiInternalRecoTriplet = ([], [], [])

        if hot_ids.size > 0:
            reco_hot = self._recommend_i2i(hot_ids, dataset, requested_k, sorted_item_ids_to_recommend)
        if warm_ids.size > 0:
            if self.recommends_for_warm:
                reco_warm = self._recommend_i2i_warm(warm_ids, dataset, requested_k, sorted_item_ids_to_recommend)
            else:
                reco_warm = self._recommend_cold(warm_ids, dataset, requested_k, sorted_item_ids_to_recommend)
        if cold_ids.size > 0:
            # `k`, not `requested_k`: cold reco are never self-filtered.
            reco_cold = self._recommend_cold(cold_ids, dataset, k, sorted_item_ids_to_recommend)

        reco_hot = self._adjust_reco_types(reco_hot)
        reco_warm = self._adjust_reco_types(reco_warm)
        reco_cold = self._adjust_reco_types(reco_cold, target_type=dataset.item_id_map.external_dtype)

        if filter_itself:
            reco_hot = self._filter_item_itself_from_i2i_reco(reco_hot, k)
            reco_warm = self._filter_item_itself_from_i2i_reco(reco_warm, k)

        reco_hot_final = self._reco_to_external(reco_hot, dataset.item_id_map, dataset.item_id_map)
        reco_warm_final = self._reco_to_external(reco_warm, dataset.item_id_map, dataset.item_id_map)
        reco_cold_final = self._reco_items_to_external(reco_cold, dataset.item_id_map)

        reco_hot_final = self._adjust_reco_types(reco_hot_final, original_item_type, original_item_type)
        reco_warm_final = self._adjust_reco_types(reco_warm_final, original_item_type, original_item_type)
        reco_cold_final = self._adjust_reco_types(reco_cold_final, original_item_type, original_item_type)

        reco_all = self._concat_reco((reco_hot_final, reco_warm_final, reco_cold_final))
        return self._make_reco_table(reco_all, Columns.TargetItem, add_rank_col)

    # --------------------------------------------------------------- internals

    def _check_is_fitted(self) -> None:
        if not self.is_fitted:
            raise NotFittedError(self.__class__.__name__)

    @classmethod
    def _check_k(cls, k: int) -> None:
        if not isinstance(k, (int, np.integer)) or k <= 0:
            raise ValueError("`k` must be positive integer")

    @classmethod
    def _get_sorted_item_ids_to_recommend(
        cls, items_to_recommend: tp.Optional[ExternalIds], dataset: Dataset
    ) -> tp.Optional[InternalIdsArray]:
        if items_to_recommend is None:
            return None
        internal = dataset.item_id_map.convert_to_internal(items_to_recommend, strict=False)
        return np.unique(internal)

    @classmethod
    def _split_targets_by_hot_warm_cold(
        cls,
        targets: ExternalIds,
        dataset: Dataset,
        entity: tp.Literal["user", "item"],
    ) -> tp.Tuple[InternalIdsArray, InternalIdsArray, ExternalIdsArray]:
        if entity == "user":
            id_map, n_hot = dataset.user_id_map, dataset.n_hot_users
        else:
            id_map, n_hot = dataset.item_id_map, dataset.n_hot_items
        known_ids, cold_ids = id_map.convert_to_internal(targets, strict=False, return_missing=True)
        try:
            cold_ids = cold_ids.astype(id_map.external_dtype)
        except ValueError:
            raise TypeError(
                f"Given {entity} ids must be convertible to the {entity}_id type in dataset ({id_map.external_dtype})"
            )
        hot_mask = known_ids < n_hot
        return known_ids[hot_mask], known_ids[~hot_mask], cold_ids

    @classmethod
    def _check_targets_are_valid(
        cls,
        hot_targets: InternalIdsArray,
        warm_targets: InternalIdsArray,
        cold_targets: ExternalIdsArray,
        entity: tp.Literal["user", "item"],
        on_unsupported_targets: ErrorBehaviour,
    ) -> tp.Tuple[InternalIdsArray, InternalIdsArray, ExternalIdsArray]:
        if warm_targets.size > 0 and not cls.recommends_for_warm and not cls.recommends_for_cold:
            explanation = (
                f"Model `{cls}` doesn't support recommendations for warm and cold {entity}s, "
                f"but some of given {entity}s are warm: they are not in the interactions."
            )
            if on_unsupported_targets == "warn":
                warnings.warn(explanation)
            elif on_unsupported_targets == "raise":
                raise ValueError(explanation)
            warm_targets = np.asarray([])

        if cold_targets.size > 0 and not cls.recommends_for_cold:
            explanation = (
                f"Model `{cls}` doesn't support recommendations for cold {entity}s, "
                f"but some of given {entity}s are cold: they are not in the `dataset.{entity}_id_map`."
            )
            if on_unsupported_targets == "warn":
                warnings.warn(explanation)
            elif on_unsupported_targets == "raise":
                raise ValueError(explanation)
            cold_targets = np.asarray([])
        return hot_targets, warm_targets, cold_targets

    @classmethod
    def _adjust_reco_types(
        cls, reco: RecoTriplet, target_type: tp.Any = np.int64, item_type: tp.Any = np.int64
    ) -> RecoTriplet:
        target_ids, item_ids, scores = reco
        return (
            np.asarray(target_ids, dtype=target_type),
            np.asarray(item_ids, dtype=item_type),
            np.asarray(scores, dtype=np.float32),
        )

    @classmethod
    def _filter_item_itself_from_i2i_reco(cls, reco: RecoTriplet, k: int) -> RecoTriplet:
        target_ids, item_ids, scores = reco
        keep = target_ids != item_ids
        t, i, s = target_ids[keep], item_ids[keep], scores[keep]
        # Per-target head(k): positions within each contiguous target group.
        if len(t) == 0:
            return t, i, s
        new_group = np.concatenate(([True], t[1:] != t[:-1]))
        group_start = np.maximum.accumulate(np.where(new_group, np.arange(len(t)), 0))
        pos_in_group = np.arange(len(t)) - group_start
        head_mask = pos_in_group < k
        return t[head_mask], i[head_mask], s[head_mask]

    @classmethod
    def _reco_to_external(cls, reco: RecoTriplet, target_id_map: tp.Any, item_id_map: tp.Any) -> RecoTriplet:
        target_ids, item_ids, scores = reco
        return (
            target_id_map.convert_to_external(target_ids),
            item_id_map.convert_to_external(item_ids),
            scores,
        )

    @classmethod
    def _reco_items_to_external(cls, reco: RecoTriplet, item_id_map: tp.Any) -> RecoTriplet:
        target_ids, item_ids, scores = reco
        return target_ids, item_id_map.convert_to_external(item_ids), scores

    @classmethod
    def _concat_reco(cls, parts: tp.Sequence[RecoTriplet]) -> RecoTriplet:
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
        )

    @classmethod
    def _make_reco_table(cls, reco: RecoTriplet, target_col: str, add_rank_col: bool) -> pd.DataFrame:
        target_ids, item_ids, scores = reco
        df = pd.DataFrame({target_col: target_ids, Columns.Item: item_ids, Columns.Score: scores})
        if add_rank_col:
            # pandas' hashed groupby cumcount measured FASTER than a
            # factorize+stable-argsort numpy formulation at 1M reco rows
            # (37 ms vs ~1.8 s on this host) — keep the simple form
            df[Columns.Rank] = df.groupby(target_col, sort=False).cumcount() + 1
        return df

    # ----------------------------------------------------------- abstract hooks

    def _recommend_cold(
        self,
        target_ids: ExternalIdsArray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray],
    ) -> SemiInternalRecoTriplet:
        raise NotImplementedError()

    def _recommend_u2i_warm(
        self,
        user_ids: InternalIdsArray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray],
    ) -> InternalRecoTriplet:
        raise NotImplementedError()

    def _recommend_i2i_warm(
        self,
        target_ids: InternalIdsArray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray],
    ) -> InternalRecoTriplet:
        raise NotImplementedError()

    def _recommend_u2i(
        self,
        user_ids: InternalIdsArray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray],
    ) -> InternalRecoTriplet:
        raise NotImplementedError()

    def _recommend_i2i(
        self,
        target_ids: InternalIdsArray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray],
    ) -> InternalRecoTriplet:
        raise NotImplementedError()


ModelConfig.model_rebuild()


class FixedColdRecoModelMixin:
    """Cold recommendations = one fixed list tiled for all cold targets
    (reference base.py:843-867)."""

    def _recommend_cold(
        self,
        target_ids: ExternalIdsArray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray],
    ) -> SemiInternalRecoTriplet:
        item_ids, scores = self._get_cold_reco(dataset, k, sorted_item_ids_to_recommend)
        reco_target_ids = np.repeat(target_ids, len(item_ids))
        reco_item_ids = np.tile(item_ids, len(target_ids))
        reco_scores = np.tile(scores, len(target_ids))
        return reco_target_ids, reco_item_ids, reco_scores

    def _get_cold_reco(
        self, dataset: Dataset, k: int, sorted_item_ids_to_recommend: tp.Optional[InternalIdsArray]
    ) -> tp.Tuple[tp.Any, tp.Any]:
        raise NotImplementedError()
