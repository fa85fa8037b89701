"""TransformerModelBase: wires preparator, item net, backbone and training
module from swappable component types; owns fit, fit_partial, recommend,
weight loading and checkpoints.

Port of rectools_tpu/models/nn/transformers/base.py. The config keeps the JAX
model's hyper-parameters, so a JAX config carries over, plus ``device``.
Weights trained by the JAX package come in through :meth:`load_jax_params`.

Checkpoints (``save_checkpoint``, ``load_from_checkpoint``,
``load_weights_from_checkpoint``, ``save`` / ``load_model``, pickling) hold
the config, the train dataset's schema, the item ids and the training state
with every tensor on the CPU, so they do not depend on the device: a loaded
model builds on its config's ``device``, and
``load_from_checkpoint(path, model_params_update={"device": "cpu"})`` gives a
CPU copy of a model fitted on the card. A checkpoint file is read without
building the model it holds (see :func:`_read_checkpoint`), so the update is
applied before anything is put on a device.
"""

import contextvars
import pickle
import typing as tp
from collections.abc import Callable

import numpy as np
import pandas as pd
import torch
import typing_extensions as tpe
from pydantic import BeforeValidator, PlainSerializer

from ....dataset.dataset import Dataset, DatasetSchema, DatasetSchemaDict
from ....dataset.identifiers import IdMap
from ....types import ExternalIds
from ....utils.device import resolve_device
from ....utils.misc import get_class_or_function_full_path, import_object, make_dict_flat, unflatten_dict
from ....utils.serialization import FileLike, read_bytes
from ...base import ErrorBehaviour, InternalRecoTriplet, ModelBase, ModelConfig
from ..item_net import (
    CatFeaturesItemNet,
    IdEmbeddingsItemNet,
    ItemNetBase,
    ItemNetConstructorBase,
    SumOfEmbeddingsConstructor,
)
from .backbone import TransformerBackbone, TransformerBackboneBase
from .convert import flax_params_to_state_dict
from .data_preparator import InitKwargs, TransformerDataPreparatorBase
from .losses import requires_negatives
from .negative_sampler import CatalogUniformSampler, TransformerNegativeSamplerBase
from .net_blocks import (
    LearnableInversePositionalEncoding,
    PositionalEncodingBase,
    PreLNTransformerLayers,
    TransformerLayersBase,
)
from .similarity import DistanceSimilarityModule, SimilarityModuleBase
from .training import TransformerTrainingModule, TransformerTrainingModuleBase

# set while a checkpoint file is read: unpickled models keep their state
# unrestored (see _read_checkpoint)
_DEFER_RESTORE: contextvars.ContextVar[bool] = contextvars.ContextVar("defer_restore", default=False)

# ---------------------------------------------------------------- config types


def _get_class_obj(spec: tp.Any) -> tp.Any:
    if not isinstance(spec, str):
        return spec
    return import_object(spec)


def _get_class_obj_sequence(spec: tp.Sequence[tp.Any]) -> tp.Tuple[tp.Any, ...]:
    return tuple(map(_get_class_obj, spec))


def _serialize_type_sequence(obj: tp.Sequence[tp.Type]) -> tp.Tuple[str, ...]:
    return tuple(map(get_class_or_function_full_path, obj))


def _class_path_annotated(base: tp.Any) -> tp.Any:
    return tpe.Annotated[
        tp.Type[base],
        BeforeValidator(_get_class_obj),
        PlainSerializer(func=get_class_or_function_full_path, return_type=str, when_used="json"),
    ]


PositionalEncodingType = _class_path_annotated(PositionalEncodingBase)
TransformerLayersType = _class_path_annotated(TransformerLayersBase)
TransformerTrainingModuleType = _class_path_annotated(TransformerTrainingModuleBase)
TransformerNegativeSamplerType = _class_path_annotated(TransformerNegativeSamplerBase)
SimilarityModuleType = _class_path_annotated(SimilarityModuleBase)
TransformerBackboneType = _class_path_annotated(TransformerBackboneBase)
TransformerDataPreparatorType = _class_path_annotated(TransformerDataPreparatorBase)
ItemNetConstructorType = _class_path_annotated(ItemNetConstructorBase)

ItemNetBlockTypes = tpe.Annotated[
    tp.Sequence[tp.Type[ItemNetBase]],
    BeforeValidator(_get_class_obj_sequence),
    PlainSerializer(func=_serialize_type_sequence, return_type=tp.Tuple[str, ...], when_used="json"),
]

ValMaskCallable = Callable[..., np.ndarray]
ValMaskCallableSerialized = tpe.Annotated[
    ValMaskCallable,
    BeforeValidator(_get_class_obj),
    PlainSerializer(func=get_class_or_function_full_path, return_type=str, when_used="json"),
]

# factory of fresh training callbacks for each fit, serialized as an import path
CallbacksCallable = Callable[[], tp.Sequence[tp.Any]]
CallbacksCallableSerialized = tpe.Annotated[
    CallbacksCallable,
    BeforeValidator(_get_class_obj),
    PlainSerializer(func=get_class_or_function_full_path, return_type=str, when_used="json"),
]


class TransformerModelConfig(ModelConfig):
    """Transformer model base config (reference transformers/base.py:189-232)."""

    data_preparator_type: TransformerDataPreparatorType
    n_blocks: int = 2
    n_heads: int = 4
    n_factors: int = 256
    use_pos_emb: bool = True
    use_causal_attn: bool = False
    use_key_padding_mask: bool = False
    dropout_rate: float = 0.2
    session_max_len: int = 100
    batch_size: int = 128
    loss: str = "softmax"
    n_negatives: int = 1
    gbce_t: float = 0.2
    lr: float = 0.001
    epochs: int = 3
    deterministic: bool = False
    seed: int = 0
    recommend_batch_size: tp.Optional[int] = None
    train_min_user_interactions: int = 2
    item_net_block_types: ItemNetBlockTypes = (IdEmbeddingsItemNet, CatFeaturesItemNet)
    item_net_constructor_type: ItemNetConstructorType = SumOfEmbeddingsConstructor
    pos_encoding_type: PositionalEncodingType = LearnableInversePositionalEncoding
    transformer_layers_type: TransformerLayersType = PreLNTransformerLayers
    training_module_type: TransformerTrainingModuleType = TransformerTrainingModule
    negative_sampler_type: TransformerNegativeSamplerType = CatalogUniformSampler
    similarity_module_type: SimilarityModuleType = DistanceSimilarityModule
    backbone_type: TransformerBackboneType = TransformerBackbone
    get_val_mask_func: tp.Optional[ValMaskCallableSerialized] = None
    get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None
    get_callbacks_func: tp.Optional[CallbacksCallableSerialized] = None
    data_preparator_kwargs: tp.Optional[InitKwargs] = None
    transformer_layers_kwargs: tp.Optional[InitKwargs] = None
    item_net_constructor_kwargs: tp.Optional[InitKwargs] = None
    pos_encoding_kwargs: tp.Optional[InitKwargs] = None
    training_module_kwargs: tp.Optional[InitKwargs] = None
    negative_sampler_kwargs: tp.Optional[InitKwargs] = None
    similarity_module_kwargs: tp.Optional[InitKwargs] = None
    backbone_kwargs: tp.Optional[InitKwargs] = None
    device: str = "cuda"


TransformerModelConfig_T = tp.TypeVar("TransformerModelConfig_T", bound=TransformerModelConfig)


class TransformerModelBase(ModelBase[TransformerModelConfig_T]):
    """Base class for transformer sequential recommenders."""

    config_class: tp.Type[TransformerModelConfig_T]
    train_loss_name: str = "train_loss"
    val_loss_name: str = "val_loss"

    def __init__(
        self,
        data_preparator_type: tp.Type[TransformerDataPreparatorBase],
        transformer_layers_type: tp.Type[TransformerLayersBase] = PreLNTransformerLayers,
        n_blocks: int = 2,
        n_heads: int = 4,
        n_factors: int = 256,
        use_pos_emb: bool = True,
        use_causal_attn: bool = False,
        use_key_padding_mask: bool = False,
        dropout_rate: float = 0.2,
        session_max_len: int = 100,
        batch_size: int = 128,
        loss: str = "softmax",
        n_negatives: int = 1,
        gbce_t: float = 0.2,
        lr: float = 0.001,
        epochs: int = 3,
        verbose: int = 0,
        deterministic: bool = False,
        seed: int = 0,
        recommend_batch_size: tp.Optional[int] = None,
        train_min_user_interactions: int = 2,
        item_net_block_types: tp.Sequence[tp.Type[ItemNetBase]] = (IdEmbeddingsItemNet, CatFeaturesItemNet),
        item_net_constructor_type: tp.Type[ItemNetConstructorBase] = SumOfEmbeddingsConstructor,
        pos_encoding_type: tp.Type[PositionalEncodingBase] = LearnableInversePositionalEncoding,
        training_module_type: tp.Type[TransformerTrainingModuleBase] = TransformerTrainingModule,
        negative_sampler_type: tp.Type[TransformerNegativeSamplerBase] = CatalogUniformSampler,
        similarity_module_type: tp.Type[SimilarityModuleBase] = DistanceSimilarityModule,
        backbone_type: tp.Type[TransformerBackboneBase] = TransformerBackbone,
        get_val_mask_func: tp.Optional[ValMaskCallable] = None,
        get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None,
        get_callbacks_func: tp.Optional[CallbacksCallable] = None,
        data_preparator_kwargs: tp.Optional[InitKwargs] = None,
        transformer_layers_kwargs: tp.Optional[InitKwargs] = None,
        item_net_constructor_kwargs: tp.Optional[InitKwargs] = None,
        pos_encoding_kwargs: tp.Optional[InitKwargs] = None,
        training_module_kwargs: tp.Optional[InitKwargs] = None,
        negative_sampler_kwargs: tp.Optional[InitKwargs] = None,
        similarity_module_kwargs: tp.Optional[InitKwargs] = None,
        backbone_kwargs: tp.Optional[InitKwargs] = None,
        device: str = "cuda",
    ) -> None:
        super().__init__(verbose=verbose)
        self._device = resolve_device(device)
        self.device = device
        self.data_preparator_type = data_preparator_type
        self.transformer_layers_type = transformer_layers_type
        self.n_blocks = n_blocks
        self.n_heads = n_heads
        self.n_factors = n_factors
        self.use_pos_emb = use_pos_emb
        self.use_causal_attn = use_causal_attn
        self.use_key_padding_mask = use_key_padding_mask
        self.dropout_rate = dropout_rate
        self.session_max_len = session_max_len
        self.batch_size = batch_size
        self.loss = loss
        self.n_negatives = n_negatives
        self.gbce_t = gbce_t
        self.lr = lr
        self.epochs = epochs
        self.deterministic = deterministic
        self.seed = seed
        self.recommend_batch_size = recommend_batch_size
        self.train_min_user_interactions = train_min_user_interactions
        self.item_net_block_types = item_net_block_types
        self.item_net_constructor_type = item_net_constructor_type
        self.pos_encoding_type = pos_encoding_type
        self.training_module_type = training_module_type
        self.negative_sampler_type = negative_sampler_type
        self.similarity_module_type = similarity_module_type
        self.backbone_type = backbone_type
        self.get_val_mask_func = get_val_mask_func
        self.get_val_mask_func_kwargs = get_val_mask_func_kwargs
        self.get_callbacks_func = get_callbacks_func
        self.data_preparator_kwargs = data_preparator_kwargs
        self.transformer_layers_kwargs = transformer_layers_kwargs
        self.item_net_constructor_kwargs = item_net_constructor_kwargs
        self.pos_encoding_kwargs = pos_encoding_kwargs
        self.training_module_kwargs = training_module_kwargs
        self.negative_sampler_kwargs = negative_sampler_kwargs
        self.similarity_module_kwargs = similarity_module_kwargs
        self.backbone_kwargs = backbone_kwargs

        self.data_preparator: TransformerDataPreparatorBase
        self._init_data_preparator()
        self.training_module: TransformerTrainingModuleBase
        self._dataset_schema: tp.Optional[DatasetSchemaDict] = None  # the train dataset's, for checkpoints

    # ------------------------------------------------------------ construction

    @staticmethod
    def _get_kwargs(actual_kwargs: tp.Optional[InitKwargs]) -> InitKwargs:
        return actual_kwargs if actual_kwargs is not None else {}

    def _init_data_preparator(self) -> None:
        needs_negatives = requires_negatives(self.loss)
        self.data_preparator = self.data_preparator_type(
            session_max_len=self.session_max_len,
            batch_size=self.batch_size,
            train_min_user_interactions=self.train_min_user_interactions,
            negative_sampler=self._init_negative_sampler() if needs_negatives else None,
            n_negatives=self.n_negatives if needs_negatives else None,
            get_val_mask_func=self.get_val_mask_func,
            get_val_mask_func_kwargs=self.get_val_mask_func_kwargs,
            **self._data_preparator_extra_kwargs(),
        )

    def _data_preparator_extra_kwargs(self) -> InitKwargs:
        return self._get_kwargs(self.data_preparator_kwargs)

    def _init_negative_sampler(self) -> TransformerNegativeSamplerBase:
        return self.negative_sampler_type(
            n_negatives=self.n_negatives, **self._get_kwargs(self.negative_sampler_kwargs)
        )

    def _construct_item_net(self, dataset: Dataset) -> ItemNetBase:
        return self.item_net_constructor_type.from_dataset(
            dataset,
            self.n_factors,
            self.dropout_rate,
            self.item_net_block_types,
            device=self._device,
            **self._get_kwargs(self.item_net_constructor_kwargs),
        )

    def _construct_item_net_from_dataset_schema(self, dataset_schema: DatasetSchema) -> ItemNetBase:
        return self.item_net_constructor_type.from_dataset_schema(
            dataset_schema,
            self.n_factors,
            self.dropout_rate,
            self.item_net_block_types,
            device=self._device,
            **self._get_kwargs(self.item_net_constructor_kwargs),
        )

    def _init_pos_encoding_layer(self) -> PositionalEncodingBase:
        return self.pos_encoding_type(
            self.use_pos_emb,
            self.session_max_len,
            self.n_factors,
            device=self._device,
            **self._get_kwargs(self.pos_encoding_kwargs),
        )

    def _init_transformer_layers(self) -> TransformerLayersBase:
        return self.transformer_layers_type(
            n_blocks=self.n_blocks,
            n_factors=self.n_factors,
            n_heads=self.n_heads,
            dropout_rate=self.dropout_rate,
            device=self._device,
            **self._get_kwargs(self.transformer_layers_kwargs),
        )

    def _init_similarity_module(self) -> SimilarityModuleBase:
        return self.similarity_module_type(**self._get_kwargs(self.similarity_module_kwargs))

    def _init_backbone(self, item_model: ItemNetBase) -> TransformerBackboneBase:
        return self.backbone_type(
            item_model=item_model,
            pos_encoding_layer=self._init_pos_encoding_layer(),
            transformer_layers=self._init_transformer_layers(),
            similarity_module=self._init_similarity_module(),
            n_heads=self.n_heads,
            dropout_rate=self.dropout_rate,
            use_causal_attn=self.use_causal_attn,
            use_key_padding_mask=self.use_key_padding_mask,
            **self._get_kwargs(self.backbone_kwargs),
        )

    def _init_training_module(self, backbone: TransformerBackboneBase) -> None:
        self.training_module = self.training_module_type(
            backbone=backbone,
            device=self._device,
            data_preparator=self.data_preparator,
            item_extra_tokens=self.data_preparator.item_extra_tokens,
            lr=self.lr,
            loss=self.loss,
            gbce_t=self.gbce_t,
            verbose=self.verbose,
            train_loss_name=self.train_loss_name,
            val_loss_name=self.val_loss_name,
            adam_betas=(0.9, 0.98),
            seed=self.seed,
            **self._training_module_extra_kwargs(),
        )

    def _training_module_extra_kwargs(self) -> InitKwargs:
        kwargs = dict(self._get_kwargs(self.training_module_kwargs))
        if self.get_callbacks_func is not None and "callbacks" not in kwargs:
            kwargs["callbacks"] = self.get_callbacks_func()  # fresh instances per fit
        return kwargs

    def _build_model_from_dataset(self, dataset: Dataset) -> None:
        """The construction the JAX ``fit`` runs first
        (rectools_tpu/models/nn/transformers/base.py:352)."""
        self.data_preparator.process_dataset_train(dataset)
        backbone = self._init_backbone(self._construct_item_net(self.data_preparator.train_dataset))
        self._init_training_module(backbone)
        self._dataset_schema = self.data_preparator.train_dataset.get_schema()

    def load_jax_params(self, dataset: Dataset, params: tp.Mapping[str, tp.Any]) -> tpe.Self:
        """Build the model for ``dataset`` as the JAX ``fit`` does, load the
        JAX package's parameter tree (nested dicts of numpy arrays, flax
        layout) and mark the model fitted."""
        self._build_model_from_dataset(dataset)
        self.training_module.load_params(flax_params_to_state_dict(params))
        self.is_fitted = True
        return self

    # -------------------------------------------------------------------- fit

    def _fit(self, dataset: Dataset) -> None:
        self._build_model_from_dataset(dataset)
        self.training_module.fit(
            train_loader_factory=self.data_preparator.get_dataloader_train,
            val_loader_factory=self.data_preparator.get_dataloader_val,
            max_epochs=self.epochs,
        )

    def _fit_partial(
        self, dataset: Dataset, min_epochs: tp.Optional[int] = None, max_epochs: tp.Optional[int] = None
    ) -> None:
        """Continue training for `max_epochs` more epochs (reference
        transformers/base.py:505-533); the same dataset is expected."""
        if max_epochs is None:
            max_epochs = self.epochs
        if not self.is_fitted:
            self._build_model_from_dataset(dataset)
        else:
            self.data_preparator.process_dataset_train(dataset)
        self.training_module.fit(
            train_loader_factory=self.data_preparator.get_dataloader_train,
            val_loader_factory=self.data_preparator.get_dataloader_val,
            max_epochs=max_epochs,
        )

    # --------------------------------------------------------------- recommend

    def _custom_transform_dataset_u2i(
        self,
        dataset: Dataset,
        users: ExternalIds,
        on_unsupported_targets: ErrorBehaviour,
        context: tp.Optional[pd.DataFrame] = None,
    ) -> Dataset:
        return self.data_preparator.transform_dataset_u2i(dataset, users, context)

    def _custom_transform_dataset_i2i(
        self, dataset: Dataset, target_items: ExternalIds, on_unsupported_targets: ErrorBehaviour
    ) -> Dataset:
        return self.data_preparator.transform_dataset_i2i(dataset)

    def _effective_recommend_batch_size(self) -> int:
        """Serving batch size: explicit value, or a fixed session-activation
        budget (batch * session_max_len * n_factors * 4 bytes ~ 256 MB, with an
        attention-score cap for long sessions), clamped to [64, 8192] and
        rounded down to a power of two — the JAX package's formula
        (rectools_tpu/models/nn/transformers/base.py:410-431)."""
        if self.recommend_batch_size is not None:
            return self.recommend_batch_size
        act_budget = 256 << 20
        per_row_act = max(1, self.session_max_len * self.n_factors * 4)
        score_budget = 2 << 30
        per_row_scores = self.n_heads * self.session_max_len**2 * 4 * 2
        raw = min(act_budget // per_row_act, score_budget // max(1, per_row_scores))
        clamped = max(64, min(8192, int(raw)))
        return 1 << (clamped.bit_length() - 1)

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> InternalRecoTriplet:
        if sorted_item_ids_to_recommend is None:
            sorted_item_ids_to_recommend = self.data_preparator.get_known_items_sorted_internal_ids()
        recommend_loader = self.data_preparator.get_dataloader_recommend(
            dataset, self._effective_recommend_batch_size()
        )
        return self.training_module.recommend_u2i(
            user_ids=user_ids,
            recommend_loader=recommend_loader,
            sorted_item_ids_to_recommend=sorted_item_ids_to_recommend,
            k=k,
            dataset=dataset,
            filter_viewed=filter_viewed,
        )

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> InternalRecoTriplet:
        if sorted_item_ids_to_recommend is None:
            sorted_item_ids_to_recommend = self.data_preparator.get_known_items_sorted_internal_ids()
        return self.training_module.recommend_i2i(
            target_ids=target_ids,
            sorted_item_ids_to_recommend=sorted_item_ids_to_recommend,
            k=k,
        )

    # ------------------------------------------------------------------ config

    @classmethod
    def _from_config(cls, config: TransformerModelConfig_T) -> tpe.Self:
        params = config.model_dump()
        params.pop("cls")
        return cls(**params)

    def _get_config(self) -> TransformerModelConfig_T:
        attrs = self.config_class.model_json_schema(mode="serialization")["properties"].keys()
        params = {attr: getattr(self, attr) for attr in attrs if attr != "cls"}
        params["cls"] = self.__class__
        return self.config_class(**params)

    # ------------------------------------------------------------- checkpoints

    def _checkpoint_dict(self) -> tp.Dict[str, tp.Any]:
        """Everything a fitted model is rebuilt from, every tensor on the CPU
        (the JAX package's checkpoint dict; ``item_net_buffers`` holds the
        categorical blocks' CSR coordinates, which are not in the
        ``state_dict``)."""
        buffers = {
            i: {"feature_rows": block.feature_rows.cpu().numpy(), "feature_cols": block.feature_cols.cpu().numpy()}
            for i, block in enumerate(self.backbone.item_model.item_net_blocks)
            if isinstance(block, CatFeaturesItemNet)
        }
        return {
            "model_config": self.get_config(simple_types=True),
            "dataset_schema": self._dataset_schema,
            "item_external_ids": np.asarray(self.data_preparator.item_id_map.external_ids),
            "item_net_buffers": buffers,
            "state": self.training_module.get_state(),
        }

    @classmethod
    def _model_from_checkpoint(cls, checkpoint: tp.Dict[str, tp.Any]) -> tpe.Self:
        """Rebuild a fitted model from a checkpoint dict on its config's
        device (reference transformers/base.py:591-654)."""
        loaded = cls.from_config(checkpoint["model_config"])
        loaded.data_preparator.item_id_map = IdMap(checkpoint["item_external_ids"])
        loaded.data_preparator._init_extra_token_ids()  # pylint: disable=protected-access
        item_model = loaded._construct_item_net_from_dataset_schema(
            DatasetSchema.model_validate(checkpoint["dataset_schema"])
        )
        for i, buffers in (checkpoint.get("item_net_buffers") or {}).items():
            block = item_model.item_net_blocks[i]
            for name, value in buffers.items():
                setattr(block, name, torch.as_tensor(value, dtype=torch.int64, device=loaded._device))
        loaded._init_training_module(loaded._init_backbone(item_model))
        loaded._dataset_schema = checkpoint["dataset_schema"]
        loaded.training_module.set_state(checkpoint["state"])
        loaded.is_fitted = True
        return loaded

    @classmethod
    def _restore(
        cls, state: tp.Dict[str, tp.Any], model_params_update: tp.Optional[tp.Dict[str, tp.Any]] = None
    ) -> tpe.Self:
        """The model a :meth:`__getstate__` payload describes, its config
        first updated by flat keys."""
        fitted = "fitted_checkpoint" in state
        config = state["fitted_checkpoint"]["model_config"] if fitted else state["model_config"]
        if model_params_update:
            flat = make_dict_flat(config)
            flat.update(model_params_update)
            config = unflatten_dict(flat)
        if fitted:
            return cls._model_from_checkpoint({**state["fitted_checkpoint"], "model_config": config})
        return cls.from_config(config)

    def __getstate__(self) -> object:
        if self.is_fitted:
            return {"fitted_checkpoint": self._checkpoint_dict()}
        return {"model_config": self.get_config(simple_types=True)}

    def __setstate__(self, state: tp.Dict[str, tp.Any]) -> None:
        if _DEFER_RESTORE.get():
            self.__dict__["_unrestored_state"] = state
            return
        self.__dict__.update(type(self)._restore(state).__dict__)

    def save_checkpoint(self, f: FileLike) -> int:
        """Write a standalone checkpoint file of a fitted model."""
        if not self.is_fitted:
            raise RuntimeError("Only fitted models can be checkpointed")
        return self.save(f)

    @classmethod
    def load_from_checkpoint(
        cls,
        checkpoint_path: FileLike,
        model_params_update: tp.Optional[tp.Dict[str, tp.Any]] = None,
    ) -> tpe.Self:
        """Load a model from a checkpoint file, its config first updated by
        flat keys (reference transformers/base.py:678-710), e.g.
        ``{"device": "cpu"}`` or ``{"recommend_batch_size": 256}``."""
        shell = _read_checkpoint(checkpoint_path)
        if not isinstance(shell, cls):
            raise TypeError(f"Loaded object is not an instance of `{cls.__name__}`")
        return type(shell)._restore(shell._unrestored_state, model_params_update)

    def load_weights_from_checkpoint(self, checkpoint_path: FileLike) -> None:
        """Load the parameters, optimizer state and counters of a checkpoint
        into this fitted model (reference transformers/base.py:712-725)."""
        if getattr(self, "training_module", None) is None:
            raise RuntimeError("Model weights cannot be loaded from checkpoint into unfitted model")
        state = _read_checkpoint(checkpoint_path)._unrestored_state
        if "fitted_checkpoint" not in state:
            raise RuntimeError("The checkpoint holds an unfitted model")
        self.training_module.set_state(state["fitted_checkpoint"]["state"])

    @property
    def backbone(self) -> TransformerBackboneBase:
        """The torch backbone module."""
        return self.training_module.backbone


def _read_checkpoint(f: FileLike) -> TransformerModelBase:
    """Unpickle a checkpoint file without building the model: the object
    returned is an empty instance of the saved class whose
    ``_unrestored_state`` is its :meth:`TransformerModelBase.__getstate__`
    payload."""
    token = _DEFER_RESTORE.set(True)
    try:
        shell = pickle.loads(read_bytes(f))
    finally:
        _DEFER_RESTORE.reset(token)
    if not isinstance(shell, TransformerModelBase):
        raise TypeError(f"The checkpoint holds a `{type(shell).__name__}`, not a transformer model")
    return shell
