"""TransformerModelBase: wires preparator, item net and backbone from swappable
component types; owns recommend and weight loading.

Port of rectools_tpu/models/nn/transformers/base.py, serving half. The
config keeps the JAX model's hyper-parameters (training ones included, so a
JAX config carries over) plus ``device``. ``fit`` raises until the training
slice lands; weights come in through :meth:`load_jax_params`.
"""

import typing as tp

import numpy as np
import pandas as pd
import typing_extensions as tpe
from pydantic import BeforeValidator, PlainSerializer

from ....dataset.dataset import Dataset
from ....types import ExternalIds
from ....utils.device import resolve_device
from ....utils.misc import get_class_or_function_full_path, import_object
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
from .net_blocks import LearnableInversePositionalEncoding, PositionalEncodingBase, TransformerLayersBase
from .similarity import DistanceSimilarityModule, SimilarityModuleBase
from .training import TRAINING_NOT_PORTED, TransformerTrainingModule

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
SimilarityModuleType = _class_path_annotated(SimilarityModuleBase)
TransformerBackboneType = _class_path_annotated(TransformerBackboneBase)
TransformerDataPreparatorType = _class_path_annotated(TransformerDataPreparatorBase)
ItemNetConstructorType = _class_path_annotated(ItemNetConstructorBase)

ItemNetBlockTypes = tpe.Annotated[
    tp.Sequence[tp.Type[ItemNetBase]],
    BeforeValidator(_get_class_obj_sequence),
    PlainSerializer(func=_serialize_type_sequence, return_type=tp.Tuple[str, ...], when_used="json"),
]

ValMaskCallable = tp.Callable[..., np.ndarray]
ValMaskCallableSerialized = tpe.Annotated[
    ValMaskCallable,
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
    transformer_layers_type: TransformerLayersType
    similarity_module_type: SimilarityModuleType = DistanceSimilarityModule
    backbone_type: TransformerBackboneType = TransformerBackbone
    get_val_mask_func: tp.Optional[ValMaskCallableSerialized] = None
    get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None
    data_preparator_kwargs: tp.Optional[InitKwargs] = None
    transformer_layers_kwargs: tp.Optional[InitKwargs] = None
    item_net_constructor_kwargs: tp.Optional[InitKwargs] = None
    pos_encoding_kwargs: tp.Optional[InitKwargs] = None
    similarity_module_kwargs: tp.Optional[InitKwargs] = None
    backbone_kwargs: tp.Optional[InitKwargs] = None
    device: str = "cuda"


TransformerModelConfig_T = tp.TypeVar("TransformerModelConfig_T", bound=TransformerModelConfig)


class TransformerModelBase(ModelBase[TransformerModelConfig_T]):
    """Base class for transformer sequential recommenders."""

    config_class: tp.Type[TransformerModelConfig_T]

    def __init__(
        self,
        data_preparator_type: tp.Type[TransformerDataPreparatorBase],
        transformer_layers_type: tp.Type[TransformerLayersBase],
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
        similarity_module_type: tp.Type[SimilarityModuleBase] = DistanceSimilarityModule,
        backbone_type: tp.Type[TransformerBackboneBase] = TransformerBackbone,
        get_val_mask_func: tp.Optional[ValMaskCallable] = None,
        get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None,
        data_preparator_kwargs: tp.Optional[InitKwargs] = None,
        transformer_layers_kwargs: tp.Optional[InitKwargs] = None,
        item_net_constructor_kwargs: tp.Optional[InitKwargs] = None,
        pos_encoding_kwargs: tp.Optional[InitKwargs] = None,
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
        self.similarity_module_type = similarity_module_type
        self.backbone_type = backbone_type
        self.get_val_mask_func = get_val_mask_func
        self.get_val_mask_func_kwargs = get_val_mask_func_kwargs
        self.data_preparator_kwargs = data_preparator_kwargs
        self.transformer_layers_kwargs = transformer_layers_kwargs
        self.item_net_constructor_kwargs = item_net_constructor_kwargs
        self.pos_encoding_kwargs = pos_encoding_kwargs
        self.similarity_module_kwargs = similarity_module_kwargs
        self.backbone_kwargs = backbone_kwargs

        self.data_preparator: TransformerDataPreparatorBase = self.data_preparator_type(
            session_max_len=self.session_max_len,
            batch_size=self.batch_size,
            train_min_user_interactions=self.train_min_user_interactions,
            get_val_mask_func=self.get_val_mask_func,
            get_val_mask_func_kwargs=self.get_val_mask_func_kwargs,
            **self._get_kwargs(self.data_preparator_kwargs),
        )
        self.training_module: TransformerTrainingModule

    # ------------------------------------------------------------ construction

    @staticmethod
    def _get_kwargs(actual_kwargs: tp.Optional[InitKwargs]) -> InitKwargs:
        return actual_kwargs if actual_kwargs is not None else {}

    def _construct_item_net(self, dataset: Dataset) -> ItemNetBase:
        return self.item_net_constructor_type.from_dataset(
            dataset,
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

    def _build_model_from_dataset(self, dataset: Dataset) -> None:
        """The same construction the JAX ``fit`` runs first
        (rectools_tpu/models/nn/transformers/base.py:352)."""
        self.data_preparator.process_dataset_train(dataset)
        backbone = self._init_backbone(self._construct_item_net(self.data_preparator.train_dataset))
        self.training_module = TransformerTrainingModule(backbone=backbone, device=self._device)

    def load_jax_params(self, dataset: Dataset, params: tp.Mapping[str, tp.Any]) -> tpe.Self:
        """Build the model for ``dataset`` as the JAX ``fit`` does, load the
        JAX package's parameter tree (nested dicts of numpy arrays, flax
        layout) and mark the model fitted."""
        self._build_model_from_dataset(dataset)
        self.backbone.load_state_dict(flax_params_to_state_dict(params), strict=True)
        self.is_fitted = True
        return self

    # -------------------------------------------------------------------- fit

    def _fit(self, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(TRAINING_NOT_PORTED)

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

    @property
    def backbone(self) -> TransformerBackboneBase:
        """The torch backbone module."""
        return self.training_module.backbone
