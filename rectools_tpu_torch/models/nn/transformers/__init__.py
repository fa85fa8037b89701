from .backbone import TransformerBackbone, TransformerBackboneBase
from .base import TransformerModelBase, TransformerModelConfig
from .callbacks import BestStateKeeper, EarlyStopping, TrainingCallback
from .convert import flax_params_to_state_dict, state_dict_to_flax_params
from .data_preparator import BatchLoader, SequenceDataset, TransformerDataPreparatorBase, scatter_left_padded
from .hstu import HSTUModel, HSTUModelConfig, RelativeAttentionBias, STULayer, STULayers
from .net_blocks import (
    LearnableInversePositionalEncoding,
    MultiHeadAttention,
    PointWiseFeedForward,
    PositionalEncodingBase,
    TransformerLayersBase,
)
from .sasrec import (
    SASRecDataPreparator,
    SASRecModel,
    SASRecModelConfig,
    SASRecTransformerLayer,
    SASRecTransformerLayers,
)
from .similarity import DistanceSimilarityModule, SimilarityModuleBase
from .training import TransformerTrainingModule, TransformerTrainingModuleBase

__all__ = [
    "BatchLoader",
    "BestStateKeeper",
    "EarlyStopping",
    "HSTUModel",
    "HSTUModelConfig",
    "RelativeAttentionBias",
    "STULayer",
    "STULayers",
    "TrainingCallback",
    "TransformerTrainingModuleBase",
    "state_dict_to_flax_params",
    "DistanceSimilarityModule",
    "LearnableInversePositionalEncoding",
    "MultiHeadAttention",
    "PointWiseFeedForward",
    "PositionalEncodingBase",
    "SASRecDataPreparator",
    "SASRecModel",
    "SASRecModelConfig",
    "SASRecTransformerLayer",
    "SASRecTransformerLayers",
    "SequenceDataset",
    "SimilarityModuleBase",
    "TransformerBackbone",
    "TransformerBackboneBase",
    "TransformerDataPreparatorBase",
    "TransformerLayersBase",
    "TransformerModelBase",
    "TransformerModelConfig",
    "TransformerTrainingModule",
    "flax_params_to_state_dict",
    "scatter_left_padded",
]
