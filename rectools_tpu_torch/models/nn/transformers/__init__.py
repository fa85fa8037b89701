from .backbone import TransformerBackbone, TransformerBackboneBase
from .base import TransformerModelBase, TransformerModelConfig
from .convert import flax_params_to_state_dict
from .data_preparator import BatchLoader, SequenceDataset, TransformerDataPreparatorBase, scatter_left_padded
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
from .training import TransformerTrainingModule

__all__ = [
    "BatchLoader",
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
