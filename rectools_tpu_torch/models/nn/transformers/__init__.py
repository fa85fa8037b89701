from .backbone import TransformerBackbone, TransformerBackboneBase
from .base import TransformerModelBase, TransformerModelConfig
from .bert4rec import BERT4RecDataPreparator, BERT4RecModel, BERT4RecModelConfig
from .callbacks import BestStateKeeper, EarlyStopping, TrainingCallback
from .convert import flax_params_to_state_dict, state_dict_to_flax_params
from .data_preparator import BatchLoader, SequenceDataset, TransformerDataPreparatorBase, scatter_left_padded
from .hstu import HSTUModel, HSTUModelConfig, RelativeAttentionBias, STULayer, STULayers
from .ligr import LiGRLayer, LiGRLayers
from .net_blocks import (
    LearnableInversePositionalEncoding,
    MultiHeadAttention,
    PointWiseFeedForward,
    PositionalEncodingBase,
    PreLNTransformerLayer,
    PreLNTransformerLayers,
    SwigluFeedForward,
    TransformerLayersBase,
    init_feed_forward,
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
from .utils import leave_one_out_mask

__all__ = [
    "BERT4RecDataPreparator",
    "BERT4RecModel",
    "BERT4RecModelConfig",
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
    "LiGRLayer",
    "LiGRLayers",
    "MultiHeadAttention",
    "PointWiseFeedForward",
    "PositionalEncodingBase",
    "PreLNTransformerLayer",
    "PreLNTransformerLayers",
    "SASRecDataPreparator",
    "SASRecModel",
    "SASRecModelConfig",
    "SASRecTransformerLayer",
    "SASRecTransformerLayers",
    "SequenceDataset",
    "SimilarityModuleBase",
    "SwigluFeedForward",
    "TransformerBackbone",
    "TransformerBackboneBase",
    "TransformerDataPreparatorBase",
    "TransformerLayersBase",
    "TransformerModelBase",
    "TransformerModelConfig",
    "TransformerTrainingModule",
    "flax_params_to_state_dict",
    "init_feed_forward",
    "leave_one_out_mask",
    "scatter_left_padded",
]
