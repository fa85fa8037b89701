"""Models of the port: the model base and, so far, SASRec serving."""

from .base import ModelBase, ModelConfig
from .nn.transformers.sasrec import SASRecModel
from .rank import Distance, TorchRanker

__all__ = ["Distance", "ModelBase", "ModelConfig", "SASRecModel", "TorchRanker"]
