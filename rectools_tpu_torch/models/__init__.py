"""Models of the port: the model base and, so far, SASRec and HSTU."""

from .base import ModelBase, ModelConfig
from .nn.transformers.hstu import HSTUModel
from .nn.transformers.sasrec import SASRecModel
from .rank import Distance, TorchRanker

__all__ = ["Distance", "HSTUModel", "ModelBase", "ModelConfig", "SASRecModel", "TorchRanker"]
