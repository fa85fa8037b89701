"""Models of the port: the model base and, so far, the transformer families
(SASRec and eSASRec, BERT4Rec, HSTU)."""

from .base import ModelBase, ModelConfig
from .nn.transformers.bert4rec import BERT4RecModel, BERT4RecModelConfig
from .nn.transformers.hstu import HSTUModel
from .nn.transformers.sasrec import SASRecModel
from .rank import Distance, TorchRanker

__all__ = [
    "BERT4RecModel",
    "BERT4RecModelConfig",
    "Distance",
    "HSTUModel",
    "ModelBase",
    "ModelConfig",
    "SASRecModel",
    "TorchRanker",
]
