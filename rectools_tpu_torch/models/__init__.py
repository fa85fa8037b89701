"""Models of the port: the model base, the transformer families (SASRec and
eSASRec, BERT4Rec, HSTU) and the serialization helpers."""

from .base import ModelBase, ModelConfig
from .nn.transformers.bert4rec import BERT4RecModel, BERT4RecModelConfig
from .nn.transformers.hstu import HSTUModel, HSTUModelConfig
from .nn.transformers.sasrec import SASRecModel, SASRecModelConfig
from .rank import Distance, TorchRanker
from .serialization import load_model, model_from_config, model_from_params

__all__ = [
    "BERT4RecModel",
    "BERT4RecModelConfig",
    "Distance",
    "HSTUModel",
    "HSTUModelConfig",
    "ModelBase",
    "ModelConfig",
    "SASRecModel",
    "SASRecModelConfig",
    "TorchRanker",
    "load_model",
    "model_from_config",
    "model_from_params",
]
