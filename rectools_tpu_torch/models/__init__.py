"""Models of the port: the model base, the heuristic and linear-algebra
models (Popular, PopularInCategory, Random, EASE, PureSVD, ItemKNN), the
transformer families (SASRec and eSASRec, BERT4Rec, HSTU) and the
serialization helpers."""

from .base import FixedColdRecoModelMixin, ModelBase, ModelConfig
from .ease import EASEModel, EASEModelConfig
from .item_knn import ItemKNNModel, ItemKNNModelConfig
from .nn.transformers.bert4rec import BERT4RecModel, BERT4RecModelConfig
from .nn.transformers.hstu import HSTUModel, HSTUModelConfig
from .nn.transformers.sasrec import SASRecModel, SASRecModelConfig
from .popular import Popularity, PopularModel, PopularModelConfig
from .popular_in_category import PopularInCategoryModel, PopularInCategoryModelConfig
from .pure_svd import PureSVDModel, PureSVDModelConfig
from .random import RandomModel, RandomModelConfig
from .rank import Distance, Ranker, TorchRanker
from .serialization import load_model, model_from_config, model_from_params
from .vector import Factors, VectorModel

# The reference (RecTools) name of the item kNN wrapper, for migrating users.
ImplicitItemKNNWrapperModel = ItemKNNModel

__all__ = [
    "BERT4RecModel",
    "BERT4RecModelConfig",
    "Distance",
    "EASEModel",
    "EASEModelConfig",
    "Factors",
    "FixedColdRecoModelMixin",
    "HSTUModel",
    "HSTUModelConfig",
    "ImplicitItemKNNWrapperModel",
    "ItemKNNModel",
    "ItemKNNModelConfig",
    "ModelBase",
    "ModelConfig",
    "PopularInCategoryModel",
    "PopularInCategoryModelConfig",
    "PopularModel",
    "PopularModelConfig",
    "Popularity",
    "PureSVDModel",
    "PureSVDModelConfig",
    "RandomModel",
    "RandomModelConfig",
    "Ranker",
    "SASRecModel",
    "SASRecModelConfig",
    "TorchRanker",
    "VectorModel",
    "load_model",
    "model_from_config",
    "model_from_params",
]
