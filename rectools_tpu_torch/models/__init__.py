"""Models of the port: the model base, the heuristic and linear-algebra
models (Popular, PopularInCategory, Random, EASE, PureSVD, ItemKNN), the
factorization models (ALS, BPR, HybridMF), DSSM, the transformer families
(SASRec and eSASRec, BERT4Rec, HSTU) and the serialization helpers: every
name the JAX package's ``models`` exports, with ``TorchRanker`` for
``TPURanker``."""

from .als import ALSModel, ALSModelConfig
from .base import FixedColdRecoModelMixin, ModelBase, ModelConfig
from .bpr import BPRModel, BPRModelConfig
from .ease import EASEModel, EASEModelConfig
from .hybrid_mf import HybridMFModel, HybridMFModelConfig
from .item_knn import ItemKNNModel, ItemKNNModelConfig
from .nn.dssm import DSSMModel, DSSMModelConfig
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

# Aliases under the reference (RecTools) class names, for migrating users.
ImplicitALSWrapperModel = ALSModel
ImplicitBPRWrapperModel = BPRModel
ImplicitItemKNNWrapperModel = ItemKNNModel
LightFMWrapperModel = HybridMFModel

__all__ = [
    "ALSModel",
    "ALSModelConfig",
    "BERT4RecModel",
    "BERT4RecModelConfig",
    "BPRModel",
    "BPRModelConfig",
    "DSSMModel",
    "DSSMModelConfig",
    "Distance",
    "EASEModel",
    "EASEModelConfig",
    "Factors",
    "FixedColdRecoModelMixin",
    "HSTUModel",
    "HSTUModelConfig",
    "HybridMFModel",
    "HybridMFModelConfig",
    "ImplicitALSWrapperModel",
    "ImplicitBPRWrapperModel",
    "ImplicitItemKNNWrapperModel",
    "ItemKNNModel",
    "ItemKNNModelConfig",
    "LightFMWrapperModel",
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
