from .context import get_context
from .dataset import Dataset, DatasetSchema, DatasetSchemaDict, EntitySchema, IdMapSchema
from .features import (
    DIRECT_FEATURE_VALUE,
    AbsentIdError,
    DenseFeatures,
    Features,
    SparseFeatures,
)
from .identifiers import IdMap
from .interactions import Interactions

__all__ = [
    "get_context",
    "Dataset",
    "DatasetSchema",
    "DatasetSchemaDict",
    "EntitySchema",
    "IdMapSchema",
    "DIRECT_FEATURE_VALUE",
    "AbsentIdError",
    "DenseFeatures",
    "Features",
    "SparseFeatures",
    "IdMap",
    "Interactions",
]
