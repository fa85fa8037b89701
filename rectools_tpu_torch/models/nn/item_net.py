"""Item-embedding towers — port of rectools_tpu/models/nn/item_net.py.

Every block exposes ``embed_catalog()``, the dense (n_items, d) table of the
whole catalog:

- ``IdEmbeddingsItemNet``: one ``nn.Embedding``; the PAD row (internal id 0)
  is zeroed at use, as ``emb.at[0].set(0.0)`` does in the JAX block.
  ``padding_idx`` is not relied on: converted weights may carry a nonzero
  row 0.
- ``CatFeaturesItemNet``: ``EmbeddingBag(mode="sum")`` over the item
  categorical one-hot indices becomes a gather plus ``index_add_`` over the
  CSR (item, feature) coordinates.
- ``SumOfEmbeddingsConstructor`` sums the block outputs.
"""

import typing as tp
import warnings

import numpy as np
import torch
from torch import nn

from ...dataset.dataset import Dataset, DatasetSchema
from ...dataset.features import SparseFeatures


class ItemNetBase(nn.Module):
    """Base class for item towers. Subclasses implement ``embed_catalog``."""

    def embed_catalog(self) -> torch.Tensor:
        """Return (n_items, n_factors) embeddings for the full catalog."""
        raise NotImplementedError()

    @classmethod
    def from_dataset(cls, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> tp.Optional["ItemNetBase"]:
        """Construct the block from a Dataset (or return None if unsupported)."""
        raise NotImplementedError()


class IdEmbeddingsItemNet(ItemNetBase):
    """Id-embedding block (reference item_net.py:236-331)."""

    def __init__(
        self, n_items: int, n_factors: int, dropout_rate: float, device: tp.Optional[torch.device] = None
    ) -> None:
        super().__init__()
        self.n_items = n_items
        self.n_factors = n_factors
        self.dropout_rate = dropout_rate
        self.ids_emb = nn.Embedding(n_items, n_factors, device=device)

    def embed_catalog(self) -> torch.Tensor:
        emb = self.ids_emb.weight
        return torch.cat([emb.new_zeros((1, emb.shape[1])), emb[1:]], dim=0)

    @classmethod
    def from_dataset(
        cls, dataset: Dataset, n_factors: int, dropout_rate: float, device: tp.Optional[torch.device] = None,
        **kwargs: tp.Any,
    ) -> "IdEmbeddingsItemNet":
        return cls(n_items=dataset.item_id_map.size, n_factors=n_factors, dropout_rate=dropout_rate, device=device)


class CatFeaturesItemNet(ItemNetBase):
    """Categorical-features block: sum of ``cat_emb`` rows over each item's
    feature values (reference item_net.py:60-233). ``feature_rows`` /
    ``feature_cols`` are the COO coordinates of the item categorical-feature
    CSR, kept as non-persistent buffers (they come from the dataset)."""

    def __init__(
        self,
        n_items: int,
        n_cat_feature_values: int,
        n_factors: int,
        dropout_rate: float,
        feature_rows: np.ndarray,
        feature_cols: np.ndarray,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.n_items = n_items
        self.n_factors = n_factors
        self.dropout_rate = dropout_rate
        self.cat_emb = nn.Embedding(n_cat_feature_values, n_factors, device=device)
        self.register_buffer(
            "feature_rows", torch.as_tensor(feature_rows, dtype=torch.int64, device=device), persistent=False
        )
        self.register_buffer(
            "feature_cols", torch.as_tensor(feature_cols, dtype=torch.int64, device=device), persistent=False
        )

    def embed_catalog(self) -> torch.Tensor:
        weight = self.cat_emb.weight
        out = weight.new_zeros((self.n_items, weight.shape[1]))
        return out.index_add_(0, self.feature_rows, weight[self.feature_cols])

    @staticmethod
    def _warn_for_unsupported_dataset_schema(dataset_schema: DatasetSchema) -> None:
        if dataset_schema.items.features is None:
            warnings.warn("Ignoring `CatFeaturesItemNet` block because dataset doesn't contain item features.")
        elif dataset_schema.items.features.kind == "dense":
            warnings.warn(
                "Ignoring `CatFeaturesItemNet` block because dataset item features are dense and "
                "one-hot-encoded categorical features were not created when constructing dataset."
            )
        elif len(dataset_schema.items.features.cat_feature_indices) == 0:
            warnings.warn(
                "Ignoring `CatFeaturesItemNet` block because dataset item features do not contain "
                "categorical features."
            )

    @classmethod
    def from_dataset(
        cls, dataset: Dataset, n_factors: int, dropout_rate: float, device: tp.Optional[torch.device] = None,
        **kwargs: tp.Any,
    ) -> tp.Optional["CatFeaturesItemNet"]:
        dataset_schema = DatasetSchema.model_validate(dataset.get_schema())
        cls._warn_for_unsupported_dataset_schema(dataset_schema)
        if isinstance(dataset.item_features, SparseFeatures):
            item_cat_features = dataset.item_features.get_cat_features()
            if item_cat_features.values.size == 0:
                return None
            csr = item_cat_features.values.tocsr()
            rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))
            return cls(
                n_items=csr.shape[0],
                n_cat_feature_values=len(item_cat_features.names),
                n_factors=n_factors,
                dropout_rate=dropout_rate,
                feature_rows=rows,
                feature_cols=csr.indices.astype(np.int64),
                device=device,
            )
        return None


class ItemNetConstructorBase(ItemNetBase):
    """Aggregates item-net blocks (reference item_net.py:334-451)."""

    def __init__(self, n_items: int, item_net_blocks: tp.Sequence[ItemNetBase]) -> None:
        super().__init__()
        self.n_items = n_items
        self.item_net_blocks = nn.ModuleList(item_net_blocks)

    @classmethod
    def from_dataset(
        cls,
        dataset: Dataset,
        n_factors: int,
        dropout_rate: float,
        item_net_block_types: tp.Sequence[tp.Type[ItemNetBase]],
        device: tp.Optional[torch.device] = None,
        **kwargs: tp.Any,
    ) -> "ItemNetConstructorBase":
        item_net_blocks: tp.List[ItemNetBase] = []
        for block_type in item_net_block_types:
            block = block_type.from_dataset(dataset, n_factors, dropout_rate, device=device)
            if block is not None:
                item_net_blocks.append(block)
        return cls(n_items=dataset.item_id_map.size, item_net_blocks=item_net_blocks)


class SumOfEmbeddingsConstructor(ItemNetConstructorBase):
    """Sum of block outputs (reference item_net.py:451-488)."""

    def embed_catalog(self) -> torch.Tensor:
        if len(self.item_net_blocks) == 0:
            raise ValueError("At least one type of net to calculate item embeddings should be provided.")
        out = None
        for block in self.item_net_blocks:
            emb = block.embed_catalog()
            out = emb if out is None else out + emb
        return out
