"""Item-embedding towers — port of rectools_tpu/models/nn/item_net.py.

Every block exposes ``embed_catalog()``, the dense (n_items, d) table of the
whole catalog:

- ``IdEmbeddingsItemNet``: one ``nn.Embedding``; the PAD row (internal id 0)
  is zeroed at use, as ``emb.at[0].set(0.0)`` does in the JAX block.
  ``padding_idx`` is not relied on: converted weights may carry a nonzero
  row 0.
- ``CatFeaturesItemNet``: ``EmbeddingBag(mode="sum")`` over the item
  categorical one-hot indices becomes a gather plus ``index_add_`` over the
  CSR (item, feature) coordinates, followed by :class:`HashDropout`.
- ``SumOfEmbeddingsConstructor`` sums the block outputs.

Under a process mesh the two tables are column-sharded over the model axis
when ``n_factors`` divides by its size (the JAX package's
``_MODEL_SHARDED_PARAM_NAMES``): a rank owns ``(rows, n_factors / n_model)``
columns of the table and of its Adam state. ``embed_catalog`` computes this
rank's columns and all-gathers the others inside the model group; the
backward keeps this rank's columns of the gradient, with no reduction,
because the ranks of a model group see the same batch rows.
"""

import typing as tp
import warnings

import numpy as np
import torch
from torch import nn

from ...dataset.dataset import Dataset, DatasetSchema, SparseFeaturesSchema
from ...dataset.features import SparseFeatures
from ...parallel import collectives
from ...parallel.mesh import MODEL_AXIS, ProcessMesh
from .dropout import HashDropout


def _column_range(n_columns: int, mesh: ProcessMesh) -> tp.Tuple[int, int]:
    per_rank = n_columns // mesh.size(MODEL_AXIS)
    start = mesh.index(MODEL_AXIS) * per_rank
    return start, start + per_rank


class _GatherColumns(torch.autograd.Function):
    """(rows, d / n_model) on each rank of the model group -> (rows, d) on all."""

    @staticmethod
    def forward(ctx, local, mesh: ProcessMesh):  # type: ignore[override]
        ctx.mesh = mesh
        return torch.cat(collectives.all_gather(local, mesh.group(MODEL_AXIS)), dim=1)

    @staticmethod
    def backward(ctx, grad):  # type: ignore[override]
        start, stop = _column_range(grad.shape[1], ctx.mesh)
        return grad[:, start:stop].contiguous(), None


class ItemNetBase(nn.Module):
    """Base class for item towers. Subclasses implement ``embed_catalog``.
    A block with an item-vocabulary table names it in ``table_name``."""

    table_name: tp.Optional[str] = None
    column_mesh: tp.Optional[ProcessMesh] = None  # set by shard_columns

    def shard_columns(self, mesh: ProcessMesh) -> bool:
        """Keep only this rank's columns of the block's table (a no-op, False,
        when the block has none, the model axis has one rank or the width does
        not divide)."""
        n_model = mesh.size(MODEL_AXIS)
        if self.table_name is None or n_model == 1 or self.column_mesh is not None:
            return self.column_mesh is not None
        table = getattr(self, self.table_name)
        if table.weight.shape[1] % n_model != 0:
            return False
        start, stop = _column_range(table.weight.shape[1], mesh)
        table.weight = nn.Parameter(table.weight.detach()[:, start:stop].clone())
        self.column_mesh = mesh
        return True

    def _whole(self, local: torch.Tensor) -> torch.Tensor:
        """All columns of a tensor computed from this rank's table columns."""
        return local if self.column_mesh is None else _GatherColumns.apply(local, self.column_mesh)

    def embed_catalog(self) -> torch.Tensor:
        """Return (n_items, n_factors) embeddings for the full catalog."""
        raise NotImplementedError()

    @classmethod
    def from_dataset(cls, dataset: Dataset, *args: tp.Any, **kwargs: tp.Any) -> tp.Optional["ItemNetBase"]:
        """Construct the block from a Dataset (or return None if unsupported)."""
        raise NotImplementedError()

    @classmethod
    def from_dataset_schema(
        cls, dataset_schema: DatasetSchema, *args: tp.Any, **kwargs: tp.Any
    ) -> tp.Optional["ItemNetBase"]:
        """Construct the block from a dataset schema (checkpoint restore: the
        weights are loaded afterwards)."""
        raise NotImplementedError()


class IdEmbeddingsItemNet(ItemNetBase):
    """Id-embedding block (reference item_net.py:236-331)."""

    table_name = "ids_emb"

    def __init__(
        self, n_items: int, n_factors: int, dropout_rate: float, device: tp.Optional[torch.device] = None
    ) -> None:
        super().__init__()
        self.n_items = n_items
        self.n_factors = n_factors
        self.dropout_rate = dropout_rate
        self.ids_emb = nn.Embedding(n_items, n_factors, device=device)

    def embed_catalog(self) -> torch.Tensor:
        emb = self._whole(self.ids_emb.weight)
        return torch.cat([emb.new_zeros((1, emb.shape[1])), emb[1:]], dim=0)

    @classmethod
    def from_dataset(
        cls, dataset: Dataset, n_factors: int, dropout_rate: float, device: tp.Optional[torch.device] = None,
        **kwargs: tp.Any,
    ) -> "IdEmbeddingsItemNet":
        return cls(n_items=dataset.item_id_map.size, n_factors=n_factors, dropout_rate=dropout_rate, device=device)

    @classmethod
    def from_dataset_schema(
        cls, dataset_schema: DatasetSchema, n_factors: int, dropout_rate: float,
        device: tp.Optional[torch.device] = None, **kwargs: tp.Any,
    ) -> "IdEmbeddingsItemNet":
        return cls(n_items=dataset_schema.items.n_hot, n_factors=n_factors, dropout_rate=dropout_rate, device=device)


class CatFeaturesItemNet(ItemNetBase):
    """Categorical-features block: sum of ``cat_emb`` rows over each item's
    feature values (reference item_net.py:60-233). ``feature_rows`` /
    ``feature_cols`` are the COO coordinates of the item categorical-feature
    CSR, kept as buffers outside the ``state_dict`` (they come from the
    dataset); a checkpoint carries them beside the weights
    (``TransformerModelBase._checkpoint_dict``)."""

    table_name = "cat_emb"

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
        self.dropout = HashDropout(dropout_rate)
        self.register_buffer(
            "feature_rows", torch.as_tensor(feature_rows, dtype=torch.int64, device=device), persistent=False
        )
        self.register_buffer(
            "feature_cols", torch.as_tensor(feature_cols, dtype=torch.int64, device=device), persistent=False
        )

    def embed_catalog(self) -> torch.Tensor:
        weight = self.cat_emb.weight
        out = weight.new_zeros((self.n_items, weight.shape[1]))
        return self.dropout(self._whole(out.index_add_(0, self.feature_rows, weight[self.feature_cols])))

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

    @classmethod
    def from_dataset_schema(
        cls, dataset_schema: DatasetSchema, n_factors: int, dropout_rate: float,
        device: tp.Optional[torch.device] = None, **kwargs: tp.Any,
    ) -> tp.Optional["CatFeaturesItemNet"]:
        """Placeholder coordinates of the schema's size; a checkpoint restore
        sets the real ones (reference item_net.py:193-228 does the same)."""
        cls._warn_for_unsupported_dataset_schema(dataset_schema)
        features_schema = dataset_schema.items.features
        if isinstance(features_schema, SparseFeaturesSchema) and len(features_schema.cat_feature_indices) > 0:
            nnz = features_schema.cat_n_stored_values
            return cls(
                n_items=dataset_schema.items.n_hot,
                n_cat_feature_values=len(features_schema.cat_feature_indices),
                n_factors=n_factors,
                dropout_rate=dropout_rate,
                feature_rows=np.zeros(nnz, dtype=np.int64),
                feature_cols=np.zeros(nnz, dtype=np.int64),
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

    @classmethod
    def from_dataset_schema(
        cls,
        dataset_schema: DatasetSchema,
        n_factors: int,
        dropout_rate: float,
        item_net_block_types: tp.Sequence[tp.Type[ItemNetBase]],
        device: tp.Optional[torch.device] = None,
        **kwargs: tp.Any,
    ) -> "ItemNetConstructorBase":
        item_net_blocks: tp.List[ItemNetBase] = []
        for block_type in item_net_block_types:
            block = block_type.from_dataset_schema(dataset_schema, n_factors, dropout_rate, device=device)
            if block is not None:
                item_net_blocks.append(block)
        return cls(n_items=dataset_schema.items.n_hot, item_net_blocks=item_net_blocks)


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
