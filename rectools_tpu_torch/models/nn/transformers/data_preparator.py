"""Host-side data pipeline for sequential transformers — the serving half.

Port of rectools_tpu/models/nn/transformers/data_preparator.py: sessions live
in a CSR-of-sessions structure (flat value arrays + indptr) and every collate
is a vectorised numpy scatter into fixed-shape left-padded batches. This
slice ports what ``recommend`` needs (the train dataset and id maps built by
``process_dataset_train``, the recommend loader, the u2i / i2i dataset
transforms); the train and validation loaders, negative sampling and the
native C++ collation come with the training slice.
"""

import typing as tp
import warnings
from collections.abc import Hashable

import numpy as np
import pandas as pd
from scipy import sparse

from ....columns import Columns
from ....dataset import Dataset, IdMap, Interactions
from ....dataset.features import DenseFeatures, Features, SparseFeatures
from ....types import ExternalIds
from .constants import PADDING_VALUE

InitKwargs = tp.Dict[str, tp.Any]
Batch = tp.Dict[str, np.ndarray]


class SequenceDataset:
    """Sessions in CSR layout: ``items[indptr[i]:indptr[i+1]]`` is session i."""

    def __init__(
        self,
        items: np.ndarray,
        weights: np.ndarray,
        indptr: np.ndarray,
        extras: tp.Optional[tp.Dict[str, np.ndarray]] = None,
    ) -> None:
        self.items = items
        self.weights = weights
        self.indptr = indptr
        self.extras = extras or {}

    def __len__(self) -> int:
        return len(self.indptr) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @classmethod
    def from_interactions(cls, interactions: pd.DataFrame, sort_users: bool = False) -> "SequenceDataset":
        """Group interactions into datetime-sorted sessions.

        ``sort_users=False``: session order = first appearance in the
        datetime-sorted frame; ``sort_users=True``: ascending internal user id
        (recommend path).
        """
        dt_order = np.argsort(interactions[Columns.Datetime].to_numpy(), kind="stable")
        users = interactions[Columns.User].to_numpy()[dt_order]
        if sort_users:
            uniq, codes = np.unique(users, return_inverse=True)
        else:
            codes, uniq = pd.factorize(users)  # first-appearance order
        user_order = np.argsort(codes, kind="stable")
        final_order = dt_order[user_order]

        items = interactions[Columns.Item].to_numpy()[final_order]
        weights = interactions[Columns.Weight].to_numpy(dtype=np.float32)[final_order]
        if weights.size and float(weights.min()) < 0:
            raise ValueError(
                "Interaction weights must be non-negative for transformer training; "
                f"found min weight {float(weights.min())}."
            )
        counts = np.bincount(codes, minlength=len(uniq))
        indptr = np.concatenate(([0], np.cumsum(counts)))

        extra_cols = [c for c in interactions.columns if c not in Columns.Interactions]
        extras = {c: interactions[c].to_numpy()[final_order] for c in extra_cols} if extra_cols else None
        return cls(items=items, weights=weights, indptr=indptr, extras=extras)


def scatter_left_padded(
    values: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    out_len: int,
    dtype: tp.Any,
    fill: tp.Any = 0,
) -> np.ndarray:
    """Vectorised ragged->dense: place ``values[starts[i]:starts[i]+lengths[i]]``
    right-aligned into row i of an (n, out_len) array (left padding). Rows
    longer than ``out_len`` keep their LAST ``out_len`` elements."""
    n = len(starts)
    clipped = np.minimum(lengths, out_len)
    starts = starts + (lengths - clipped)
    lengths = clipped
    out = np.zeros((n, out_len), dtype=dtype) if fill == 0 else np.full((n, out_len), fill, dtype=dtype)
    total = int(lengths.sum())
    if total == 0:
        return out
    row_pos = np.repeat(np.arange(n), lengths)
    within = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    col_pos = np.repeat(out_len - lengths, lengths) + within
    src_idx = np.repeat(starts, lengths) + within
    out[row_pos, col_pos] = values[src_idx]
    return out


class BatchLoader:
    """Iterable over fixed-shape batches; reshuffles (from its own rng stream)
    on every pass when ``shuffle`` is set."""

    def __init__(
        self,
        dataset: SequenceDataset,
        collate_fn: tp.Callable[[SequenceDataset, np.ndarray, tp.Optional[np.random.Generator]], Batch],
        batch_size: int,
        shuffle: bool = False,
        rng: tp.Optional[np.random.Generator] = None,
    ) -> None:
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng

    def __len__(self) -> int:
        return int(np.ceil(len(self.dataset) / self.batch_size))

    def __iter__(self) -> tp.Iterator[Batch]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            if self.rng is None:  # pragma: no cover
                raise ValueError("shuffle requires rng")
            order = self.rng.permutation(n)
        for start in range(0, n, self.batch_size):
            rows = order[start : start + self.batch_size]
            yield self.collate_fn(self.dataset, rows, self.rng)


class TransformerDataPreparatorBase:
    """Train-dataset / id-map processing and the recommend loader
    (reference data_preparator.py:102-469)."""

    train_session_max_len_addition: int = 0
    item_extra_tokens: tp.Sequence[Hashable] = (PADDING_VALUE,)

    def __init__(
        self,
        session_max_len: int,
        batch_size: int,
        train_min_user_interactions: int = 2,
        get_val_mask_func: tp.Optional[tp.Callable] = None,
        get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None,
        extra_cols: tp.Optional[tp.List[str]] = None,
        add_unix_ts: bool = False,
        **kwargs: tp.Any,
    ) -> None:
        self.item_id_map: IdMap
        self.extra_token_ids: tp.Dict
        self.train_dataset: Dataset
        self.val_interactions: tp.Optional[pd.DataFrame] = None
        self.session_max_len = session_max_len
        self.batch_size = batch_size
        self.train_min_user_interactions = train_min_user_interactions
        self.get_val_mask_func = get_val_mask_func
        self.get_val_mask_func_kwargs = get_val_mask_func_kwargs
        self.extra_cols = extra_cols
        self.add_unix_ts = add_unix_ts

    # --------------------------------------------------------------- id helpers

    def get_known_items_sorted_internal_ids(self) -> np.ndarray:
        """Model-internal item ids (extra tokens excluded), sorted."""
        return self.item_id_map.get_sorted_internal()[self.n_item_extra_tokens :]

    def get_known_item_ids(self) -> np.ndarray:
        """External item ids known from fit (extra tokens excluded)."""
        return self.item_id_map.get_external_sorted_by_internal()[self.n_item_extra_tokens :]

    @property
    def n_item_extra_tokens(self) -> int:
        return len(self.item_extra_tokens)

    @staticmethod
    def _ensure_kwargs_dict(actual_kwargs: tp.Optional[InitKwargs]) -> InitKwargs:
        return actual_kwargs if actual_kwargs is not None else {}

    # ----------------------------------------------------------- train dataset

    @staticmethod
    def _process_features_for_id_map(
        raw_features: Features, raw_id_map: IdMap, id_map: IdMap, n_extra_tokens: int
    ) -> Features:
        raw_internal_ids = raw_id_map.convert_to_internal(id_map.get_external_sorted_by_internal()[n_extra_tokens:])
        sorted_features = raw_features.take(raw_internal_ids)
        n_features = sorted_features.values.shape[1]
        dtype = sorted_features.values.dtype

        if isinstance(raw_features, SparseFeatures):
            extra_token_feature_values = sparse.csr_matrix((n_extra_tokens, n_features), dtype=dtype)
            full_feature_values = sparse.vstack([extra_token_feature_values, sorted_features.values], format="csr")
            return SparseFeatures.from_iterables(values=full_feature_values, names=raw_features.names)

        extra_token_feature_values = np.zeros((n_extra_tokens, n_features), dtype=dtype)
        full_feature_values = np.vstack([extra_token_feature_values, sorted_features.values])
        return DenseFeatures.from_iterables(values=full_feature_values, names=raw_features.names)

    def _filter_train_interactions(self, train_interactions: pd.DataFrame) -> pd.DataFrame:
        """Drop short sessions; keep per-user tails (reference data_preparator.py:214-224)."""
        user_stats = train_interactions[Columns.User].value_counts()
        users = user_stats[user_stats >= self.train_min_user_interactions].index
        train_interactions = train_interactions[train_interactions[Columns.User].isin(users)]
        train_interactions = (
            train_interactions.sort_values(Columns.Datetime, kind="stable")
            .groupby(Columns.User, sort=False)
            .tail(self.session_max_len + self.train_session_max_len_addition)
        )
        return train_interactions

    def _convert_to_unix_ts(self, datetime: pd.Series) -> pd.Series:
        return (datetime.values.astype("int64") / 10**9).astype("int64")

    def process_dataset_train(self, dataset: Dataset) -> None:
        """Build the model's train dataset: filter, truncate, new id maps with
        the extra tokens (PAD) first, re-mapped item features, optional val
        split (reference data_preparator.py:229-284)."""
        extra_cols = False if self.extra_cols is None else self.extra_cols
        raw_interactions = dataset.get_raw_interactions(include_extra_cols=extra_cols)
        if self.add_unix_ts:
            raw_interactions["unix_ts"] = self._convert_to_unix_ts(raw_interactions[Columns.Datetime])

        interactions = raw_interactions
        val_mask = None
        if self.get_val_mask_func is not None:
            val_mask = self.get_val_mask_func(
                raw_interactions, **self._ensure_kwargs_dict(self.get_val_mask_func_kwargs)
            )
            interactions = raw_interactions[~val_mask]
            interactions.reset_index(drop=True, inplace=True)

        interactions = self._filter_train_interactions(interactions)

        user_id_map = IdMap.from_values(interactions[Columns.User].to_numpy())
        item_id_map = IdMap.from_values(np.asarray(self.item_extra_tokens, dtype=object))
        item_id_map = item_id_map.add_ids(interactions[Columns.Item].to_numpy())

        item_features = None
        if dataset.item_features is not None:
            item_features = self._process_features_for_id_map(
                dataset.item_features, dataset.item_id_map, item_id_map, self.n_item_extra_tokens
            )

        final_interactions = Interactions.from_raw(interactions, user_id_map, item_id_map, keep_extra_cols=True)
        self.train_dataset = Dataset(user_id_map, item_id_map, final_interactions, item_features=item_features)
        self.item_id_map = self.train_dataset.item_id_map
        self._init_extra_token_ids()

        if self.get_val_mask_func is not None:
            val_targets = raw_interactions[val_mask]
            val_targets = val_targets[
                (val_targets[Columns.User].isin(user_id_map.external_ids))
                & (val_targets[Columns.Item].isin(item_id_map.external_ids))
            ]
            val_interactions = interactions[interactions[Columns.User].isin(val_targets[Columns.User].unique())].copy()
            val_interactions[Columns.Weight] = 0
            val_interactions = pd.concat([val_interactions, val_targets], axis=0)
            self.val_interactions = Interactions.from_raw(
                val_interactions, user_id_map, item_id_map, keep_extra_cols=True
            ).df

    def _init_extra_token_ids(self) -> None:
        extra_token_ids = self.item_id_map.convert_to_internal(self.item_extra_tokens)
        self.extra_token_ids = dict(zip(self.item_extra_tokens, extra_token_ids))

    # -------------------------------------------------------------- dataloaders

    def get_dataloader_recommend(self, dataset: Dataset, batch_size: int) -> BatchLoader:
        """Recommend loader; sessions sorted by internal user id so that row i
        of the stacked embeddings is user i (reference data_preparator.py:331-352)."""
        sequence_dataset = SequenceDataset.from_interactions(dataset.interactions.df, sort_users=True)
        return BatchLoader(
            dataset=sequence_dataset,
            collate_fn=self._collate_fn_recommend,
            batch_size=batch_size,
            shuffle=False,
        )

    # -------------------------------------------------- inference dataset prep

    def transform_dataset_u2i(
        self,
        dataset: Dataset,
        users: ExternalIds,
        context: tp.Optional[pd.DataFrame] = None,
    ) -> Dataset:
        """Keep target users ∩ model-known items; new enumerated user map;
        optional per-user context rows appended with the PAD item
        (reference data_preparator.py:354-424)."""
        required_cols = list(Columns.Interactions)
        if self.extra_cols is not None:
            required_cols = required_cols + self.extra_cols
        interactions = dataset.interactions.df[required_cols]
        users_internal = dataset.user_id_map.convert_to_internal(users, strict=False)
        items_internal = dataset.item_id_map.convert_to_internal(self.get_known_item_ids(), strict=False)
        interactions = interactions[interactions[Columns.User].isin(users_internal)]
        interactions = interactions[interactions[Columns.Item].isin(items_internal)]

        interactions = interactions.copy()
        interactions[Columns.Item] = dataset.item_id_map.convert_to_external(interactions[Columns.Item])
        interactions[Columns.User] = dataset.user_id_map.convert_to_external(interactions[Columns.User])

        rec_user_id_map = IdMap.from_values(interactions[Columns.User].to_numpy())

        if context is not None:
            if not pd.Series(users).isin(context[Columns.User].unique()).all():
                raise ValueError("No context for some target users")
            if context.duplicated(subset=Columns.User).any():
                raise ValueError(
                    "Duplicated user entries found in context. Each user must have exactly one context row."
                )
            context = context.copy()
            context[Columns.Item] = PADDING_VALUE
            context = context[context[Columns.User].isin(interactions[Columns.User].unique())]
            interactions = pd.concat([interactions, context])
        if self.add_unix_ts:
            interactions["unix_ts"] = self._convert_to_unix_ts(interactions[Columns.Datetime])

        n_filtered = len(users) - rec_user_id_map.size
        if n_filtered > 0:
            warnings.warn(f"{n_filtered} target users were considered cold because of missing known items")
        filtered_interactions = Interactions.from_raw(
            interactions, rec_user_id_map, self.item_id_map, keep_extra_cols=True
        )
        return Dataset(rec_user_id_map, self.item_id_map, filtered_interactions)

    def transform_dataset_i2i(self, dataset: Dataset) -> Dataset:
        """Keep model-known items; item map = model item map
        (reference data_preparator.py:426-451)."""
        extra_cols = False if self.extra_cols is None else self.extra_cols
        interactions = dataset.get_raw_interactions(include_extra_cols=extra_cols)
        interactions = interactions[interactions[Columns.Item].isin(self.get_known_item_ids())]
        filtered_interactions = Interactions.from_raw(
            interactions, dataset.user_id_map, self.item_id_map, keep_extra_cols=True
        )
        return Dataset(dataset.user_id_map, self.item_id_map, filtered_interactions)

    # ------------------------------------------------------------------ collates

    def _collate_fn_recommend(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        raise NotImplementedError()

    @staticmethod
    def _left_fill_first_value(t: np.ndarray, lengths_to_pad: np.ndarray) -> np.ndarray:
        """Fill left padding of each row with its first real value."""
        out_len = t.shape[1]
        cols = np.arange(out_len)[None, :]
        first_vals = t[np.arange(len(t)), np.minimum(lengths_to_pad, out_len - 1)]
        return np.where(cols < lengths_to_pad[:, None], first_vals[:, None], t)
