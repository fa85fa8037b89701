"""Pairwise item distance calculators for diversity metrics.

The port's copy of ``rectools_tpu/metrics/distances.py``.

Behavioral parity with reference rectools/metrics/distances.py:33-160.
"""

import typing as tp
import warnings
from abc import ABC, abstractmethod
from collections.abc import Sequence
from copy import deepcopy

import numpy as np
import pandas as pd

from ..dataset.features import SparseFeatures
from ..dataset.identifiers import IdMap
from ..types import ExternalIds

Distances = np.ndarray


class PairwiseDistanceCalculator(ABC):
    """Item-pair distance lookup with `calculator[items_0, items_1]` access."""

    def __getitem__(self, item_pairs: tp.Tuple[ExternalIds, ExternalIds]) -> Distances:
        if len(item_pairs) != 2:
            raise IndexError("class returns distances only for an item PAIR index sequences")
        if not (self._is_sequence(item_pairs[0]) and self._is_sequence(item_pairs[1])):
            raise TypeError("class returns distances for index SEQUENCES")
        if len(item_pairs[0]) != len(item_pairs[1]):
            raise ValueError("item id sequences must have equal length")
        return self._get_distances_for_item_pairs(item_pairs[0], item_pairs[1])

    @abstractmethod
    def _get_distances_for_item_pairs(self, items_0: ExternalIds, items_1: ExternalIds) -> Distances:
        ...

    @staticmethod
    def _is_sequence(items: ExternalIds) -> bool:
        return isinstance(items, np.ndarray) or (isinstance(items, Sequence) and not isinstance(items, str))


class PairwiseHammingDistanceCalculator(PairwiseDistanceCalculator):
    """Hamming distance over a dense feature dataframe indexed by item id
    (reference distances.py:59-87)."""

    def __init__(self, item_features_df: pd.DataFrame) -> None:
        self.features_df = item_features_df.copy()

    def _get_distances_for_item_pairs(self, items_0: ExternalIds, items_1: ExternalIds) -> Distances:
        features_0 = self.features_df.reindex(items_0).to_numpy(dtype=float)
        features_1 = self.features_df.reindex(items_1).to_numpy(dtype=float)
        absent_0 = np.isnan(features_0).any(axis=1)
        absent_1 = np.isnan(features_1).any(axis=1)
        if absent_0.any() | absent_1.any():
            warnings.warn(
                "Some items has absent feature values"
                " (NaN values in some columns of item_features_df or complete absence of corresponding rows)."
                " Corresponding pair distances are set to NaN."
            )
        result = np.sum(features_0 != features_1, axis=1).astype(np.float64)
        result[absent_0 | absent_1] = np.nan
        return result


class SparsePairwiseHammingDistanceCalculator(PairwiseDistanceCalculator):
    """Hamming distance over sparse features + an id map
    (reference distances.py:89-160).

    >>> from scipy.sparse import csr_matrix
    >>> from rectools_tpu_torch.dataset import IdMap, SparseFeatures
    >>> features_matrix = csr_matrix([[0, 0], [0, 1], [1, 1]])
    >>> features = SparseFeatures(values=features_matrix, names=(("f", 1), ("f", 2)))
    >>> mapper = IdMap.from_values(["i1", "i2", "i3", "i4", "i5"])
    >>> calculator = SparsePairwiseHammingDistanceCalculator(features, mapper)
    >>> calculator[["i1", "i1", "i1"], ["i1", "i2", "i3"]]
    array([0., 1., 2.], dtype=float32)
    """

    def __init__(self, features: SparseFeatures, id_map: IdMap) -> None:
        self.features = features.values.copy()
        self.mapper = deepcopy(id_map)

    def _get_distances_for_item_pairs(self, items_0: ExternalIds, items_1: ExternalIds) -> Distances:
        items_0 = np.asarray(items_0)
        items_1 = np.asarray(items_1)
        result = np.full(len(items_0), np.nan, dtype=np.float32)
        idx_0 = pd.Index(self.mapper.external_ids).get_indexer(items_0)
        idx_1 = pd.Index(self.mapper.external_ids).get_indexer(items_1)
        known = (idx_0 >= 0) & (idx_1 >= 0) & (idx_0 < self.features.shape[0]) & (idx_1 < self.features.shape[0])
        if not known.all():
            warnings.warn(
                "Some items absent in id map or features; corresponding pair distances are set to NaN."
            )
        if known.any():
            diff = self.features[idx_0[known]] - self.features[idx_1[known]]
            diff.data = (diff.data != 0).astype(np.float32)
            result[known] = np.asarray(diff.sum(axis=1)).ravel()
        return result
