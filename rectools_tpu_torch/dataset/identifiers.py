"""External↔internal id mapping.

Behavioral parity with reference rectools/dataset/identifiers.py:29-252:
internal ids are dense 0..n-1 in first-appearance order; `add_ids` appends new
external ids after existing ones (so "warm" entities get ids >= n_hot).
"""

import typing as tp

import attr
import numpy as np
import pandas as pd

from ..types import AnySequence, ExternalIds, InternalIds


@attr.s(slots=True, frozen=True)
class IdMap:
    """Bidirectional mapping between external and internal (dense 0..n-1) ids."""

    external_ids: np.ndarray = attr.ib()

    @classmethod
    def from_values(cls, values: AnySequence) -> "IdMap":
        """Create map from a sequence of (possibly repeating) external ids.

        Internal ids follow first-appearance order (pd.unique semantics,
        reference identifiers.py:47).
        """
        unq_values = pd.unique(np.asarray(values))
        return cls(unq_values)

    @classmethod
    def from_dict(cls, mapping: tp.Dict[tp.Any, int]) -> "IdMap":
        """Create map from an explicit {external: internal} dict.

        Internal ids must be a permutation of 0..n-1 (reference identifiers.py).
        """
        internal = np.array(list(mapping.values()))
        if len(internal) > 0:
            expected = np.arange(len(internal))
            if not np.array_equal(np.sort(internal), expected):
                raise ValueError("Internal ids must be integers from 0 to n-1")
        externals = np.empty(len(internal), dtype=np.asarray(list(mapping.keys())).dtype)
        for ext, int_ in mapping.items():
            externals[int_] = ext
        return cls(externals)

    @property
    def size(self) -> int:
        return len(self.external_ids)

    @property
    def external_dtype(self) -> np.dtype:
        return self.external_ids.dtype

    @property
    def to_internal(self) -> pd.Series:
        """pd.Series with external ids as index, internal as values."""
        return pd.Series(np.arange(self.size), index=pd.Index(self.external_ids))

    @property
    def to_external(self) -> pd.Series:
        """pd.Series with internal ids as index, external as values."""
        return pd.Series(self.external_ids, index=np.arange(self.size))

    @property
    def internal_ids(self) -> np.ndarray:
        return np.arange(self.size)

    def get_sorted_internal(self) -> np.ndarray:
        return np.arange(self.size)

    def get_external_sorted_by_internal(self) -> np.ndarray:
        return self.external_ids

    def convert_to_internal(
        self, external: ExternalIds, strict: bool = True, return_missing: bool = False
    ) -> tp.Union[np.ndarray, tp.Tuple[np.ndarray, np.ndarray]]:
        """Map external → internal ids (reference identifiers.py:140)."""
        if strict and return_missing:
            raise ValueError("`return_missing` is only allowed with `strict=False`")
        external = np.asarray(external)
        indexer = pd.Index(self.external_ids).get_indexer(external)
        missing_mask = indexer == -1
        if strict:
            if missing_mask.any():
                raise KeyError("Some ids don't exist in mapping")
            return indexer
        found = indexer[~missing_mask]
        if return_missing:
            return found, external[missing_mask]
        return found

    def convert_to_external(
        self, internal: InternalIds, strict: bool = True, return_missing: bool = False
    ) -> tp.Union[np.ndarray, tp.Tuple[np.ndarray, np.ndarray]]:
        """Map internal → external ids (reference identifiers.py:188)."""
        if strict and return_missing:
            raise ValueError("`return_missing` is only allowed with `strict=False`")
        internal = np.asarray(internal).astype(np.int64, copy=False)
        valid_mask = (internal >= 0) & (internal < self.size)
        if strict:
            if not valid_mask.all():
                raise KeyError("Some ids don't exist in mapping")
            return self.external_ids[internal]
        found = self.external_ids[internal[valid_mask]]
        if return_missing:
            return found, internal[~valid_mask]
        return found

    def add_ids(self, values: AnySequence, raise_if_already_present: bool = False) -> "IdMap":
        """Append previously unseen external ids after existing ones
        (reference identifiers.py:224). Warm entities therefore receive
        internal ids >= current size."""
        unq_values = pd.unique(np.asarray(values))
        present_mask = pd.Index(unq_values).isin(self.external_ids)
        if raise_if_already_present and present_mask.any():
            raise ValueError("Some ids are already present in the map")
        new_values = unq_values[~present_mask]
        if len(self.external_ids) == 0:
            combined = np.asarray(new_values)
        else:
            combined = np.concatenate(
                [self.external_ids, new_values.astype(self.external_ids.dtype, copy=False)]
            )
        return IdMap(combined)
