"""Dense and sparse object features.

Behavioral parity with reference rectools/dataset/features.py:41-471:
- DenseFeatures: (n_objects, n_features) float32 matrix + names; every id in
  the map must have features.
- SparseFeatures: CSR matrix built from a flatten (id, feature, value[,weight])
  table. Direct features are numeric, weighted, summed per (id, feature).
  Categorical features are one-hot counts multiplied by weight. Names are
  (feature, value) tuples; direct features use (feature, DIRECT_FEATURE_VALUE).
"""

import typing as tp

import attr
import numpy as np
import pandas as pd
from scipy import sparse

from .identifiers import IdMap

DIRECT_FEATURE_VALUE = "__is_direct_feature"

SparseFeatureName = tp.Tuple[str, tp.Any]


class AbsentIdError(ValueError):
    """Raised when features are missing for some ids present in the id map."""


@attr.s(slots=True, frozen=True)
class DenseFeatures:
    """Dense float32 feature matrix with named columns."""

    values: np.ndarray = attr.ib()
    names: tp.Tuple[str, ...] = attr.ib()

    @names.validator
    def _check_names_length(self, _: tp.Any, value: tp.Tuple[str, ...]) -> None:
        if len(value) != self.values.shape[1]:
            raise ValueError(
                f"Number of features is {self.values.shape[1]}, but number of names is {len(value)}"
            )

    @classmethod
    def from_iterables(cls, values: tp.Iterable[tp.Iterable[float]], names: tp.Iterable[str]) -> "DenseFeatures":
        return cls(values=np.asarray(values, dtype=np.float32), names=tuple(names))

    @classmethod
    def from_dataframe(
        cls,
        df: pd.DataFrame,
        id_map: IdMap,
        id_col: str = "id",
    ) -> "DenseFeatures":
        """Build features aligned to internal id order; every id must be present."""
        ids = df[id_col].to_numpy()
        if len(np.unique(ids)) != len(ids):
            raise ValueError("Ids in dataframe must be unique")
        try:
            internal = id_map.convert_to_internal(ids)
        except KeyError:
            raise AbsentIdError("Some ids from dataframe are absent in id map")
        if len(internal) != id_map.size:
            raise AbsentIdError("Some ids from id map are absent in dataframe")
        feature_df = df.drop(columns=[id_col])
        values = np.empty((id_map.size, feature_df.shape[1]), dtype=np.float32)
        values[internal] = feature_df.to_numpy(dtype=np.float32)
        return cls(values=values, names=tuple(feature_df.columns))

    def get_dense(self) -> np.ndarray:
        return self.values

    def get_sparse(self) -> sparse.csr_matrix:
        return sparse.csr_matrix(self.values)

    def take(self, ids: np.ndarray) -> "DenseFeatures":
        return DenseFeatures(values=self.values[ids], names=self.names)

    def __len__(self) -> int:
        return self.values.shape[0]


@attr.s(slots=True, frozen=True)
class SparseFeatures:
    """CSR feature matrix: direct numeric columns + one-hot categorical blocks."""

    values: sparse.csr_matrix = attr.ib()
    names: tp.Tuple[SparseFeatureName, ...] = attr.ib()

    @names.validator
    def _check_names_length(self, _: tp.Any, value: tp.Tuple[SparseFeatureName, ...]) -> None:
        if len(value) != self.values.shape[1]:
            raise ValueError(
                f"Number of features is {self.values.shape[1]}, but number of names is {len(value)}"
            )

    @classmethod
    def from_iterables(
        cls, values: sparse.csr_matrix, names: tp.Iterable[SparseFeatureName]
    ) -> "SparseFeatures":
        return cls(values=values.astype(np.float32), names=tuple(names))

    @classmethod
    def from_flatten(
        cls,
        df: pd.DataFrame,
        id_map: IdMap,
        cat_features: tp.Iterable[tp.Any] = (),
        id_col: str = "id",
        feature_col: str = "feature",
        value_col: str = "value",
        weight_col: str = "weight",
    ) -> "SparseFeatures":
        """Build from flatten (id, feature, value[, weight]) table.

        Direct feature values are multiplied by weight and summed per object.
        Categorical features become one-hot count columns multiplied by weight.
        """
        required = {id_col, feature_col, value_col}
        if required - set(df.columns):
            raise KeyError(f"Missing columns: {required - set(df.columns)}")
        df = df.copy()
        if weight_col not in df.columns:
            df[weight_col] = 1.0
        try:
            df[id_col] = id_map.convert_to_internal(df[id_col].to_numpy())
        except KeyError:
            raise AbsentIdError("Some ids from dataframe are absent in id map")

        cat_features = list(cat_features)
        cat_mask = df[feature_col].isin(cat_features).to_numpy()
        direct_df = df[~cat_mask]
        cat_df = df[cat_mask]

        matrices: tp.List[sparse.csr_matrix] = []
        names: tp.List[SparseFeatureName] = []

        if len(direct_df) > 0:
            csr, direct_names = cls._make_direct_features(
                direct_df, id_map.size, id_col, feature_col, value_col, weight_col
            )
            matrices.append(csr)
            names.extend(direct_names)
        if len(cat_df) > 0:
            for feature_name in pd.unique(cat_df[feature_col].to_numpy()):
                feature_rows = cat_df[cat_df[feature_col] == feature_name]
                csr, cat_names = cls._make_cat_feature(
                    feature_rows, feature_name, id_map.size, id_col, value_col, weight_col
                )
                matrices.append(csr)
                names.extend(cat_names)

        if not matrices:
            values = sparse.csr_matrix((id_map.size, 0), dtype=np.float32)
        else:
            values = sparse.hstack(matrices, format="csr").astype(np.float32)
        return cls(values=values, names=tuple(names))

    @staticmethod
    def _make_direct_features(
        df: pd.DataFrame, n_objects: int, id_col: str, feature_col: str, value_col: str, weight_col: str
    ) -> tp.Tuple[sparse.csr_matrix, tp.List[SparseFeatureName]]:
        feature_names = pd.unique(df[feature_col].to_numpy())
        name_to_col = {name: i for i, name in enumerate(feature_names)}
        cols = df[feature_col].map(name_to_col).to_numpy()
        try:
            vals = df[value_col].to_numpy(dtype=np.float32) * df[weight_col].to_numpy(dtype=np.float32)
        except ValueError:
            raise TypeError("Direct feature values and weights must be numeric")
        csr = sparse.csr_matrix(
            (vals, (df[id_col].to_numpy(), cols)),
            shape=(n_objects, len(feature_names)),
            dtype=np.float32,
        )
        csr.sum_duplicates()
        return csr, [(name, DIRECT_FEATURE_VALUE) for name in feature_names]

    @staticmethod
    def _make_cat_feature(
        df: pd.DataFrame, feature_name: tp.Any, n_objects: int, id_col: str, value_col: str, weight_col: str
    ) -> tp.Tuple[sparse.csr_matrix, tp.List[SparseFeatureName]]:
        values = df[value_col].to_numpy()
        unq_values = pd.unique(values)
        value_to_col = {v: i for i, v in enumerate(unq_values)}
        cols = np.array([value_to_col[v] for v in values])
        weights = df[weight_col].to_numpy(dtype=np.float32)
        csr = sparse.csr_matrix(
            (weights, (df[id_col].to_numpy(), cols)),
            shape=(n_objects, len(unq_values)),
            dtype=np.float32,
        )
        csr.sum_duplicates()
        return csr, [(feature_name, v) for v in unq_values]

    @property
    def cat_col_mask(self) -> np.ndarray:
        """Boolean mask of categorical columns (reference features.py:454)."""
        return np.array([v != DIRECT_FEATURE_VALUE for _, v in self.names], dtype=bool)

    @property
    def cat_feature_indices(self) -> np.ndarray:
        """Column indices of categorical (one-hot) features."""
        return np.array([i for i, (_, v) in enumerate(self.names) if v != DIRECT_FEATURE_VALUE], dtype=int)

    @property
    def direct_feature_indices(self) -> np.ndarray:
        """Column indices of direct (numeric) features."""
        return np.array([i for i, (_, v) in enumerate(self.names) if v == DIRECT_FEATURE_VALUE], dtype=int)

    def get_cat_features(self) -> "SparseFeatures":
        idx = self.cat_feature_indices
        return SparseFeatures(
            values=sparse.csr_matrix(self.values[:, idx]),
            names=tuple(self.names[i] for i in idx),
        )

    def get_dense(self) -> np.ndarray:
        return self.values.toarray()

    def get_sparse(self) -> sparse.csr_matrix:
        return self.values

    def take(self, ids: np.ndarray) -> "SparseFeatures":
        return SparseFeatures(values=sparse.csr_matrix(self.values[ids]), names=self.names)

    def __len__(self) -> int:
        return self.values.shape[0]


Features = tp.Union[DenseFeatures, SparseFeatures]
