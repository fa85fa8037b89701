"""Interactions container.

Behavioral parity with reference rectools/dataset/interactions.py:30-229:
validated (user_id, item_id, weight, datetime) table with internal ids; CSR
construction for model consumption; back-conversion to external ids.

The table is stored as a pandas DataFrame at the host edge (the public API is
dataframe-based); device feeding paths read the underlying numpy columns.
"""

import typing as tp

import attr
import numpy as np
import pandas as pd
from scipy import sparse

from ..columns import Columns
from .identifiers import IdMap


@attr.s(slots=True, frozen=True)
class Interactions:
    """Validated interactions table with internal dense ids."""

    df: pd.DataFrame = attr.ib()

    @staticmethod
    def convert_weight_and_datetime_types(df: pd.DataFrame) -> pd.DataFrame:
        """Coerce weight to float, datetime to datetime64 (reference interactions.py:178)."""
        if not np.issubdtype(df[Columns.Weight].dtype, np.floating):
            try:
                df[Columns.Weight] = df[Columns.Weight].astype(float)
            except ValueError:
                raise TypeError(f"Column '{Columns.Weight}' must be convertible to float")
        if df[Columns.Datetime].dtype.kind != "M":
            try:
                df[Columns.Datetime] = df[Columns.Datetime].astype("datetime64[ns]")
            except ValueError:
                raise TypeError(f"Column '{Columns.Datetime}' must be convertible to datetime64")
        return df

    @df.validator
    def _check_columns_present(self, _: tp.Any, value: pd.DataFrame) -> None:
        required = {Columns.User, Columns.Item, Columns.Weight, Columns.Datetime}
        actual = set(value.columns)
        if required - actual:
            raise KeyError(f"Missing columns: {required - actual}")

    def __attrs_post_init__(self) -> None:
        df = self.df
        for col in (Columns.User, Columns.Item):
            if not np.issubdtype(df[col].dtype, np.integer):
                raise TypeError(f"Column '{col}' must be integer")
            if len(df) > 0 and df[col].min() < 0:
                raise ValueError(f"Column '{col}' values must be >= 0")
        self.convert_weight_and_datetime_types(df)

    @classmethod
    def from_raw(
        cls,
        interactions: pd.DataFrame,
        user_id_map: IdMap,
        item_id_map: IdMap,
        keep_extra_cols: bool = False,
    ) -> "Interactions":
        """Construct from a raw table with external ids (reference interactions.py:106)."""
        required = {Columns.User, Columns.Item, Columns.Weight, Columns.Datetime}
        if required - set(interactions.columns):
            raise KeyError(f"Missing columns: {required - set(interactions.columns)}")
        df = pd.DataFrame(
            {
                Columns.User: user_id_map.convert_to_internal(interactions[Columns.User].to_numpy()),
                Columns.Item: item_id_map.convert_to_internal(interactions[Columns.Item].to_numpy()),
            }
        )
        df[Columns.Weight] = interactions[Columns.Weight].to_numpy()
        df[Columns.Datetime] = interactions[Columns.Datetime].to_numpy()
        if keep_extra_cols:
            for col in interactions.columns:
                if col not in required:
                    df[col] = interactions[col].to_numpy()
        return cls(df)

    def get_user_item_matrix(
        self,
        include_weights: bool = True,
        dtype: tp.Any = np.float32,
        n_users: tp.Optional[int] = None,
        n_items: tp.Optional[int] = None,
    ) -> sparse.csr_matrix:
        """Build a CSR user-item matrix (reference interactions.py:148).

        Duplicate (user, item) pairs sum their weights.
        """
        users = self.df[Columns.User].to_numpy()
        items = self.df[Columns.Item].to_numpy()
        if include_weights:
            values = self.df[Columns.Weight].to_numpy().astype(dtype)
        else:
            values = np.ones(len(self.df), dtype=dtype)
        shape_users = n_users if n_users is not None else (users.max() + 1 if len(users) else 0)
        shape_items = n_items if n_items is not None else (items.max() + 1 if len(items) else 0)
        csr = sparse.csr_matrix(
            (values, (users, items)),
            shape=(shape_users, shape_items),
            dtype=dtype,
        )
        return csr

    def to_external(
        self,
        user_id_map: IdMap,
        item_id_map: IdMap,
        include_weight: bool = True,
        include_datetime: bool = True,
        include_extra_cols: bool = True,
    ) -> pd.DataFrame:
        """Convert back to external ids (reference interactions.py:178)."""
        res = pd.DataFrame(
            {
                Columns.User: user_id_map.convert_to_external(self.df[Columns.User].to_numpy()),
                Columns.Item: item_id_map.convert_to_external(self.df[Columns.Item].to_numpy()),
            }
        )
        if include_weight:
            res[Columns.Weight] = self.df[Columns.Weight].to_numpy()
        if include_datetime:
            res[Columns.Datetime] = self.df[Columns.Datetime].to_numpy()
        if include_extra_cols:
            for col in self.df.columns:
                if col not in Columns.Interactions:
                    res[col] = self.df[col].to_numpy()
        return res
