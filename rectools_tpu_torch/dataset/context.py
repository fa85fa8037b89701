"""Per-user recommendation context extraction (reference rectools/dataset/context.py:21).

For each user, keep the row with the earliest datetime; drop the item column.
Used by time-aware inference (HSTU)."""

import pandas as pd

from ..columns import Columns
from .interactions import Interactions


def get_context(df: pd.DataFrame) -> pd.DataFrame:
    """One row per user with the earliest-datetime context data."""
    df = df.copy()
    if Columns.Weight not in df.columns:
        df[Columns.Weight] = 1.0
    Interactions.convert_weight_and_datetime_types(df)
    earliest = df.groupby(Columns.User)[Columns.Datetime].idxmin()
    context = df.loc[earliest]
    if Columns.Item in context:
        context = context.drop(columns=[Columns.Item])
    return context
