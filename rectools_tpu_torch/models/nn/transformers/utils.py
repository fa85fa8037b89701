"""Validation mask utilities — port of rectools_tpu/models/nn/transformers/utils.py."""

import typing as tp

import numpy as np
import pandas as pd

from ....columns import Columns
from ....types import ExternalIds


def leave_one_out_mask(
    interactions: pd.DataFrame, val_users: tp.Union[ExternalIds, int, None] = None
) -> np.ndarray:
    """Boolean mask marking the last interaction per user (for leave-one-out
    validation). ``val_users`` may be None (all), an int (a random sample from
    numpy's global generator, as the JAX package draws it), or an explicit id
    list."""
    groups = interactions.groupby(Columns.User)
    time_order = groups[Columns.Datetime].rank(method="first", ascending=True).astype(int)
    n_interactions = groups[Columns.Datetime].transform("size").astype(int)
    last_interact_mask = (n_interactions - time_order) == 0
    if isinstance(val_users, int):
        users = interactions[Columns.User].unique()
        val_users = np.random.choice(users, size=val_users, replace=False)
    elif val_users is None:
        return last_interact_mask.to_numpy()
    mask = interactions[Columns.User].isin(val_users) & last_interact_mask
    return mask.to_numpy()
