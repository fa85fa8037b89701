"""Indexing helpers (port of rectools_tpu/utils/indexing.py; reference
rectools/utils/indexing.py:23,66)."""

import typing as tp

import numpy as np
import pandas as pd


AnySequence = tp.Union[tp.Sequence[tp.Any], np.ndarray]


def get_from_series_by_index(
    series: pd.Series,
    ids: AnySequence,
    strict: bool = True,
    return_missing: bool = False,
) -> tp.Union[np.ndarray, tp.Tuple[np.ndarray, np.ndarray]]:
    """Map `ids` through a pandas Series index → values.

    strict=True raises KeyError on missing ids; strict=False drops them.
    return_missing=True (only with strict=False) also returns the missing ids.
    """
    if strict and return_missing:
        raise ValueError("`return_missing` is only allowed with `strict=False`")
    ids = np.asarray(ids)
    r = series.reindex(ids)
    # Target numpy dtype: pandas extension dtypes (e.g. StringDtype) are not
    # valid numpy dtypes; fall back to the values' own numpy representation.
    base_values = series.to_numpy()
    if strict:
        if r.isna().any():
            raise KeyError("Some indices do not exist")
        return r.to_numpy().astype(base_values.dtype)
    missing_mask = r.isna().to_numpy()
    selected = r.to_numpy()[~missing_mask].astype(base_values.dtype)
    if return_missing:
        return selected, ids[missing_mask]
    return selected


def get_element_ids(elements: np.ndarray, test_elements: np.ndarray) -> np.ndarray:
    """For every element of `elements`, its index in `test_elements`.

    Raises ValueError if any element is missing.
    """
    sort_idx = np.argsort(test_elements)
    sorted_test = test_elements[sort_idx]
    pos = np.searchsorted(sorted_test, elements)
    pos[pos == sorted_test.size] = 0
    if not (sorted_test[pos] == elements).all():
        raise ValueError("All `elements` must be in `test_elements`")
    return sort_idx[pos]
