"""Fast set operations over id arrays.

The port's copy of ``rectools_tpu/utils/array_ops.py``.

Behavioral parity with reference: rectools/utils/array_set_ops.py:23-282.
Implementations are numpy-first (the host side of this framework avoids pandas
in hot paths; id bookkeeping happens on the host, compute on the device).
"""

import typing as tp

import numpy as np
import pandas as pd


def fast_isin(elements: np.ndarray, test_elements: np.ndarray, invert: bool = False) -> np.ndarray:
    """Effective version of `np.isin` that handles object dtypes via pandas Index."""
    if elements.dtype is np.dtype("O") or test_elements.dtype is np.dtype("O"):
        isin = pd.Index(elements).isin(test_elements)
        return ~isin if invert else isin
    return np.isin(elements, test_elements, invert=invert)


def fast_isin_for_sorted_test_elements(
    elements: np.ndarray,
    sorted_test_elements: np.ndarray,
    invert: bool = False,
) -> np.ndarray:
    """Check membership against an already-sorted array via searchsorted.

    Reference semantics: rectools/utils/array_set_ops.py (searchsorted trick).
    """
    ss_result = np.searchsorted(sorted_test_elements, elements, side="left")
    ss_result[ss_result == sorted_test_elements.size] = 0
    isin = sorted_test_elements[ss_result] == elements
    if invert:
        return ~isin
    return isin


def _to_void_view(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    void_dt = np.dtype((np.void, arr.dtype.itemsize * arr.shape[1]))
    return arr.view(void_dt).ravel()


def fast_2d_int_unique(arr: np.ndarray) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Unique rows of a 2d int array + inverse indices (void-view trick).

    Returns (unique_rows, inverse) such that unique_rows[inverse] == arr.
    """
    if arr.ndim != 2:
        raise ValueError("Array must be 2d")
    if arr.size == 0:
        return arr.copy(), np.array([], dtype=np.int64)
    voids = _to_void_view(arr)
    _, unq_idx, inverse = np.unique(voids, return_index=True, return_inverse=True)
    return arr[unq_idx], inverse.reshape(-1)


def fast_2d_2col_int_unique(arr: np.ndarray) -> np.ndarray:
    """Unique rows of a 2-column integer array, sorted by first then second column.

    Reference semantics: rectools/utils/array_set_ops.py:82-137 (which uses a
    scipy CSR round trip); here a lexsort + run-boundary dedup gives the same
    sorted-unique result without the sparse-matrix detour.

    Examples
    --------
    >>> arr = np.array([[10, 30], [10, 555], [10, 30], [1, 2], [1, 2]])
    >>> fast_2d_2col_int_unique(arr)
    array([[  1,   2],
           [ 10,  30],
           [ 10, 555]])
    """
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError("Only integer array is allowed")
    if arr.ndim != 2:
        raise ValueError("Only 2d array is allowed")
    if arr.shape[1] != 2:
        raise ValueError("Array must have 2 columns")
    if arr.shape[0] == 0:
        return arr
    order = np.lexsort((arr[:, 1], arr[:, 0]))
    sorted_arr = arr[order]
    keep = np.empty(len(sorted_arr), dtype=bool)
    keep[0] = True
    np.any(sorted_arr[1:] != sorted_arr[:-1], axis=1, out=keep[1:])
    return sorted_arr[keep]


def isin_2d_int(ar1: np.ndarray, ar2: np.ndarray) -> np.ndarray:
    """Row-wise membership of 2d int array `ar1` in 2d int array `ar2`."""
    if ar1.ndim != 2 or ar2.ndim != 2:
        raise ValueError("Arrays must be 2d")
    if ar1.shape[1] != ar2.shape[1]:
        raise ValueError("Arrays must have equal number of columns")
    common = np.result_type(ar1.dtype, ar2.dtype)
    v1 = _to_void_view(ar1.astype(common, copy=False))
    v2 = _to_void_view(ar2.astype(common, copy=False))
    return np.isin(v1, v2)
