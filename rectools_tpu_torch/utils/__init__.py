from .array_ops import (
    fast_2d_2col_int_unique,
    fast_2d_int_unique,
    fast_isin,
    fast_isin_for_sorted_test_elements,
    isin_2d_int,
)
from .config import BaseConfig
from .device import resolve_device
from .indexing import get_element_ids, get_from_series_by_index
from .misc import get_class_or_function_full_path, import_object, make_dict_flat, unflatten_dict

__all__ = [
    "BaseConfig",
    "fast_2d_2col_int_unique",
    "fast_2d_int_unique",
    "fast_isin",
    "fast_isin_for_sorted_test_elements",
    "get_class_or_function_full_path",
    "get_element_ids",
    "get_from_series_by_index",
    "import_object",
    "isin_2d_int",
    "make_dict_flat",
    "resolve_device",
    "unflatten_dict",
]
