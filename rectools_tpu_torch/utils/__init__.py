from .config import BaseConfig
from .device import resolve_device
from .misc import get_class_or_function_full_path, import_object, make_dict_flat, unflatten_dict

__all__ = [
    "BaseConfig",
    "get_class_or_function_full_path",
    "import_object",
    "make_dict_flat",
    "resolve_device",
    "unflatten_dict",
]
