"""Misc utilities (reference: rectools/utils/misc.py:25-261)."""

import importlib
import typing as tp

import numpy as np

T = tp.TypeVar("T")


def import_object(path: str) -> tp.Any:
    """Import an object from a ``module.sub:attr`` or ``module.sub.attr`` path."""
    if ":" in path:
        module_path, attr = path.split(":")
    else:
        module_path, _, attr = path.rpartition(".")
    module = importlib.import_module(module_path)
    return getattr(module, attr)


def get_class_or_function_full_path(obj: tp.Any) -> str:
    """Full ``module.attr`` import path of a class or function."""
    return f"{obj.__module__}.{obj.__qualname__}"


def make_dict_flat(d: tp.Dict[str, tp.Any], sep: str = ".", parent_key: str = "") -> tp.Dict[str, tp.Any]:
    """Flatten a nested dict into one level with `sep`-joined keys."""
    items: tp.List[tp.Tuple[str, tp.Any]] = []
    for key, value in d.items():
        new_key = f"{parent_key}{sep}{key}" if parent_key else str(key)
        if isinstance(value, dict) and value:
            items.extend(make_dict_flat(value, sep=sep, parent_key=new_key).items())
        else:
            items.append((new_key, value))
    return dict(items)


def unflatten_dict(d: tp.Dict[str, tp.Any], sep: str = ".") -> tp.Dict[str, tp.Any]:
    """Inverse of `make_dict_flat`."""
    result: tp.Dict[str, tp.Any] = {}
    for flat_key, value in d.items():
        keys = flat_key.split(sep)
        cur = result
        for key in keys[:-1]:
            cur = cur.setdefault(key, {})
        cur[keys[-1]] = value
    return result


AnyType = tp.Any


def _is_instance_of_type(obj: tp.Any, type_: AnyType) -> bool:
    try:
        from typeguard import check_type

        try:
            check_type(obj, type_)  # typeguard >= 3
        except TypeError:
            check_type("obj", obj, type_)  # typeguard 2.x signature
        return True
    except Exception:  # noqa: BLE001 - any check failure means "not an instance"
        return False


def is_instance(obj: tp.Any, types: tp.Union[AnyType, tp.Tuple[AnyType, ...]]) -> bool:
    """`isinstance` that also accepts typing generics like ``Union[int, float]``.

    Reference semantics: rectools/utils/misc.py:103-139.

    Examples
    --------
    >>> from typing import Union
    >>> Number = Union[int, float]
    >>> is_instance(1, Number)
    True
    >>> is_instance("abc", (Number, str))
    True
    >>> is_instance([1], (Number, str))
    False
    """
    if not isinstance(types, tuple):
        types = (types,)
    return any(_is_instance_of_type(obj, t) for t in types)


def select_by_type(
    objects: tp.Mapping[tp.Any, tp.Any],
    types: tp.Union[AnyType, tp.Tuple[AnyType, ...]],
) -> tp.Dict[tp.Any, tp.Any]:
    """Select dict entries whose values are instances of `types` (generics allowed).

    Reference semantics: rectools/utils/misc.py:141-171.

    Examples
    --------
    >>> from typing import Union
    >>> Number = Union[int, float]
    >>> select_by_type({1: 10, 2: 0.5, 3: "abc", 4: [1, 2]}, (Number, str))
    {1: 10, 2: 0.5, 3: 'abc'}
    """
    return {k: v for k, v in objects.items() if is_instance(v, types)}


def log_at_base(arr: np.ndarray, base: float) -> np.ndarray:
    """Logarithm at an arbitrary base."""
    return np.log(arr) / np.log(base)


def pairwise(iterable: tp.Iterable[T]) -> tp.Iterator[tp.Tuple[T, T]]:
    """s -> (s0,s1), (s1,s2), (s2,s3), ..."""
    import itertools

    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)
