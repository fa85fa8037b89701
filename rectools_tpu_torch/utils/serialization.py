"""Serialization helpers (reference: rectools/utils/serialization.py:27-51)."""

import typing as tp

import numpy as np
from pydantic import BeforeValidator, PlainSerializer

PICKLE_PROTOCOL = 5

FileLike = tp.Union[str, bytes, tp.Any]


def read_bytes(f: tp.Union[str, tp.Any]) -> bytes:
    """Read bytes from a path or a file-like object."""
    if isinstance(f, (str,)) or hasattr(f, "__fspath__"):
        with open(f, "rb") as fh:
            return fh.read()
    return f.read()


def _deserialize_dtype(value: tp.Any) -> np.dtype:
    if isinstance(value, str):
        return np.dtype(value)
    return value


DType = tp.Annotated[
    np.dtype,
    BeforeValidator(_deserialize_dtype),
    PlainSerializer(func=lambda dtype: dtype.name, return_type=str, when_used="json"),
]


def _serialize_random_state(rs: tp.Any) -> tp.Union[int, None]:
    if rs is None or isinstance(rs, int):
        return rs
    raise TypeError("`random_state` that is not `None` or `int` is not serializable")


RandomState = tp.Annotated[
    tp.Union[None, int, np.random.RandomState],
    PlainSerializer(func=_serialize_random_state, when_used="json"),
]
