"""Native host ops: the port's copy of ``rectools_tpu/native``.

C++ versions of the data pipeline's host loops, bound with ctypes:
the ragged-to-dense left pad of the collates (``scatter_left_padded_*``), the
padded seen lists of the top-k engine (``csr_rows_padded_i32``) and SASRec's
shifted-sequence train collate (``sasrec_train_collate``). ``hostops.cpp``
is built with ``g++ -O3`` at first use into ``build/hostops/`` at the
repository root (git ignores it), keyed by a hash of the source.

``lib()`` returns the loaded library, or None when it cannot be built or
``RECTOOLS_TPU_TORCH_NO_NATIVE`` is set; every caller keeps its vectorised
numpy version for that case, and each ``*_native`` function returns None
then. :func:`disabled` forces the numpy versions for a block of code (to
compare the two paths in one process).
"""

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import typing as tp
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hostops"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
OPT_OUT_ENV = "RECTOOLS_TPU_TORCH_NO_NATIVE"

_LOCK = threading.Lock()
_LIB: tp.Any = None
_TRIED = False
_DISABLED = False


def so_path() -> Path:
    """Where the library for the current source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"hostops_{digest}.so"


def _compile() -> tp.Optional[ctypes.CDLL]:
    """Build ``hostops.cpp`` with g++ (through a temporary file, so
    concurrent builds never load a half-written library) unless it is built
    already, then load it and declare its functions' arguments; None if g++
    is missing or fails."""
    target = so_path()
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp_path = target.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp_path), str(SOURCE)], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp_path, target)
    try:
        cdll = ctypes.CDLL(str(target))
    except OSError:  # pragma: no cover
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    cdll.scatter_left_padded_i64.argtypes = [i64p, i64p, i64p, i64, i64, i64p]
    cdll.scatter_left_padded_f32.argtypes = [f32p, i64p, i64p, i64, i64, f32p]
    cdll.csr_rows_padded_i32.argtypes = [i32p, i64p, i64p, i64, i64, i32p]
    cdll.sasrec_train_collate.argtypes = [i64p, f32p, i64p, i64p, i64, i64, i64p, i64p, f32p]
    for fn in (cdll.scatter_left_padded_i64, cdll.scatter_left_padded_f32, cdll.csr_rows_padded_i32,
               cdll.sasrec_train_collate):
        fn.restype = None
    return cdll


def lib() -> tp.Any:
    """The compiled host-ops library, or None if unavailable or disabled."""
    global _LIB, _TRIED
    if _DISABLED:
        return None
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = None if os.environ.get(OPT_OUT_ENV) else _compile()
            _TRIED = True
    return _LIB


@contextlib.contextmanager
def disabled() -> tp.Iterator[None]:
    """Run the block on the numpy versions (the library stays loaded)."""
    global _DISABLED
    previous, _DISABLED = _DISABLED, True
    try:
        yield
    finally:
        _DISABLED = previous


def _ptr(arr: np.ndarray, ctype: tp.Any) -> tp.Any:
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_rows(starts: np.ndarray, lengths: np.ndarray, size: int) -> None:
    """Every row ``[start, start + length)`` inside an array of ``size``
    values: the C loops trust them, where numpy would raise."""
    if len(starts) and (lengths.min() < 0 or starts.min() < 0 or (starts + lengths).max() > size):
        raise IndexError(f"a row reaches outside the {size} values it is taken from")


def _filled(shape: tp.Tuple[int, int], fill: tp.Any, dtype: tp.Any) -> np.ndarray:
    # np.zeros is calloc-backed: the kernel then only touches real data
    return np.zeros(shape, dtype=dtype) if fill == 0 else np.full(shape, fill, dtype=dtype)


def scatter_left_padded_native(
    values: np.ndarray, starts: np.ndarray, lengths: np.ndarray, out_len: int, dtype: tp.Any, fill: tp.Any = 0
) -> tp.Optional[np.ndarray]:
    """Ragged -> dense, left-padded, keeping each row's last ``out_len``
    values; None if the library is unavailable or the dtype is neither int64
    nor float32."""
    cdll = lib()
    np_dtype = np.dtype(dtype)
    if cdll is None or np_dtype not in (np.dtype(np.int64), np.dtype(np.float32)):
        return None
    n = len(starts)
    starts64 = np.ascontiguousarray(starts, dtype=np.int64)
    lengths64 = np.ascontiguousarray(lengths, dtype=np.int64)
    values_c = np.ascontiguousarray(values, dtype=np_dtype)
    _check_rows(starts64, lengths64, len(values_c))
    out = _filled((n, out_len), fill, np_dtype)
    if np_dtype == np.int64:
        fn, ctype = cdll.scatter_left_padded_i64, ctypes.c_int64
    else:
        fn, ctype = cdll.scatter_left_padded_f32, ctypes.c_float
    fn(_ptr(values_c, ctype), _ptr(starts64, ctypes.c_int64), _ptr(lengths64, ctypes.c_int64), n, out_len,
       _ptr(out, ctype))
    return out


def csr_rows_padded_native(
    indices: np.ndarray, indptr: np.ndarray, rows: np.ndarray, max_len: int, fill: int
) -> tp.Optional[np.ndarray]:
    """Column indices of the given CSR rows, right-padded with ``fill`` into
    an (len(rows), max_len) int32 table; None if unavailable. Only the
    given rows' starts and lengths are read from ``indptr``."""
    cdll = lib()
    if cdll is None:
        return None
    n = len(rows)
    indices32 = np.ascontiguousarray(indices, dtype=np.int32)
    starts64 = np.ascontiguousarray(indptr[rows], dtype=np.int64)
    lengths64 = indptr[rows + 1] - starts64
    _check_rows(starts64, lengths64, len(indices32))
    if n and lengths64.max() > max_len:
        raise ValueError(f"a row holds more than max_len={max_len} values")
    out = np.full((n, max_len), fill, dtype=np.int32)
    cdll.csr_rows_padded_i32(
        _ptr(indices32, ctypes.c_int32), _ptr(starts64, ctypes.c_int64), _ptr(lengths64, ctypes.c_int64),
        n, max_len, _ptr(out, ctypes.c_int32),
    )
    return out


def sasrec_train_collate_native(
    items: np.ndarray, weights: np.ndarray, starts: np.ndarray, lengths: np.ndarray, out_len: int
) -> tp.Optional[tp.Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """SASRec's shifted-sequence train collate, (x, y, yw), in one pass;
    None if unavailable."""
    cdll = lib()
    if cdll is None:
        return None
    n = len(starts)
    items64 = np.ascontiguousarray(items, dtype=np.int64)
    weights32 = np.ascontiguousarray(weights, dtype=np.float32)
    starts64 = np.ascontiguousarray(starts, dtype=np.int64)
    lengths64 = np.ascontiguousarray(lengths, dtype=np.int64)
    if len(weights32) != len(items64):
        raise ValueError(f"{len(items64)} items but {len(weights32)} weights")
    _check_rows(starts64, lengths64, len(items64))
    x = np.zeros((n, out_len), dtype=np.int64)
    y = np.zeros((n, out_len), dtype=np.int64)
    yw = np.zeros((n, out_len), dtype=np.float32)
    cdll.sasrec_train_collate(
        _ptr(items64, ctypes.c_int64), _ptr(weights32, ctypes.c_float),
        _ptr(starts64, ctypes.c_int64), _ptr(lengths64, ctypes.c_int64),
        n, out_len,
        _ptr(x, ctypes.c_int64), _ptr(y, ctypes.c_int64), _ptr(yw, ctypes.c_float),
    )
    return x, y, yw
