"""The port's native host ops (``rectools_tpu_torch.native``) held against
their numpy versions and against the JAX package's ``rectools_tpu.native``.

All four C functions are compared bit for bit (values and dtype) on seeded
ragged inputs with empty rows, rows longer than the output and a fill other
than 0, through the port's call sites (the collates' ``scatter_left_padded``,
the top-k engine's ``_csr_rows_to_padded_idx`` and SASRec's train collate)
with the library loaded and with ``native.disabled()``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

from rectools_tpu import native as jax_native
from rectools_tpu.models.nn.transformers.data_preparator import scatter_left_padded as jax_scatter_left_padded
from rectools_tpu.ops.topk import _csr_rows_to_padded_idx as jax_csr_rows_to_padded_idx
from rectools_tpu_torch import Columns, native
from rectools_tpu_torch.dataset import Dataset
from rectools_tpu_torch.models import SASRecModel
from rectools_tpu_torch.models.nn.transformers.data_preparator import SequenceDataset, scatter_left_padded
from rectools_tpu_torch.ops.topk import _csr_rows_to_padded_idx

REPO = Path(__file__).resolve().parents[1]


def _ragged(seed: int, n_rows: int, max_len: int, dtype) -> tuple:
    """Flat values, starts and lengths of ``n_rows`` rows, about a fifth of
    them empty, some longer than any output width used here."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, size=n_rows)
    lengths[rng.random(n_rows) < 0.2] = 0
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    total = int(lengths.sum())
    if np.dtype(dtype) == np.float32:
        values = rng.normal(size=total + 3).astype(np.float32)
    else:
        values = rng.integers(-(10**12), 10**12, size=total + 3, dtype=np.int64)
    return values, starts, lengths.astype(np.int64)


def _assert_same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_library_builds_into_the_repository_build_dir() -> None:
    assert native.lib() is not None
    assert native.so_path().parent == REPO / "build" / "hostops"
    assert native.so_path().exists()
    assert jax_native.lib() is not None  # the reference's own library, built by the JAX package


def test_opt_out_variable_gives_the_numpy_versions() -> None:
    code = (
        "import numpy as np; from rectools_tpu_torch import native; "
        "assert native.lib() is None; "
        "assert native.scatter_left_padded_native(np.arange(3), np.array([0]), np.array([3]), 2, np.int64) is None; "
        "print('numpy only')"
    )
    env = {**os.environ, native.OPT_OUT_ENV: "1", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "numpy only" in out.stdout


def test_disabled_turns_the_library_off_for_a_block() -> None:
    assert native.lib() is not None
    with native.disabled():
        assert native.lib() is None
        assert native.csr_rows_padded_native(np.zeros(1), np.array([0, 1]), np.array([0]), 1, 0) is None
    assert native.lib() is not None


@pytest.mark.parametrize("dtype", [np.int64, np.float32])
@pytest.mark.parametrize("fill", [0, 7])
@pytest.mark.parametrize("out_len", [1, 6, 40])
def test_scatter_left_padded_matches_numpy_and_jax(dtype, fill: int, out_len: int) -> None:
    values, starts, lengths = _ragged(10 + out_len, n_rows=300, max_len=30, dtype=dtype)
    fill_value = dtype(fill)
    direct = native.scatter_left_padded_native(values, starts, lengths, out_len, dtype, fill_value)
    through_call_site = scatter_left_padded(values, starts, lengths, out_len, dtype, fill_value)
    with native.disabled():
        numpy_version = scatter_left_padded(values, starts, lengths, out_len, dtype, fill_value)
    jax_direct = jax_native.scatter_left_padded_native(values, starts, lengths, out_len, dtype, fill_value)
    jax_call_site = jax_scatter_left_padded(values, starts, lengths, out_len, dtype, fill_value)
    assert direct is not None and jax_direct is not None
    for other in (through_call_site, numpy_version, jax_direct, jax_call_site):
        _assert_same(direct, other)
    assert (direct[lengths == 0] == fill_value).all()


def test_scatter_left_padded_other_dtypes_take_numpy() -> None:
    values, starts, lengths = _ragged(3, n_rows=20, max_len=5, dtype=np.int64)
    values32 = values.astype(np.int32)
    assert native.scatter_left_padded_native(values32, starts, lengths, 4, np.int32) is None
    _assert_same(
        scatter_left_padded(values32, starts, lengths, 4, np.int32, -1),
        jax_scatter_left_padded(values32, starts, lengths, 4, np.int32, -1),
    )


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fill", [-1, 0, 1000])
@pytest.mark.parametrize("empty_share", [0.0, 0.3, 1.0])
def test_csr_rows_padded_matches_numpy_and_jax(index_dtype, fill: int, empty_share: float) -> None:
    """Also with 64-bit ``indptr`` / ``indices`` (scipy's choice for large
    matrices): the native path reads only the batch's rows of ``indptr``."""
    rng = np.random.default_rng(int(100 * empty_share) + fill + 1)
    mat = sparse.random(80, 500, density=0.05, format="csr", random_state=rng).astype(np.float32)
    mat = sparse.diags((rng.random(80) >= empty_share).astype(np.float32)) @ mat
    mat = sparse.csr_matrix(mat)
    mat.eliminate_zeros()
    mat.indptr = mat.indptr.astype(index_dtype)
    mat.indices = mat.indices.astype(index_dtype)
    rows = rng.integers(0, 80, size=64)
    got = _csr_rows_to_padded_idx(mat, rows, fill=fill)
    with native.disabled():
        numpy_version = _csr_rows_to_padded_idx(mat, rows, fill=fill)
    expected = jax_csr_rows_to_padded_idx(mat, rows, fill=fill)
    for other in (numpy_version, expected):
        _assert_same(got, other)
    lengths = np.diff(mat.indptr)[rows]
    if lengths.max() > 0:
        direct = native.csr_rows_padded_native(mat.indices, mat.indptr, rows, int(lengths.max()), fill)
        jax_direct = jax_native.csr_rows_padded_native(mat.indices, mat.indptr, rows, int(lengths.max()), fill)
        _assert_same(direct, jax_direct)
        _assert_same(direct, got)


@pytest.mark.parametrize("out_len", [1, 5, 50])
def test_sasrec_train_collate_matches_numpy_and_jax(out_len: int) -> None:
    rng = np.random.default_rng(out_len)
    lengths = rng.integers(1, 40, size=200)  # sessions of one interaction give no pair: an empty row
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    items = rng.integers(1, 10**6, size=int(lengths.sum()), dtype=np.int64)
    weights = rng.random(int(lengths.sum()), dtype=np.float32)
    x, y, yw = native.sasrec_train_collate_native(items, weights, starts, lengths, out_len)
    jx, jy, jyw = jax_native.sasrec_train_collate_native(items, weights, starts, lengths, out_len)
    m = lengths - 1
    with native.disabled():
        nx = scatter_left_padded(items, starts, m, out_len, np.int64)
        ny = scatter_left_padded(items, starts + 1, m, out_len, np.int64)
        nyw = scatter_left_padded(weights, starts + 1, m, out_len, np.float32)
    for got, jax_got, numpy_got in ((x, jx, nx), (y, jy, ny), (yw, jyw, nyw)):
        _assert_same(got, jax_got)
        _assert_same(got, numpy_got)


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(5)
    n = 4000
    return pd.DataFrame(
        {
            Columns.User: rng.integers(0, 300, n),
            Columns.Item: rng.zipf(1.3, n) % 400,
            Columns.Weight: rng.integers(1, 4, n).astype(np.float32),
            Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
        }
    )


@pytest.mark.parametrize("loader", ["train", "recommend"])
def test_sasrec_loaders_native_equal_numpy(loader: str) -> None:
    """Every batch of SASRec's train and recommend loaders is the same with
    the library and without it."""
    dataset = Dataset.construct(_frame())
    model = SASRecModel(n_blocks=1, n_heads=1, n_factors=8, session_max_len=12, batch_size=64, device="cpu")
    prep = model.data_preparator
    prep.process_dataset_train(dataset)

    def batches() -> list:
        if loader == "train":
            return list(prep.get_dataloader_train(np.random.default_rng(1)))
        u2i = prep.transform_dataset_u2i(dataset, dataset.user_id_map.external_ids)
        return list(prep.get_dataloader_recommend(u2i, 100))

    with_native = batches()
    with native.disabled():
        with_numpy = batches()
    assert len(with_native) == len(with_numpy) > 1
    for a, b in zip(with_native, with_numpy):
        assert a.keys() == b.keys()
        for key in a:
            _assert_same(a[key], b[key])


def test_sequence_dataset_items_need_no_copy_per_batch() -> None:
    """The collates pass the flat arrays straight to the library: items are
    int64 and weights float32 already, so no batch copies them."""
    dataset = Dataset.construct(_frame())
    seq = SequenceDataset.from_interactions(dataset.interactions.df)
    assert seq.items.dtype == np.int64 and seq.weights.dtype == np.float32
    assert np.ascontiguousarray(seq.items, dtype=np.int64) is seq.items


def test_rows_outside_their_arrays_raise_before_the_c_loops() -> None:
    values = np.arange(10, dtype=np.int64)
    with pytest.raises(IndexError):
        native.scatter_left_padded_native(values, np.array([8]), np.array([3]), 4, np.int64)
    with pytest.raises(IndexError):
        native.scatter_left_padded_native(values, np.array([-1]), np.array([2]), 4, np.int64)
    with pytest.raises(IndexError):
        native.sasrec_train_collate_native(values, np.ones(10, np.float32), np.array([5]), np.array([6]), 4)
    mat = sparse.csr_matrix(np.eye(3, dtype=np.float32))
    with pytest.raises(IndexError):
        native.csr_rows_padded_native(mat.indices, mat.indptr, np.array([3]), 1, 0)
    with pytest.raises(ValueError):
        native.csr_rows_padded_native(mat.indices, mat.indptr, np.array([0]), 0, 0)
