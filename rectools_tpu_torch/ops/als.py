"""Batched ALS least-squares half-steps on the device.

Port of rectools_tpu/ops/als.py (replaces implicit's Cython/OpenMP + CUDA
solvers, consumed by the reference at rectools/models/implicit_als.py:584-675).
The math follows the implicit-library convention:

  per subject u with observed objects i and confidences c_ui (csr values,
  already multiplied by alpha):
    A_u = Y^T Y + lambda*I + sum_i (|c_ui| - 1) y_i y_i^T
    b_u = sum_i max(c_ui, 0) y_i
    x_u = A_u^{-1} b_u

All per-subject systems of a bucket solve together: a gather of object
factors, two batched products (cuBLAS, full f32) and a batched Cholesky solve
(``cholesky_ex`` + ``cholesky_solve``, cuSOLVER on the card). No Pallas kernel
lies behind any of it. Ragged per-subject lists are packed into degree
buckets on the host once a fit (``_bucket_spans`` and ``_pack_degree_buckets``
are the JAX package's, so the buckets are the same), uploaded once, and every
half-step is a chain of device work with no host sync until the factors come
back.

A system that is not positive definite (a confidence of magnitude below 1
with a small regularization can make A indefinite) gives a row of NaN, as
JAX's Cholesky does: ``cholesky_ex`` reports the failure per matrix without a
host sync, and the row is set to NaN on the device.

JAX's ``mesh`` branch (the Gram over row shards, solve batches over the data
axis) is not ported; ``ALSModel`` refuses a ``mesh_shape``.
"""

import typing as tp

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, full_f32_matmul, host_to_device, resolve_device

Bucket = tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # rows, idx, conf on the device


def _next_pow2(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << max(0, (n - 1).bit_length()))


def _solve_batch(
    y: torch.Tensor,  # (n_objects, f)
    yty_reg: torch.Tensor,  # (f, f) = Y^T Y + reg*I
    idx: torch.Tensor,  # (B, L) int64, padded entries point anywhere (conf = 0)
    conf: torch.Tensor,  # (B, L) f32, 0 = padding
) -> torch.Tensor:
    """x of every system of the bucket, (B, f); NaN rows where A is not SPD.
    A's confidence term is one batched product (yb * w_a)^T @ yb: no
    (B, L, f, f) tensor is built."""
    yb = y[idx]  # (B, L, f) gather
    w_a = torch.where(conf != 0.0, conf.abs() - 1.0, 0.0)
    w_b = conf.clamp_min(0.0)
    with full_f32_matmul():
        a = yty_reg + (yb * w_a[..., None]).transpose(1, 2) @ yb
        b = (w_b[:, None, :] @ yb)[:, 0]
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.where((info == 0)[:, None], x, float("nan"))


def _yty_reg(y: torch.Tensor, reg: float) -> torch.Tensor:
    with full_f32_matmul():
        gram = y.T @ y
    return gram + reg * torch.eye(y.shape[1], dtype=torch.float32, device=y.device)


def _solve_and_scatter(
    y: torch.Tensor, yty_reg: torch.Tensor, bucket: Bucket, out: torch.Tensor
) -> None:
    """Solve one bucket and write its rows into ``out``; padding rows point
    at the dump row (``out``'s last), which nobody reads."""
    rows, idx, conf = bucket
    out[rows] = _solve_batch(y, yty_reg, idx, conf)


def _bucket_spans(
    sorted_lengths: np.ndarray, batch_size: int, area_budget: int
) -> tp.List[tp.Tuple[int, int]]:
    """Split degree-ASCENDING rows into (start, stop) bucket spans such that
    each bucket's padded area b_pad * l_pad stays under ``area_budget``
    (at least 1 row per bucket). Without the cap, skewed degrees explode
    the padding: at KION scale the top item has ~500k interactions, so a
    2048-row bucket padded to its pow2 degree is a 2^30-row gather."""
    spans = []
    i = 0
    n = len(sorted_lengths)
    while i < n:
        j = i + 1
        while j < n and (j - i) < batch_size:
            l_pad = _next_pow2(int(sorted_lengths[j]), minimum=8)
            if _next_pow2(j - i + 1, minimum=8) * l_pad > area_budget:
                break
            j += 1
        spans.append((i, j))
        i = j
    return spans


def _pack_degree_buckets(
    xy_csr: sparse.csr_matrix, batch_size: int, dump_row: int, area_budget: int = 1 << 22
) -> tp.List[tp.Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Degree-sorted (rows, idx, conf) batches, padded to pow2 shapes.

    Computed ONCE per fit: the sparsity pattern never changes across ALS
    iterations, so the ragged-to-padded packing (and its upload) does not
    sit inside the iteration loop. Zero-degree subjects are left out — the
    half-step starts from zeros, which is their exact solution (b = 0).
    Padding rows scatter into ``dump_row``. Bucket sizes adapt so the
    padded area stays bounded under degree skew (`_bucket_spans`).
    """
    indptr = xy_csr.indptr
    lengths = (indptr[1:] - indptr[:-1]).astype(np.int64)
    order = np.argsort(lengths, kind="stable")
    order = order[lengths[order] > 0]

    buckets = []
    for start, stop in _bucket_spans(lengths[order], batch_size, area_budget):
        rows = order[start:stop]
        b = len(rows)
        l_pad = _next_pow2(int(lengths[rows].max()), minimum=8)
        b_pad = _next_pow2(b, minimum=8)
        idx = np.zeros((b_pad, l_pad), dtype=np.int32)
        conf = np.zeros((b_pad, l_pad), dtype=np.float32)
        row_lens = lengths[rows]
        total = int(row_lens.sum())
        row_pos = np.repeat(np.arange(b), row_lens)
        col_pos = np.arange(total) - np.repeat(np.cumsum(row_lens) - row_lens, row_lens)
        src = np.repeat(indptr[rows].astype(np.int64), row_lens) + col_pos
        idx[row_pos, col_pos] = xy_csr.indices[src]
        conf[row_pos, col_pos] = xy_csr.data[src]
        rows_padded = np.full(b_pad, dump_row, dtype=np.int32)
        rows_padded[:b] = rows
        buckets.append((rows_padded, idx, conf))
    return buckets


def _upload_buckets(xy_csr: sparse.csr_matrix, batch_size: int, device: torch.device) -> tp.List[Bucket]:
    """The packed buckets on ``device``, indices as int64."""
    return [
        (host_to_device(rows.astype(np.int64), device), host_to_device(idx.astype(np.int64), device),
         host_to_device(conf, device))
        for rows, idx, conf in _pack_degree_buckets(xy_csr, batch_size, dump_row=xy_csr.shape[0])
    ]


def _half_step(y: torch.Tensor, buckets: tp.List[Bucket], n_subjects: int, reg: float) -> torch.Tensor:
    yty = _yty_reg(y, reg)
    out = torch.zeros((n_subjects + 1, y.shape[1]), dtype=torch.float32, device=y.device)
    for bucket in buckets:
        _solve_and_scatter(y, yty, bucket, out)
    return out[:n_subjects]


def als_half_step(
    xy_csr: sparse.csr_matrix,  # (n_subjects, n_objects) confidences
    y: np.ndarray,  # (n_objects, f) fixed side
    regularization: float,
    batch_size: int = 2048,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """One ALS half-step: re-solve all subject factors against fixed ``y``.

    Subjects with no interactions get zero factors (b = 0). JAX's half-step
    buckets every row, the port the nonzero ones (``_pack_degree_buckets``):
    each system is solved alone, so only the rows' padding differs."""
    dev = resolve_device(device)
    y_dev = host_to_device(np.asarray(y, dtype=np.float32), dev)
    buckets = _upload_buckets(xy_csr, batch_size, dev)
    return _half_step(y_dev, buckets, xy_csr.shape[0], float(regularization)).cpu().numpy()


def als_fit(
    ui_csr: sparse.csr_matrix,
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    regularization: float,
    iterations: int,
    user_reset_cols: tp.Optional[tp.Tuple[int, int]] = None,
    user_reset_values: tp.Optional[np.ndarray] = None,
    item_reset_cols: tp.Optional[tp.Tuple[int, int]] = None,
    item_reset_values: tp.Optional[np.ndarray] = None,
    batch_size: int = 2048,
    device: DeviceLike = "cuda",
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Full ALS loop with optional explicit-feature column resetting, the
    whole iteration loop on ``device`` (JAX ``_als_fit_resident``).

    The reset hooks replicate the reference's combined feature training
    (implicit_als.py:596-628): after each user half-step the user explicit
    columns are overwritten back to the raw features, after each item
    half-step the item explicit columns likewise.

    `ui_csr` values must already include the alpha confidence scaling.
    """
    dev = resolve_device(device)
    n_users, n_items = ui_csr.shape
    user_buckets = _upload_buckets(ui_csr, batch_size, dev)
    item_buckets = _upload_buckets(ui_csr.T.tocsr(copy=False), batch_size, dev)
    reg = float(regularization)
    u_dev = host_to_device(np.asarray(user_factors, dtype=np.float32), dev)
    i_dev = host_to_device(np.asarray(item_factors, dtype=np.float32), dev)
    u_reset = None if user_reset_values is None else host_to_device(np.asarray(user_reset_values, np.float32), dev)
    i_reset = None if item_reset_values is None else host_to_device(np.asarray(item_reset_values, np.float32), dev)

    for _ in range(iterations):
        u_dev = _half_step(i_dev, user_buckets, n_users, reg)
        if user_reset_cols is not None:
            s, e = user_reset_cols
            u_dev[:, s:e] = u_reset
        i_dev = _half_step(u_dev, item_buckets, n_items, reg)
        if item_reset_cols is not None:
            s, e = item_reset_cols
            i_dev[:, s:e] = i_reset
    return u_dev.cpu().numpy(), i_dev.cpu().numpy()
