"""Streaming logsumexp, its gradients and the fused softmax-CE gradients:
hand-written CUDA kernels and their plain PyTorch twins.

Port of rectools_tpu/ops/softmax_lse.py, the routes the full-catalog softmax
loss takes:

- :func:`streaming_lse` — ``logsumexp_n(sessions @ itemsᵀ + row_bias)[m]``
  without the (M, N) logits reaching device memory. Without a bias it is
  ``lse_f32`` (kernel 6), with one ``lse_bias_f32`` (kernel 8). It is
  differentiable through one ``torch.autograd.Function`` whose backward is
  the generic VJP of the JAX ``_streaming_lse_bwd``: the single-pass
  ``lse_bwd_fused_f32`` (kernel 9) while its partial sums fit
  ``FUSED_BWD_PARTIALS_BUDGET``, else ``lse_bwd_ds_f32`` + ``lse_bwd_di_f32``
  (kernels 10 and 11). The bias gets no gradient.
- :func:`sharded_streaming_lse` — the item table row-sharded over one axis of
  a process mesh: each rank runs :func:`streaming_lse` on its slice with a
  0 / -1e30 validity bias and the ranks merge their results with one (M,)
  sized all-gather. This is the loss of mesh training.
- :func:`softmax_ce_grads_from_z` — ``ds = (P − D) @ items`` and
  ``di = (P − D)ᵀ @ sessions`` with ``P = exp(sessions @ itemsᵀ − z)`` and
  ``D = coeff · onehot(y)``: two kernels launched back to back
  (``ce_ds_f32``, ``ce_di_f32``), each recomputing the logits. The
  single-device CE loss differentiates through it.

CPU tensors take the twins, which walk the catalog in item chunks exactly as
the kernels walk their tiles (running max for the lse; label correction and
tail handling per chunk for the gradients). Rows with ``z = +inf`` (PAD
targets, ``coeff = 0``) contribute nothing.
"""

import ctypes
import typing as tp

import torch

from ..parallel import collectives
from ..parallel.mesh import ProcessMesh
from . import _native

_C = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # sessions, items, lse; M, N, D; stream
    "lse_f32": (_C, _C, _C, _LL, _LL, _I, _C),
    # sessions, items, bias, lse; M, N, D; stream
    "lse_bias_f32": (_C, _C, _C, _C, _LL, _LL, _I, _C),
    # sessions, items, z, y (int64), coeff, out; M, N, D; stream
    "ce_ds_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    "ce_di_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    # sessions, items, bias, lse, dlse, out; M, N, D; stream
    "lse_bwd_ds_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    "lse_bwd_di_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    # sessions, items, bias, lse, dlse, ds partials, di partials; M, N, D; chunk rows, tiles per group; stream
    "lse_bwd_fused_f32": (_C,) * 7 + (_LL, _LL, _I, _LL, _LL, _C),
}
SUPPORTED_D = (16, 32, 64, 128, 256)
TWIN_CHUNK = 2048  # item columns per step of the plain twins
NEG_BIG = -1e30  # bias of an item row that only pads a shard
TILE = 64  # session and item rows per kernel tile

# The fused backward writes its ds partials per item chunk, (n_chunks, M, D),
# and its di partials per group of session tiles, (n_groups, N, D). Above this
# many bytes of partials the backward takes the two split kernels instead: no
# partials, one more logit pass (the JAX package's constant and rule).
FUSED_BWD_PARTIALS_BUDGET = 512 * 1024 * 1024
FUSED_BWD_CHUNK = 2048  # item rows a block of the fused backward owns
FUSED_BWD_BLOCKS_PER_SM = 2  # blocks of the fused backward that share a multiprocessor


def _running_lse(
    sessions: torch.Tensor, items: torch.Tensor, row_bias: tp.Optional[torch.Tensor], chunk: int, start_max: float
) -> torch.Tensor:
    """Running (max, Σexp) over item chunks, the max starting at ``start_max``."""
    m_run = torch.full((sessions.shape[0],), start_max, dtype=torch.float32, device=sessions.device)
    l_run = torch.zeros_like(m_run)
    for start in range(0, items.shape[0], chunk):
        logits = sessions @ items[start : start + chunk].T
        if row_bias is not None:
            logits = logits + row_bias[start : start + chunk][None, :]
        m_new = torch.maximum(m_run, logits.max(dim=1).values)
        l_run = l_run * torch.exp(m_run - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m_run = m_new
    return m_run + torch.log(l_run)


def streaming_lse_reference(sessions: torch.Tensor, items: torch.Tensor, chunk: int = TWIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_f32``: running (max, Σexp) over item chunks."""
    return _running_lse(sessions, items, None, chunk, float("-inf"))


def streaming_lse_bias_reference(
    sessions: torch.Tensor, items: torch.Tensor, row_bias: torch.Tensor, chunk: int = TWIN_CHUNK
) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_bias_f32``. The running max starts at
    -1e30 as in the kernel, so a table whose every row is invalid gives
    ``-1e30 + log(count)`` and never NaN."""
    return _running_lse(sessions, items, row_bias, chunk, NEG_BIG)


def streaming_lse_bwd_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    row_bias: torch.Tensor,
    lse: torch.Tensor,
    dlse: torch.Tensor,
    chunk: int = TWIN_CHUNK,
    partials: bool = True,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the lse backward kernels: (ds, di) with
    ``pw = exp((logits + bias) − lse) · dlse``, ``ds = pw @ items`` and
    ``di = pwᵀ @ sessions``. ``partials=True`` sums one ds partial per item
    chunk at the end, as the fused kernel's caller does; ``False`` carries a
    running sum, as the split ds kernel does."""
    di = torch.empty_like(items)
    ds_parts = []
    for start in range(0, items.shape[0], chunk):
        block = items[start : start + chunk]
        logits = sessions @ block.T + row_bias[start : start + chunk][None, :]
        pw = torch.exp(logits - lse[:, None]) * dlse[:, None]
        part = pw @ block
        if partials or not ds_parts:
            ds_parts.append(part)
        else:
            ds_parts[0] = ds_parts[0] + part
        di[start : start + block.shape[0]] = pw.T @ sessions
    if not ds_parts:
        return torch.zeros_like(sessions), di
    return (torch.stack(ds_parts).sum(dim=0) if len(ds_parts) > 1 else ds_parts[0]), di


def softmax_ce_grads_from_z_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    z: torch.Tensor,
    y: torch.Tensor,
    coeff: torch.Tensor,
    chunk: int = TWIN_CHUNK,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``ce_ds_f32`` / ``ce_di_f32``: (ds, di)."""
    ds = torch.zeros_like(sessions)
    di = torch.empty_like(items)
    for start in range(0, items.shape[0], chunk):
        block = items[start : start + chunk]
        pw = torch.exp(sessions @ block.T - z[:, None])
        cols = torch.arange(start, start + block.shape[0], device=sessions.device)
        pw = torch.where(cols[None, :] == y[:, None], pw - coeff[:, None], pw)
        ds += pw @ block
        di[start : start + block.shape[0]] = pw.T @ sessions
    return ds, di


def _check(kernel: str, sessions: torch.Tensor, items: torch.Tensor) -> tp.Tuple[int, int, int]:
    if sessions.dim() != 2 or items.dim() != 2 or sessions.shape[1] != items.shape[1]:
        raise ValueError(
            f"{kernel}: sessions (M, D) and items (N, D) must share D, got {sessions.shape}, {items.shape}"
        )
    m, d = sessions.shape
    if d not in SUPPORTED_D:
        raise ValueError(f"{kernel}: D must be one of {SUPPORTED_D}, got {d}")
    for t in (sessions, items):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: sessions and items must be contiguous")
        _native.require_aligned(kernel, t, (0,))
    return m, items.shape[0], d


def _check_vectors(kernel: str, rows: int, what: str, **vectors: torch.Tensor) -> None:
    for name, t in vectors.items():
        if t.shape != (rows,) or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous ({rows},) vector, one entry per {what}")


def streaming_lse_fwd(
    sessions: torch.Tensor, items: torch.Tensor, row_bias: tp.Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(M,) float32 lse, no autograd: kernel 6 without a bias, kernel 8 with one."""
    if sessions.device.type == "cpu":
        if row_bias is None:
            return streaming_lse_reference(sessions, items)
        return streaming_lse_bias_reference(sessions, items, row_bias)
    kernel = "lse_fwd" if row_bias is None else "lse_bias_fwd"
    tensors = {"sessions": sessions, "items": items}
    if row_bias is not None:
        tensors["row_bias"] = row_bias
    _native.require_cuda_f32(kernel, **tensors)
    m, n, d = _check(kernel, sessions, items)
    lse = torch.empty((m,), dtype=torch.float32, device=sessions.device)
    lib = _native.load("softmax_lse", _SIGNATURES)
    stream = _native.current_stream_ptr(sessions.device)
    with torch.cuda.device(sessions.device):
        if row_bias is None:
            status = lib.lse_f32(sessions.data_ptr(), items.data_ptr(), lse.data_ptr(), m, n, d, stream)
        else:
            _check_vectors(kernel, n, "item row", row_bias=row_bias)
            status = lib.lse_bias_f32(
                sessions.data_ptr(), items.data_ptr(), row_bias.data_ptr(), lse.data_ptr(), m, n, d, stream
            )
    _native.check_launch(kernel, status)
    return lse


def fused_bwd_plan(m: int, n: int, d: int, n_sms: int) -> tp.Tuple[int, int, int]:
    """(tiles per session group, n_groups, bytes of partials) of the fused
    backward: one block per (item chunk, session group), and no more blocks
    than ``FUSED_BWD_BLOCKS_PER_SM`` per multiprocessor, so that all run in one
    wave (a few blocks over it and the last ones run alone: twice the time).
    Two blocks share a multiprocessor's registers and shared memory at
    D <= 128, and two hide each other's latency: one per multiprocessor
    measured a third slower."""
    n_chunks = max(1, -(-n // FUSED_BWD_CHUNK))
    m_tiles = max(1, -(-m // TILE))
    tiles_per_group = -(-m_tiles // max(1, FUSED_BWD_BLOCKS_PER_SM * n_sms // n_chunks))
    n_groups = -(-m_tiles // tiles_per_group)
    return tiles_per_group, n_groups, (n_chunks * m + n_groups * n) * d * 4


def streaming_lse_bwd(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    row_bias: tp.Optional[torch.Tensor],  # (N,) or None = all zeros
    lse: torch.Tensor,  # (M,) the forward's result
    dlse: torch.Tensor,  # (M,) cotangent, any sign
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(ds, di) of :func:`streaming_lse`: kernel 9, or kernels 10 + 11 when the
    fused kernel's partials would pass ``FUSED_BWD_PARTIALS_BUDGET``."""
    if row_bias is None:
        row_bias = torch.zeros((items.shape[0],), dtype=torch.float32, device=items.device)
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    if sessions.device.type == "cpu":
        # the twin keeps the kernels' two summation orders; 132 = an H100's multiprocessors
        fused = fused_bwd_plan(m, n, d, 132)[2] <= FUSED_BWD_PARTIALS_BUDGET
        return streaming_lse_bwd_reference(sessions, items, row_bias, lse, dlse, partials=fused)
    _native.require_cuda_f32(
        "lse_bwd", sessions=sessions, items=items, row_bias=row_bias, lse=lse, dlse=dlse
    )
    _check("lse_bwd", sessions, items)
    _check_vectors("lse_bwd", n, "item row", row_bias=row_bias)
    _check_vectors("lse_bwd", m, "session row", lse=lse, dlse=dlse)
    n_sms = torch.cuda.get_device_properties(sessions.device).multi_processor_count
    tiles_per_group, n_groups, partials_bytes = fused_bwd_plan(m, n, d, n_sms)
    if m == 0 or n == 0:
        return torch.zeros_like(sessions), torch.zeros_like(items)
    lib = _native.load("softmax_lse", _SIGNATURES)
    stream = _native.current_stream_ptr(sessions.device)
    args = (sessions.data_ptr(), items.data_ptr(), row_bias.data_ptr(), lse.data_ptr(), dlse.data_ptr())
    if partials_bytes <= FUSED_BWD_PARTIALS_BUDGET:
        n_chunks = -(-n // FUSED_BWD_CHUNK)
        ds_part = torch.empty((n_chunks, m, d), dtype=torch.float32, device=sessions.device)
        di_part = torch.empty((n_groups, n, d), dtype=torch.float32, device=sessions.device)
        with torch.cuda.device(sessions.device):
            status = lib.lse_bwd_fused_f32(
                *args, ds_part.data_ptr(), di_part.data_ptr(), m, n, d, FUSED_BWD_CHUNK, tiles_per_group, stream
            )
        _native.check_launch("lse_bwd_fused", status)
        # fixed-order sums of the partials
        ds = ds_part.sum(dim=0) if n_chunks > 1 else ds_part[0]
        di = di_part.sum(dim=0) if n_groups > 1 else di_part[0]
        return ds, di
    ds = torch.empty_like(sessions)
    di = torch.empty_like(items)
    with torch.cuda.device(sessions.device):
        status = lib.lse_bwd_ds_f32(*args, ds.data_ptr(), m, n, d, stream)
        _native.check_launch("lse_bwd_ds", status)
        status = lib.lse_bwd_di_f32(*args, di.data_ptr(), m, n, d, stream)
    _native.check_launch("lse_bwd_di", status)
    return ds, di


class _StreamingLSE(torch.autograd.Function):
    """Kernel 6 or 8 forward, kernel 9 (or 10 + 11) backward; the bias is a
    constant validity mask and gets no gradient."""

    @staticmethod
    def forward(ctx, sessions, items, row_bias):  # type: ignore[override]
        lse = streaming_lse_fwd(sessions, items, row_bias)
        ctx.save_for_backward(sessions, items, row_bias, lse)
        return lse

    @staticmethod
    def backward(ctx, dlse):  # type: ignore[override]
        sessions, items, row_bias, lse = ctx.saved_tensors
        ds, di = streaming_lse_bwd(sessions, items, row_bias, lse, dlse.float().contiguous())
        return ds.to(sessions.dtype), di.to(items.dtype), None


def streaming_lse(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    row_bias: tp.Optional[torch.Tensor] = None,  # (N,) additive; -1e30 = invalid row
    bounded_shift: bool = False,
) -> torch.Tensor:
    """(M,) ``logsumexp_n(sessions @ itemsᵀ + row_bias)`` in float32,
    differentiable in ``sessions`` and ``items``."""
    if bounded_shift:
        raise NotImplementedError(
            "streaming_lse: bounded_shift is kernel 16 (rectools_tpu/ops/softmax_lse.py:50), which waits for "
            "ROADMAP.md §1 item 1 (slice 5: kernels 12-16)"
        )
    if row_bias is not None and row_bias.requires_grad:
        raise ValueError("streaming_lse: row_bias is a constant validity mask and cannot require a gradient")
    if torch.is_grad_enabled() and (sessions.requires_grad or items.requires_grad):
        return _StreamingLSE.apply(sessions, items, row_bias)
    return streaming_lse_fwd(sessions, items, row_bias)


class _ShardedStreamingLSE(torch.autograd.Function):
    """The lse over a row-sharded item table, merged over the shard axis."""

    @staticmethod
    def forward(ctx, sessions, items, mesh: ProcessMesh, shard_axis: str):  # type: ignore[override]
        n_shards, shard = mesh.size(shard_axis), mesh.index(shard_axis)
        n = items.shape[0]
        per_shard = -(-n // n_shards)
        start = min(shard * per_shard, n)
        local_items = items[start : start + per_shard]
        n_valid = local_items.shape[0]
        if n_valid < per_shard:  # zero rows behind the catalog's end, marked invalid
            local_items = torch.cat([local_items, local_items.new_zeros((per_shard - n_valid, items.shape[1]))])
        local_items = local_items.contiguous()
        bias = torch.zeros((per_shard,), dtype=torch.float32, device=items.device)
        bias[n_valid:] = NEG_BIG
        local_lse = streaming_lse_fwd(sessions, local_items, bias)
        # logsumexp merge over the shards: one (M,) all-gather
        gathered = torch.stack(collectives.all_gather(local_lse, mesh.group(shard_axis)))
        top = gathered.max(dim=0).values
        lse = top + torch.log(torch.exp(gathered - top[None, :]).sum(dim=0))
        ctx.save_for_backward(sessions, local_items, bias, local_lse, lse)
        ctx.mesh, ctx.shard_axis, ctx.n_items = mesh, shard_axis, n
        return lse

    @staticmethod
    def backward(ctx, dlse):  # type: ignore[override]
        sessions, local_items, bias, local_lse, lse = ctx.saved_tensors
        group = ctx.mesh.group(ctx.shard_axis)
        local_dlse = (dlse.float() * torch.exp(local_lse - lse)).contiguous()
        ds, di_local = streaming_lse_bwd(sessions, local_items, bias, local_lse, local_dlse)
        # sessions are replicated over the shard axis: their gradient is the
        # sum of the shards' parts; each shard owns its rows of di
        ds = collectives.all_reduce_sum(ds, group)
        di = torch.cat(collectives.all_gather(di_local, group))[: ctx.n_items]
        return ds.to(sessions.dtype), di.to(local_items.dtype), None, None


def sharded_streaming_lse(
    sessions: torch.Tensor,  # (M, D): this rank's session rows, the same on every rank of the shard axis
    items: torch.Tensor,  # (N, D): the whole item tower, the same on every rank
    mesh: ProcessMesh,
    shard_axis: str,
    data_axis: tp.Optional[str] = None,
) -> torch.Tensor:
    """Tensor-parallel streaming lse (rectools_tpu/ops/softmax_lse.py:549-588):
    the item tower is cut into ``mesh.size(shard_axis)`` row slices, padded
    with zero rows that a -1e30 bias marks invalid; each rank runs the local
    kernel on its slice and the ranks of the shard axis merge their (M,)
    results. Every rank of a shard group must call it together. The gradient
    of ``sessions`` is summed over the shard axis and the rows of the tower's
    gradient are gathered over it, so both come out whole on every rank.

    ``data_axis`` names the axis the session rows are sharded over. One
    process holds one data shard, so nothing moves along it here; the caller
    sums parameter gradients over it."""
    del data_axis
    return _ShardedStreamingLSE.apply(sessions.contiguous(), items.contiguous(), mesh, shard_axis)


def softmax_ce_grads_from_z(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    z: torch.Tensor,  # (M,) f32: lse - log(row cotangent magnitude), +inf = ignore row
    y: torch.Tensor,  # (M,) int label ids; rows with coeff == 0 are ignored
    coeff: torch.Tensor,  # (M,) f32 nonnegative row cotangent magnitude
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(ds, di) = ((P − D) @ items, (P − D)ᵀ @ sessions) (kernel 7, two launches)."""
    if sessions.device.type == "cpu":
        return softmax_ce_grads_from_z_reference(sessions, items, z, y, coeff)
    _native.require_cuda_f32("ce_grads", sessions=sessions, items=items, z=z, coeff=coeff)
    m, n, d = _check("ce_grads", sessions, items)
    if z.shape != (m,) or coeff.shape != (m,) or y.shape != (m,):
        raise ValueError(f"ce_grads: z, y and coeff must be ({m},)")
    if y.device != sessions.device or y.dtype.is_floating_point:
        raise ValueError(f"ce_grads: y must be an integer tensor on {sessions.device}")
    y = y.to(torch.int64).contiguous()
    z, coeff = z.contiguous(), coeff.contiguous()
    ds = torch.empty_like(sessions)
    di = torch.empty_like(items)
    lib = _native.load("softmax_lse", _SIGNATURES)
    stream = _native.current_stream_ptr(sessions.device)
    args = (sessions.data_ptr(), items.data_ptr(), z.data_ptr(), y.data_ptr(), coeff.data_ptr())
    with torch.cuda.device(sessions.device):
        status = lib.ce_ds_f32(*args, ds.data_ptr(), m, n, d, stream)
        _native.check_launch("ce_grads_ds", status)
        status = lib.ce_di_f32(*args, di.data_ptr(), m, n, d, stream)
    _native.check_launch("ce_grads_di", status)
    return ds, di
