"""Streaming logsumexp and the fused softmax-CE gradients: hand-written CUDA
kernels and their plain PyTorch twins.

Port of rectools_tpu/ops/softmax_lse.py, the two routes the full-catalog
softmax loss takes:

- :func:`streaming_lse` — ``logsumexp_n(sessions @ itemsᵀ)[m]`` without the
  (M, N) logits reaching device memory (``csrc/softmax_lse.cu``
  ``lse_f32``). It is the ``row_bias=None``, ``bounded_shift=False`` route of
  the JAX ``_lse_call`` and forward-only: the CE loss differentiates through
  :func:`softmax_ce_grads_from_z` instead, and the generic ``streaming_lse``
  VJP (kernel 9) is not on the port's path.
- :func:`softmax_ce_grads_from_z` — ``ds = (P − D) @ items`` and
  ``di = (P − D)ᵀ @ sessions`` with ``P = exp(sessions @ itemsᵀ − z)`` and
  ``D = coeff · onehot(y)``: two kernels launched back to back
  (``ce_ds_f32``, ``ce_di_f32``), each recomputing the logits.

CPU tensors take the twins, which walk the catalog in item chunks exactly as
the kernels walk their tiles (running max for the lse; label correction and
tail handling per chunk for the gradients). Rows with ``z = +inf`` (PAD
targets, ``coeff = 0``) contribute nothing.
"""

import ctypes
import typing as tp

import torch

from . import _native

_C = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # sessions, items, lse; M, N, D; stream
    "lse_f32": (_C, _C, _C, _LL, _LL, _I, _C),
    # sessions, items, z, y (int64), coeff, out; M, N, D; stream
    "ce_ds_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    "ce_di_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
}
SUPPORTED_D = (16, 32, 64, 128, 256)
TWIN_CHUNK = 2048  # item columns per step of the plain twins


def streaming_lse_reference(sessions: torch.Tensor, items: torch.Tensor, chunk: int = TWIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_f32``: running (max, Σexp) over item chunks."""
    m_run = torch.full((sessions.shape[0],), float("-inf"), dtype=torch.float32, device=sessions.device)
    l_run = torch.zeros_like(m_run)
    for start in range(0, items.shape[0], chunk):
        logits = sessions @ items[start : start + chunk].T
        m_new = torch.maximum(m_run, logits.max(dim=1).values)
        l_run = l_run * torch.exp(m_run - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m_run = m_new
    return m_run + torch.log(l_run)


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


def streaming_lse(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    row_bias: tp.Optional[torch.Tensor] = None,
    bounded_shift: bool = False,
) -> torch.Tensor:
    """(M,) ``logsumexp_n(sessions @ itemsᵀ)`` in float32 (kernel 6)."""
    if row_bias is not None:
        raise NotImplementedError(
            "streaming_lse: a per-item row bias is the sharded route (kernel 8, "
            "rectools_tpu/ops/softmax_lse.py:99), which is not ported"
        )
    if bounded_shift:
        raise NotImplementedError(
            "streaming_lse: bounded_shift is kernel 16 (rectools_tpu/ops/softmax_lse.py:50), which is not ported"
        )
    if sessions.device.type == "cpu":
        return streaming_lse_reference(sessions, items)
    _native.require_cuda_f32("lse_fwd", forward_only=True, sessions=sessions, items=items)
    m, n, d = _check("lse_fwd", sessions, items)
    lse = torch.empty((m,), dtype=torch.float32, device=sessions.device)
    lib = _native.load("softmax_lse", _SIGNATURES)
    with torch.cuda.device(sessions.device):
        status = lib.lse_f32(
            sessions.data_ptr(), items.data_ptr(), lse.data_ptr(), m, n, d,
            _native.current_stream_ptr(sessions.device),
        )
    _native.check_launch("lse_fwd", status)
    return lse


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
