"""Attention forward: a hand-written CUDA kernel and its plain PyTorch twin.

Port of rectools_tpu/ops/attention.py (forward, dropout off). The score
``q kᵀ · scale + bias``, the softmax and the value product run in one kernel
(``csrc/attention.cu``) for CUDA tensors, and in :func:`attention_reference`
for CPU tensors. Masks are finite additive biases (``MASK_VALUE = -1e9`` in
net_blocks), never ``-inf``. The counter-hash dropout and the backward kernel
come with the training slice: a positive ``dropout_rate`` raises. The kernel
takes head dims 8, 16, 32 and 64 (``SUPPORTED_HEAD_DIMS``); others raise on
CUDA.
"""

import ctypes
import typing as tp

import torch

from . import _native

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "attn_fwd_f32": (_C, _C, _C, _C, _C, _C, _I, _I, _I, _I) + (_L,) * 14 + (ctypes.c_float, _C),
}
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64)


def attention_reference(
    q: torch.Tensor,  # (B, H, L, dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],  # (B|1, H|1, L, L) additive, or None
    scale: float,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: (out (B, H, L, dh), lse (B, H, L))."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out, lse


def _check_bias(bias: torch.Tensor, b: int, h: int, l: int) -> None:
    if bias.dim() != 4 or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h) or bias.shape[2:] != (l, l):
        raise ValueError(
            f"attention_fwd: bias must be (1|B, 1|H, L, L) = (1|{b}, 1|{h}, {l}, {l}), got {tuple(bias.shape)}"
        )
    if not bias.is_contiguous():
        raise ValueError("attention_fwd: bias must be contiguous")


def attention_fwd(
    q: torch.Tensor,  # (B, H, L, dh), any strides with a unit last stride
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],
    scale: float,
    dropout_rate: float = 0.0,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q kᵀ · scale + bias) v and the row logsumexp (float32).

    On CUDA the output is a (B, H, L, dh) view over (B, L, H, dh) memory, so
    ``out.transpose(1, 2)`` is contiguous in the projections' layout.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout (the counter-hash keep mask of rectools_tpu/ops/attention.py:43-101) "
            "is ported with the training slice; serving runs with dropout_rate=0"
        )
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    tensors = {"q": q, "k": k, "v": v} if bias is None else {"q": q, "k": k, "v": v, "bias": bias}
    _native.require_cuda_f32("attention_fwd", **tensors)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"attention_fwd: q, k, v must share one (B, H, L, dh) shape, got {q.shape}, {k.shape}, {v.shape}"
        )
    b, h, l, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention_fwd: head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    for t in (q, k, v):
        _native.require_aligned("attention_fwd", t, (0, 1, 2))
    bias_sb = bias_sh = 0
    if bias is not None:
        _check_bias(bias, b, h, l)
        bias_sb = bias.stride(0) if bias.shape[0] > 1 else 0
        bias_sh = bias.stride(1) if bias.shape[1] > 1 else 0

    out = torch.empty((b, l, h, dh), dtype=torch.float32, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _native.load("attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        status = lib.attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, l, dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            bias_sb, bias_sh, scale, _native.current_stream_ptr(q.device),
        )
    _native.check_launch("attention_fwd", status)
    return out, lse


def dot_product_attention(
    q: torch.Tensor,  # (B, L, H, dh) — the layout the MHA module produces
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],  # (B|1, H|1, L, L) additive, or None
    scale: float,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Attention entry point for the transformer stack, (B, L, H, dh) in and out
    (rectools_tpu/ops/attention.py:603-641). The transposes are views: the
    kernel reads and writes this layout through strides."""
    out, _ = attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, scale, dropout_rate)
    return out.transpose(1, 2)
