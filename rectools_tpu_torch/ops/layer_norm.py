"""LayerNorm forward: a hand-written CUDA kernel and its plain PyTorch twin.

Port of rectools_tpu/ops/layer_norm.py (forward). Math follows flax
``nn.LayerNorm``: reductions in f32, two-pass variance, ``rsqrt(var + eps)``,
output in the input dtype. A CUDA tensor goes to ``csrc/layer_norm.cu``; a
CPU tensor goes to :func:`layer_norm_reference`. The backward kernel comes
with the training slice.
"""

import ctypes

import torch

from . import _native

_C = ctypes.c_void_p
_SIGNATURES = {"ln_fwd_f32": (_C, _C, _C, _C, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _C)}
MAX_D = 1024


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (flax ``nn.LayerNorm`` semantics)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a 2-D (M, D) input."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    _native.require_cuda_f32("layer_norm_fwd", x=x, gamma=gamma, beta=beta)
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_D:
        raise ValueError(f"layer_norm_fwd: x must be (M, D) with 1 <= D <= {MAX_D}, got {tuple(x.shape)}")
    m, d = x.shape
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"layer_norm_fwd: gamma and beta must be ({d},)")
    if not (x.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("layer_norm_fwd: inputs must be contiguous")
    y = torch.empty_like(x)
    lib = _native.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        status = lib.ln_fwd_f32(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), m, d, eps,
            _native.current_stream_ptr(x.device),
        )
    _native.check_launch("layer_norm_fwd", status)
    return y
