"""LayerNorm forward and backward: hand-written CUDA kernels, their plain
PyTorch twins and the ``torch.autograd.Function`` that joins them.

Port of rectools_tpu/ops/layer_norm.py. Math follows flax ``nn.LayerNorm``:
reductions in f32, two-pass variance, ``rsqrt(var + eps)``. The backward
recomputes the row statistics from x (as the JAX ``_bwd_kernel`` does) and
returns dx, dγ and dβ, in one launch whose last block sums the per-block
partials of dγ and dβ in a fixed order (:func:`bwd_partition`). A CUDA tensor
goes to ``csrc/layer_norm.cu`` (``ln_fwd_f32``, ``ln_bwd_f32``); a CPU tensor
goes to the twins.

bf16 activations (mixed-precision training) take the bf16 forms
``ln_fwd_bf16`` and ``ln_bwd_bf16`` (launch keys ``layer_norm_fwd_bf16``,
``layer_norm_bwd_bf16``): the f32 kernels on bf16 x, y, dy and dx, with γ
and β in bf16 (the cast parameters) or f32. They read bf16, keep the f32
arithmetic and order, and round y and dx to bf16 and dγ, dβ to γ's dtype
once each, where the JAX kernels store them
(rectools_tpu/ops/layer_norm.py:33, 58, 133): the widened f32 route's bits.
Their twins (:func:`layer_norm_bf16_reference`,
:func:`layer_norm_bwd_bf16_reference`) are the f32 twins on the widened
values, rounded at those points. f32 x with bf16 γ has no form and raises
``ValueError``, on the CPU as on the card.
"""

import ctypes
import typing as tp

import torch

from . import _native

_C = ctypes.c_void_p
_SIGNATURES = {
    "ln_fwd_f32": (_C, _C, _C, _C, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _C),
    # x, gamma, dy, dx, partials (n_blocks, 2, D), counter, dgamma, dbeta, m, d, eps, n_blocks, rows per block,
    # stream
    "ln_bwd_f32": (_C,) * 8 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_longlong, _C),
    # as ln_fwd_f32 on bf16 x and y; gamma and beta bf16 (1) or f32 (0); stream
    "ln_fwd_bf16": (_C, _C, _C, _C, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, _C),
    # as ln_bwd_f32 on bf16 x, dy and dx (f32 partials); gamma, dgamma and dbeta bf16 (1) or f32 (0); stream
    "ln_bwd_bf16": (_C,) * 8 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_int, _C),
}
MAX_D = 1024
# The backward's partition (`bwd_partition`): a function of nothing but the row
# count, so the fixed-order dγ/dβ sums give the same bits on every card. At
# most 128 blocks (one a multiprocessor, one wave on an H100), of at least 128
# rows; the partial rows the last block sums stay few. 256 blocks of 8 warps
# ran 4% slower at 51,200 x 128 (PERF.md section 6).
MAX_BWD_BLOCKS = 128
BWD_MIN_ROWS = 128
# one ticket counter per (device, stream) for the backward's last-block sums,
# zeroed once; each launch leaves it at 0
_COUNTERS: tp.Dict[tp.Tuple[int, int], torch.Tensor] = {}


def bwd_partition(m: int) -> tp.Tuple[int, int]:
    """(blocks, rows per block) of the backward kernel for ``m`` rows: block b
    owns rows [b · rows, (b + 1) · rows), none of them empty."""
    blocks = max(1, min(MAX_BWD_BLOCKS, -(-m // BWD_MIN_ROWS)))
    rows = max(1, -(-m // blocks))
    return max(1, -(-m // rows)), rows


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel (flax ``nn.LayerNorm`` semantics)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def layer_norm_bwd_reference(
    x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the backward kernel: (dx, dγ, dβ)."""
    xf, dyf = x.float(), dy.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = dyf * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(0).to(gamma.dtype), dyf.sum(0).to(gamma.dtype)


def layer_norm_bf16_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain PyTorch twin of ``ln_fwd_bf16``: the f32 twin on the widened
    values, y rounded to bf16 once (rectools_tpu/ops/layer_norm.py:33)."""
    return layer_norm_reference(x.float(), gamma.float(), beta.float(), eps).to(torch.bfloat16)


def layer_norm_bwd_bf16_reference(
    x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``ln_bwd_bf16``: the f32 twin on the widened
    values, dx rounded to bf16 and dγ, dβ to γ's dtype, once each
    (rectools_tpu/ops/layer_norm.py:58, 133)."""
    dx, dgamma, dbeta = layer_norm_bwd_reference(x.float(), gamma.float(), dy.float(), eps)
    return dx.to(torch.bfloat16), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _check(kernel: str, x: torch.Tensor, gamma: torch.Tensor, *others: torch.Tensor) -> tp.Tuple[int, int]:
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_D:
        raise ValueError(f"{kernel}: x must be (M, D) with 1 <= D <= {MAX_D}, got {tuple(x.shape)}")
    m, d = x.shape
    if gamma.shape != (d,):
        raise ValueError(f"{kernel}: gamma and beta must be ({d},)")
    if not all(t.is_contiguous() for t in (x, gamma, *others)):
        raise ValueError(f"{kernel}: inputs must be contiguous")
    return m, d


def _bf16_form(kernel: str, x: torch.Tensor, gamma: torch.Tensor) -> bool:
    """Whether a call takes the bf16 form (bf16 x, γ in bf16 or f32). f32 x
    with bf16 γ raises: no form reads that pair, and no wrapper widens or
    narrows an operand."""
    if x.dtype == torch.bfloat16 and gamma.dtype in (torch.bfloat16, torch.float32):
        return True
    if x.dtype != gamma.dtype:
        raise ValueError(f"{kernel}: x of {x.dtype} with gamma of {gamma.dtype} has no kernel form; "
                         f"bf16 x takes bf16 or float32 gamma, float32 x float32 gamma")
    return False


def _same_device(kernel: str, x: torch.Tensor, gamma: torch.Tensor) -> None:
    if gamma.device != x.device:
        raise ValueError(f"{kernel}: all inputs must be on one device")


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a 2-D (M, D) input (kernel 1): y in
    x's dtype; bf16 x through the bf16 form."""
    _native.same_dtype("layer_norm_fwd", gamma=gamma, beta=beta)
    bf16 = _bf16_form("layer_norm_fwd", x, gamma)
    if x.device.type == "cpu":
        return (layer_norm_bf16_reference if bf16 else layer_norm_reference)(x, gamma, beta, eps)
    kernel = "layer_norm_fwd_bf16" if bf16 else "layer_norm_fwd"
    # pinned dtypes: a float16 or float64 x must not reach the f32 kernel (_bf16_form passes same-dtype pairs)
    _native.require_cuda(kernel, torch.bfloat16 if bf16 else torch.float32, x=x)
    _native.require_cuda(kernel, gamma.dtype if bf16 else torch.float32, gamma=gamma, beta=beta)
    _same_device(kernel, x, gamma)
    m, d = _check(kernel, x, gamma, beta)
    if beta.shape != (d,):
        raise ValueError(f"{kernel}: gamma and beta must be ({d},)")
    y = torch.empty_like(x)
    lib = _native.load("layer_norm", _SIGNATURES)
    pointers = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), m, d, eps)
    stream = _native.current_stream_ptr(x.device)
    with torch.cuda.device(x.device):
        if bf16:
            status = lib.ln_fwd_bf16(*pointers, int(gamma.dtype == torch.bfloat16), stream)
        else:
            status = lib.ln_fwd_f32(*pointers, stream)
    _native.check_launch(kernel, status)
    return y


def layer_norm_bwd(
    x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dγ, dβ) of :func:`layer_norm_fwd` (kernel 4): dx in x's dtype, dγ
    and dβ in γ's; bf16 x through the bf16 form."""
    _native.same_dtype("layer_norm_bwd", x=x, dy=dy)
    bf16 = _bf16_form("layer_norm_bwd", x, gamma)
    if x.device.type == "cpu":
        return (layer_norm_bwd_bf16_reference if bf16 else layer_norm_bwd_reference)(x, gamma, dy, eps)
    kernel = "layer_norm_bwd_bf16" if bf16 else "layer_norm_bwd"
    _native.require_cuda(kernel, torch.bfloat16 if bf16 else torch.float32, x=x, dy=dy)
    _native.require_cuda(kernel, gamma.dtype if bf16 else torch.float32, gamma=gamma)
    _same_device(kernel, x, gamma)
    m, d = _check(kernel, x, gamma, dy)
    if dy.shape != x.shape:
        raise ValueError(f"{kernel}: dy must match x")
    n_blocks, rows = bwd_partition(m)
    dx = torch.empty_like(x)
    # one f32 scratch buffer: the (n_blocks, 2, D) partials, then dγ and dβ when γ is f32 (bf16 γ: their own)
    f32_sums = gamma.dtype == torch.float32
    scratch = torch.empty(((n_blocks + f32_sums) * 2 * d,), dtype=torch.float32, device=x.device)
    if f32_sums:
        sums = n_blocks * 2 * d
        dgamma, dbeta = scratch[sums : sums + d], scratch[sums + d :]
    else:
        dgamma, dbeta = torch.empty((2, d), dtype=gamma.dtype, device=x.device).unbind(0)
    lib = _native.load("layer_norm", _SIGNATURES)
    stream = _native.current_stream_ptr(x.device)
    key = (x.device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros((1,), dtype=torch.int32, device=x.device)
    counter = _COUNTERS[key]
    args = (x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), scratch.data_ptr(), counter.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), m, d, eps, n_blocks, rows)
    with torch.cuda.device(x.device):
        if bf16:
            status = lib.ln_bwd_bf16(*args, int(gamma.dtype == torch.bfloat16), stream)
        else:
            status = lib.ln_bwd_f32(*args, stream)
    _native.check_launch(kernel, status)
    return dx, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):  # type: ignore[override]
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):  # type: ignore[override]
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Differentiable LayerNorm over the last axis of a 2-D (M, D) input:
    kernels 1 and 4 (their bf16 forms for bf16 x) on CUDA, their twins on the
    CPU."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta)):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return layer_norm_fwd(x, gamma, beta, eps)
