"""Attention forward and backward: hand-written CUDA kernels and their plain
PyTorch twins, joined by a ``torch.autograd.Function``.

Port of rectools_tpu/ops/attention.py. The forward (``csrc/attention.cu``
``attn_fwd_f32``) computes ``dropout(softmax(q kᵀ · scale + bias)) v`` and
the pre-dropout row logsumexp in one kernel; the backward (``attn_bwd_f32``)
recomputes the probabilities from that logsumexp, regenerates the dropout
mask and writes dq, dk and dv. ``delta = sum(dout * out)`` is computed in
torch between the two, as the JAX package does. CPU tensors take the plain
twins (:func:`attention_reference`, :func:`attention_bwd_reference`).

Dropout is the counter hash of the JAX package (``dropout_keep_mask``): the
keep bit of (batch·head ``bh``, query row, key column) is a pure function of
``seed + bh · 40503`` and ``row · L + col``, so forward, backward, kernel and
twin all draw the same mask, bit for bit the JAX one for the same int32 seed.

Masks are finite additive biases (``MASK_VALUE = -1e9`` in net_blocks), never
``-inf``. The bias is a constant mask (the JAX ``bias_has_grad=False``
default): a bias that requires a gradient raises. The kernels take head dims
8, 16, 32 and 64 (``SUPPORTED_HEAD_DIMS``); others raise on CUDA. At head
dims 32 and 64 (``TC_HEAD_DIMS``) both run their products on the tensor
cores in 3xTF32 (each f32 operand as two TF32 halves; on an H100 as close to
float64 as the f32 FMA kernels at these depths); at 8 and 16 in f32 FMA.

bf16 q, k, v (mixed-precision training) take bf16 forms of both kernels in
``csrc/attention_bf16.cu`` (``attn_fwd_bf16``, ``attn_bwd_bf16``; launch keys
``attention_fwd_bf16``, ``attention_bwd_bf16``) at every head dim of
``SUPPORTED_HEAD_DIMS`` (``BF16_HEAD_DIMS``; at 8 the products over the head
dim are 8-deep ``mma`` steps): bf16 tensor-core products with f32
accumulation and the rounding points of the JAX package's route below L =
256 (scores rounded to bf16 after scale and bias, p rounded before p·v, and
in the backward dp, ds and the outputs), at every L. Their twins
(:func:`attention_bf16_reference`, :func:`attention_bwd_bf16_reference`) are
that route's math on the bf16 values in f32. The lse and the bias stay f32.
The bf16 forward (``attn_fwd_onepass_bf16_kernel``) forms every score once
and keeps the rounded row until p is formed from the finished lse: in
registers up to ``BF16_FWD_REG_KEYS`` keys, else in shared memory up to
``BF16_FWD_SMEM_KEYS``.
"""

import ctypes
import typing as tp

import torch

from . import _native

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# bias batch and head strides, scale, seed, dropout on, keep threshold, keep scale, stream
_TAIL = (_L, _L, _F, _I, _I, ctypes.c_uint, _F, _C)
_SIGNATURES = {
    # q, k, v, bias, out, lse; B, H, L, dh; (batch, head, row) strides of q, k, v, out
    "attn_fwd_f32": (_C,) * 6 + (_I,) * 4 + (_L,) * 12 + _TAIL,
    # q, k, v, bias, lse, delta, dout, dq, dk, dv; B, H, L, dh; strides of q, k, v, dout, dq, dk, dv
    "attn_bwd_f32": (_C,) * 10 + (_I,) * 4 + (_L,) * 21 + _TAIL,
}
_SIGNATURES_BF16 = {
    # q, k, v, bias, out, lse; B, H, L, dh; (batch, head, row) strides of q, k, v, out
    "attn_fwd_bf16": (_C,) * 6 + (_I,) * 4 + (_L,) * 12 + _TAIL,
    # q, k, v, bias, lse, delta, dout, dq, dk, dv, dq scratch; B, H, L, dh; strides of q, k, v, dout, dq, dk, dv
    "attn_bwd_bf16": (_C,) * 11 + (_I,) * 4 + (_L,) * 21 + _TAIL,
}
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64)
BF16_HEAD_DIMS = SUPPORTED_HEAD_DIMS
BF16_TILE = 64  # rows of the bf16 backward's tiles; it sums dq over more key tiles than one in f32 scratch
# The bf16 forward (csrc/attention_bf16.cu `attn_fwd_onepass_bf16_kernel`) in its rows mode (L <= BF16_FWD_REG_KEYS):
# a block per b and group of up to BF16_FWD_HEADS heads that share the bias (a per-head bias: one head), a warp per 16
# query rows, each row's rounded scores in registers; in its tiles mode (longer L): a block per (b, h) and
# BF16_FWD_TILE query rows, keys staged BF16_FWD_TILE at a time, the rounded rows in shared memory up to
# BF16_FWD_SMEM_KEYS keys (past that the second sweep forms them again from k).
BF16_FWD_REG_KEYS, BF16_FWD_HEADS, BF16_FWD_TILE, BF16_FWD_SMEM_KEYS = 128, 4, 64, 1024
# The head dims whose kernels run on the tensor cores (csrc/attention.cu
# `attn_tensor_cores`), and their tiles: a forward block owns FWD_TILE queries
# and walks the keys in tiles of FWD_TILE; a backward block owns a (b, h) row
# and walks the keys in tiles of BWD_KEY_TILE and, per key tile, the queries
# in tiles of BWD_QUERY_TILE. A warp's unit of work, 16 x 32 (forward:
# queries x keys; backward: keys x queries), is skipped when its bias masks
# all of it.
TC_HEAD_DIMS = (32, 64)
FWD_TILE = 64
BWD_KEY_TILE, BWD_QUERY_TILE = 128, 32

# The counter hash of rectools_tpu/ops/attention.py:39-75 on uint32 values held
# in int64: ``& MASK32`` after every multiply keeps the low 32 bits of the
# product whatever int64 overflow does to the high ones.
MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def mix32_fast(h: torch.Tensor) -> torch.Tensor:
    """Single-multiply finalizer used for dropout thresholds."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & MASK32
    return h ^ (h >> 15)


def dropout_threshold(rate: float) -> int:
    """Keep an element when its 32 hash bits are at least this value."""
    return min(MASK32, int(round(rate * 4294967296.0)))


def dropout_keep_mask(seed: int, b: int, h: int, l: int, rate: float, device: tp.Optional[torch.device] = None):
    """(B, H, L, L) float keep mask in {0, 1}, P(1) = 1 - rate: the JAX
    package's ``dropout_keep_mask`` for every batch·head row."""
    bh = torch.arange(b * h, dtype=torch.int64, device=device).reshape(b, h, 1, 1)
    salt = (seed + bh * 40503) & MASK32
    pos = torch.arange(l * l, dtype=torch.int64, device=device).reshape(1, 1, l, l)
    bits = mix32_fast((pos * GOLDEN + salt * 0x01000193) & MASK32)
    return (bits >= dropout_threshold(rate)).to(torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, bias: tp.Optional[torch.Tensor], scale: float) -> torch.Tensor:
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return s if bias is None else s + bias


def attention_reference(
    q: torch.Tensor,  # (B, H, L, dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],  # (B|1, H|1, L, L) additive, or None
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the forward kernel: (out (B, H, L, dh), lse (B, H, L))."""
    s = _scores(q, k, bias, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if dropout_rate > 0.0:
        b, h, l, _ = q.shape
        p = p * (dropout_keep_mask(seed, b, h, l, dropout_rate, q.device) * (1.0 / (1.0 - dropout_rate)))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out, lse


def attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],
    lse: torch.Tensor,  # (B, H, L) pre-dropout
    delta: torch.Tensor,  # (B, H, L) = sum(dout * out, -1)
    dout: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the backward kernel: (dq, dk, dv), the
    recompute-based math of ``_xla_bwd_math``."""
    p = torch.exp(_scores(q, k, bias, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    p_dropped = p
    if dropout_rate > 0.0:
        b, h, l, _ = q.shape
        scaled_keep = dropout_keep_mask(seed, b, h, l, dropout_rate, q.device) * (1.0 / (1.0 - dropout_rate))
        p_dropped = p * scaled_keep
        dp = dp * scaled_keep
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_dropped, dout)
    return dq, dk, dv


def _keep_scale_bf16(dropout_rate: float) -> torch.Tensor:
    """The dropout keep scale ``1 / (1 - rate)`` rounded to bf16, as the JAX
    route casts ``keep * scale`` to the input dtype."""
    return torch.tensor(1.0 / (1.0 - dropout_rate), dtype=torch.bfloat16)


def attention_bf16_reference(
    q: torch.Tensor,  # (B, H, L, dh) bf16
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],  # f32
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``attn_fwd_bf16``: (out bf16, lse f32), the JAX
    ``_reference_attention`` on bf16 inputs (rectools_tpu/ops/attention.py
    :441-456): scores in f32 rounded to bf16, lse in f32 from them, p rounded
    to bf16, the dropout scale in bf16, out = p·v in f32 rounded to bf16."""
    s = _scores(q.float(), k.float(), bias, scale).to(torch.bfloat16)
    lse = torch.logsumexp(s.float(), dim=-1)
    p = torch.exp(s.float() - lse[..., None]).to(torch.bfloat16)
    if dropout_rate > 0.0:
        b, h, l, _ = q.shape
        keep = dropout_keep_mask(seed, b, h, l, dropout_rate, q.device)
        p = p * (keep * _keep_scale_bf16(dropout_rate).float()).to(torch.bfloat16)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(torch.bfloat16)
    return out, lse


def attention_bwd_bf16_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],
    lse: torch.Tensor,
    delta: torch.Tensor,
    dout: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``attn_bwd_bf16``: bf16 (dq, dk, dv), the JAX
    ``_xla_bwd_math`` on bf16 inputs (rectools_tpu/ops/attention.py:521-545)."""
    s = _scores(q.float(), k.float(), bias, scale).to(torch.bfloat16)
    p = torch.exp(s.float() - lse[..., None]).to(torch.bfloat16)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float()).to(torch.bfloat16)
    p_dropped = p
    if dropout_rate > 0.0:
        b, h, l, _ = q.shape
        keep = dropout_keep_mask(seed, b, h, l, dropout_rate, q.device)
        scaled_keep = (keep * _keep_scale_bf16(dropout_rate).float()).to(torch.bfloat16)
        p_dropped = p * scaled_keep
        dp = dp * scaled_keep
    ds = (p.float() * (dp.float() - delta[..., None])).to(torch.bfloat16).float()
    dq = (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(torch.bfloat16)
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale).to(torch.bfloat16)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_dropped.float(), dout.float()).to(torch.bfloat16)
    return dq, dk, dv


def _bf16_inputs(kernel: str, **tensors: torch.Tensor) -> bool:
    """Whether q, k, v (and dout) are bf16 (a mixed set raises)."""
    return _native.same_dtype(kernel, **tensors) == torch.bfloat16


def _check_shapes(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias) -> tp.Tuple[int, int]:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{kernel}: q, k, v must share one (B, H, L, dh) shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, l, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if bias is None:
        return 0, 0
    if bias.dim() != 4 or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h) or bias.shape[2:] != (l, l):
        raise ValueError(f"{kernel}: bias must be (1|B, 1|H, L, L) = (1|{b}, 1|{h}, {l}, {l}), got {tuple(bias.shape)}")
    if not bias.is_contiguous():
        raise ValueError(f"{kernel}: bias must be contiguous")
    return (bias.stride(0) if bias.shape[0] > 1 else 0), (bias.stride(1) if bias.shape[1] > 1 else 0)


def _blhd_empty(b: int, h: int, l: int, dh: int, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A (B, H, L, dh) view over (B, L, H, dh) memory: the projections' layout."""
    return torch.empty((b, l, h, dh), dtype=dtype, device=device).transpose(1, 2)


def _strides(*tensors: torch.Tensor) -> tp.Tuple[int, ...]:
    return tuple(s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2)))


def _dropout_args(seed: int, dropout_rate: float) -> tp.Tuple[int, int, int, float]:
    """(seed, on, uint32 keep threshold, keep scale) as the kernels take them."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"attention: dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate == 0.0:
        return seed, 0, 0, 1.0
    return seed, 1, dropout_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)


def attention_fwd(
    q: torch.Tensor,  # (B, H, L, dh), any strides with a unit last stride
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """dropout(softmax(q kᵀ · scale + bias)) v and the pre-dropout row
    logsumexp (float32). On CUDA the output is a (B, H, L, dh) view over
    (B, L, H, dh) memory, so ``out.transpose(1, 2)`` is contiguous. bf16 q,
    k, v give a bf16 output (kernel 2's bf16 form)."""
    if _bf16_inputs("attention_fwd", q=q, k=k, v=v):
        return _attention_fwd_bf16(q, k, v, bias, scale, dropout_rate, seed)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale, dropout_rate, seed)
    tensors = {"q": q, "k": k, "v": v} if bias is None else {"q": q, "k": k, "v": v, "bias": bias}
    _native.require_cuda_f32("attention_fwd", **tensors)
    bias_sb, bias_sh = _check_shapes("attention_fwd", q, k, v, bias)
    b, h, l, dh = q.shape
    for t in (q, k, v):
        _native.require_aligned("attention_fwd", t, (0, 1, 2))
    out = _blhd_empty(b, h, l, dh, q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _native.load("attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        status = lib.attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, l, dh, *_strides(q, k, v, out),
            bias_sb, bias_sh, scale, *_dropout_args(seed, dropout_rate), _native.current_stream_ptr(q.device),
        )
    _native.check_launch("attention_fwd", status)
    return out, lse


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],
    lse: torch.Tensor,
    delta: torch.Tensor,
    dout: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_fwd`; on CUDA each is a (B, H, L, dh)
    view over (B, L, H, dh) memory (bf16 for bf16 inputs: kernel 5's bf16 form)."""
    if _bf16_inputs("attention_bwd", q=q, k=k, v=v, dout=dout):
        return _attention_bwd_bf16(q, k, v, bias, lse, delta, dout, scale, dropout_rate, seed)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, dropout_rate, seed)
    tensors = {"q": q, "k": k, "v": v, "lse": lse, "delta": delta, "dout": dout}
    if bias is not None:
        tensors["bias"] = bias
    _native.require_cuda_f32("attention_bwd", **tensors)
    bias_sb, bias_sh = _check_shapes("attention_bwd", q, k, v, bias)
    b, h, l, dh = q.shape
    if dout.shape != q.shape or lse.shape != (b, h, l) or delta.shape != (b, h, l):
        raise ValueError("attention_bwd: dout must match q, and lse and delta must be (B, H, L)")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("attention_bwd: lse and delta must be contiguous")
    for t in (q, k, v, dout):
        _native.require_aligned("attention_bwd", t, (0, 1, 2))
    dq, dk, dv = (_blhd_empty(b, h, l, dh, q.device) for _ in range(3))
    lib = _native.load("attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        status = lib.attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, l, dh, *_strides(q, k, v, dout, dq, dk, dv),
            bias_sb, bias_sh, scale, *_dropout_args(seed, dropout_rate), _native.current_stream_ptr(q.device),
        )
    _native.check_launch("attention_bwd", status)
    return dq, dk, dv


def _attention_fwd_bf16(q, k, v, bias, scale: float, dropout_rate: float, seed: int):
    if q.device.type == "cpu":
        return attention_bf16_reference(q, k, v, bias, scale, dropout_rate, seed)
    _native.require_cuda("attention_fwd_bf16", torch.bfloat16, q=q, k=k, v=v)
    if bias is not None:
        _native.require_cuda("attention_fwd_bf16", torch.float32, bias=bias)
    bias_sb, bias_sh = _check_shapes("attention_fwd_bf16", q, k, v, bias)
    b, h, l, dh = q.shape
    for t in (q, k, v):
        _native.require_aligned("attention_fwd_bf16", t, (0, 1, 2))
    out = _blhd_empty(b, h, l, dh, q.device, torch.bfloat16)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _native.load("attention_bf16", _SIGNATURES_BF16)
    # the (batch, head, row) strides of q, k, v and out, as the entry takes them
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with _native.device_guard(q.device):
        status = lib.attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, l, dh, *strides,
            bias_sb, bias_sh, scale, *_dropout_args(seed, dropout_rate), _native.current_stream_ptr(q.device),
        )
    _native.check_launch("attention_fwd_bf16", status)
    return out, lse


def _attention_bwd_bf16(q, k, v, bias, lse, delta, dout, scale: float, dropout_rate: float, seed: int):
    if q.device.type == "cpu":
        return attention_bwd_bf16_reference(q, k, v, bias, lse, delta, dout, scale, dropout_rate, seed)
    _native.require_cuda("attention_bwd_bf16", torch.bfloat16, q=q, k=k, v=v, dout=dout)
    tensors = {"lse": lse, "delta": delta} if bias is None else {"lse": lse, "delta": delta, "bias": bias}
    _native.require_cuda("attention_bwd_bf16", torch.float32, **tensors)
    bias_sb, bias_sh = _check_shapes("attention_bwd_bf16", q, k, v, bias)
    b, h, l, dh = q.shape
    if dout.shape != q.shape or lse.shape != (b, h, l) or delta.shape != (b, h, l):
        raise ValueError("attention_bwd_bf16: dout must match q, and lse and delta must be (B, H, L)")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("attention_bwd_bf16: lse and delta must be contiguous")
    for t in (q, k, v, dout):
        _native.require_aligned("attention_bwd_bf16", t, (0, 1, 2))
    dq, dk, dv = (_blhd_empty(b, h, l, dh, q.device, torch.bfloat16) for _ in range(3))
    # dq's f32 sums over the key tiles, when there is more than one
    dq_acc = torch.empty((b, h, l, dh), dtype=torch.float32, device=q.device) if l > BF16_TILE else None
    lib = _native.load("attention_bf16", _SIGNATURES_BF16)
    with torch.cuda.device(q.device):
        status = lib.attn_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), b, h, l, dh, *_strides(q, k, v, dout, dq, dk, dv),
            bias_sb, bias_sh, scale, *_dropout_args(seed, dropout_rate), _native.current_stream_ptr(q.device),
        )
    _native.check_launch("attention_bwd_bf16", status)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Kernel 2 forward, kernel 5 backward; the bias is a constant mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, dropout_rate: float, seed: int):  # type: ignore[override]
        out, lse = attention_fwd(q, k, v, bias, scale, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (scale, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):  # type: ignore[override]
        q, k, v, bias, out, lse = ctx.saved_tensors
        scale, dropout_rate, seed = ctx.args
        per16 = 16 // dout.element_size()
        if dout.stride(-1) != 1 or dout.data_ptr() % 16 or any(dout.stride(i) % per16 for i in range(3)):
            dout = dout.transpose(1, 2).contiguous().transpose(1, 2)
        # in f32 for bf16 too (rectools_tpu/ops/attention.py:508); `.float()` leaves f32 as it is
        delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
        dq, dk, dv = attention_bwd(q, k, v, bias, lse, delta, dout, scale, dropout_rate, seed)
        return dq, dk, dv, None, None, None, None


def attention(
    q: torch.Tensor,  # (B, H, L, dh)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],
    scale: float,
    dropout_rate: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Differentiable attention output (B, H, L, dh): the kernels on CUDA,
    the twins on the CPU, the same ``autograd.Function`` on both."""
    if bias is not None and bias.requires_grad:
        raise NotImplementedError(
            "attention: the bias is a constant mask; a learnable bias needs the score-gradient "
            "route of rectools_tpu/ops/attention.py:558-569, which is not ported"
        )
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return attention_fwd(q, k, v, bias, scale, dropout_rate, seed)[0]
    return _Attention.apply(q, k, v, bias, scale, dropout_rate, seed)


def dot_product_attention(
    q: torch.Tensor,  # (B, L, H, dh) — the layout the MHA module produces
    k: torch.Tensor,
    v: torch.Tensor,
    bias: tp.Optional[torch.Tensor],  # (B|1, H|1, L, L) additive, or None
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: tp.Optional[int] = None,
) -> torch.Tensor:
    """Attention entry point for the transformer stack, (B, L, H, dh) in and out
    (rectools_tpu/ops/attention.py:603-641). The transposes are views: the
    kernels read and write this layout through strides."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    seed = 0 if dropout_seed is None else dropout_seed
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, scale, dropout_rate, seed)
    return out.transpose(1, 2)
