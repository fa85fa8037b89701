"""STU (HSTU) attention: hand-written CUDA kernels, their plain PyTorch twins
and the ``torch.autograd.Function`` that joins them.

Port of rectools_tpu/ops/stu_attention.py. HSTU's attention is pointwise:
``out = (SiLU(q kᵀ + bias) / L · allowed · tl_q · tl_k) v``, with no softmax;
masks multiply, so a fully padded row gives zeros. ``bias`` is the relative
bias shared by the heads: a 129-entry table looked up by the log bucket of
each timestamp difference, plus a Toeplitz matrix of 2L − 1 positional
weights. As in the JAX package it is computed outside the kernels (here with
torch ops, :func:`combined_bias`) and streamed in.

Three kernels (``csrc/stu_attention.cu``): the forward (``stu_fwd_f32``; at
attention and hidden dims of 32 or 64 on the tensor cores), the backward
giving dq, dk and dv (``stu_bwd_f32``; at those dims on the tensor cores in
two launches, dq's being ``stu_bwd_dq_f32``), and the gradient of the score
summed over heads (``stu_ds_f32``; on the tensor cores too at those dims,
with 64 x 64 tiles),
from which the two tables get their gradients. A CUDA
tensor launches them at every shape; a CPU tensor takes the plain twins
(:func:`stu_reference`, :func:`stu_bwd_reference`, :func:`stu_ds_reference`).
Nothing else decides. The kernels take the attention
dim of q and k and the hidden dim of v from ``SUPPORTED_HEAD_DIMS``
independently; others raise on CUDA.

Buckets. The JAX package computes ``int32(log(float32(max(|Δt|, 1))) / 0.301)``
in floats, and what comes out depends on who computes the logarithm: at a few
integers next to a bucket boundary (the first is Δt = 309,279 s) jitted JAX,
eager JAX, PyTorch on the CPU and CUDA disagree by one bucket, which moves an
output by a whole table entry. The port therefore buckets in integers: the
smallest Δt of every bucket is computed once on the host
(:func:`bucket_thresholds`) and every device compares integers against that
table. The evaluation the table reproduces is one of the float formula's, not
all of them: the correctly rounded float32 logarithm of ``float32(Δt)``, times
the float32 reciprocal of 0.301 (XLA turns the division into that product).
Jitted JAX on the CPU, whose logarithm is an approximation, gives the same
bucket for every |Δt| up to 11,455,708 s (132 days) and differs by one bucket
at three float32 values beyond: 11,455,709, 51,598,328 (the integers
51,598,326-30) and 94,206,440 (94,206,437-43); eager JAX differs at more.
``tests/test_torch_stu_attention.py`` holds the port to exactly that.

bf16. Under mixed-precision training q, k, v and dout arrive in bf16 and take
the bf16 forms of the three kernels (``csrc/stu_attention_bf16.cu``:
``stu_fwd_bf16``, ``stu_bwd_bf16`` for dk and dv, ``stu_bwd_dq_bf16`` for dq,
``stu_ds_bf16``; launch keys of the same names) at every pair of attention
and hidden dims of ``SUPPORTED_HEAD_DIMS`` (``BF16_HEAD_DIMS``; at 8 the
products over that dim are 8-deep ``mma`` steps). bias, allowed and
timeline stay f32. The forms round where the JAX package's XLA route
(``_stu_reference`` and its autodiff, the route its TPU users train on below
1 GiB of scores) rounds when it runs on bf16 inputs, as XLA on the CPU
evaluates it: the score ``s = q·kᵀ + bias`` summed in f32 and
rounded, the SiLU as ``s · 1 / (1 + exp(−s))`` with each of exp, the sum, the
reciprocal and the product rounded, the quotient by L (by bf16(L)) rounded,
the mask multiplied, ``a·v`` summed in f32 and rounded once; in the backward
``da = dout·vᵀ`` rounded, each step of the SiLU's chain rule rounded except
the last sum, so the score gradient ``ds`` is an f32 sum of two bf16 values,
and dq, dk, dv summed in f32 over the whole row and rounded once. The table
gradients are f32 sums of ds cast to the tables' dtype. The twins
(:func:`stu_bf16_reference`, :func:`stu_bwd_bf16_reference`,
:func:`stu_ds_bf16_reference`) compute exactly that on the bf16 values in f32;
the kernels differ from them only in the order of the f32 sums. JAX's
Pallas route keeps s and a in f32 and sums dk and dv in bf16 a 128-query block
at a time, and its layer off the TPU rounds q·kᵀ before adding the bias: both
are standing divergences (ROADMAP §3).

The table gradients are sums of the head-summed score gradient: by bucket for
the time table, by diagonal for the positional one. Neither uses a float
atomic (``index_add_`` and ``bincount`` would), so the same inputs give the
same bits. On CUDA the score-gradient kernel, which owns every tile of ds,
also sums its tile by bucket and writes one row of partials per block; their
sum over the blocks is the time table's gradient. The plain twin
(:func:`bucket_sums`) keeps that order: per block of the kernel's tile
(:func:`ds_tile`), one masked reduction per reachable bucket, then the sum
over the blocks. The diagonal sums are the autograd adjoint of the
pad/repeat/reshape construction.
"""

import ctypes
import functools
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from . import _native

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, bias, allowed, timeline, out; B, H, L, ad, lh; strides of q, k, v, out; bias and allowed batch strides
    "stu_fwd_f32": (_C,) * 7 + (_I,) * 5 + (_L,) * 12 + (_L, _L, _C),
    # q, k, v, dout, bias, allowed, timeline, dq, dk, dv; dims; strides of q, k, v, dout, dq, dk, dv
    "stu_bwd_f32": (_C,) * 10 + (_I,) * 5 + (_L,) * 21 + (_L, _L, _C),
    # q, k, v, dout, bias, allowed, timeline, dq; dims; strides of q, k, v, dout, dq
    "stu_bwd_dq_f32": (_C,) * 8 + (_I,) * 5 + (_L,) * 15 + (_L, _L, _C),
    # q, k, v, dout, bias, allowed, timeline, ds; dims; strides of q, k, v, dout; bias and allowed batch strides;
    # buckets, bucket partials, their entries and rows
    "stu_ds_f32": (_C,) * 8 + (_I,) * 5 + (_L,) * 12 + (_L, _L) + (_C, _C, _I, _L) + (_C,),
}
_SIGNATURES_BF16 = {
    # q, k, v, bias, allowed, timeline, out; B, H, L, ad, lh; strides of q, k, v, out; bias and allowed batch strides
    "stu_fwd_bf16": (_C,) * 7 + (_I,) * 5 + (_L,) * 12 + (_L, _L, _C),
    # q, k, v, dout, bias, allowed, timeline, dk, dv; dims; strides of q, k, v, dout, dk, dv
    "stu_bwd_bf16": (_C,) * 9 + (_I,) * 5 + (_L,) * 18 + (_L, _L, _C),
    # q, k, v, dout, bias, allowed, timeline, dq; dims; strides of q, k, v, dout, dq
    "stu_bwd_dq_bf16": (_C,) * 8 + (_I,) * 5 + (_L,) * 15 + (_L, _L, _C),
    # as stu_ds_f32
    "stu_ds_bf16": (_C,) * 8 + (_I,) * 5 + (_L,) * 12 + (_L, _L) + (_C, _C, _I, _L) + (_C,),
}
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64)
# the attention and hidden dims of the bf16 forms; every bf16 launch tiles by BWD_TILE x BWD_TILE
BF16_HEAD_DIMS = SUPPORTED_HEAD_DIMS
# The backward on the tensor cores: attention and hidden dims both from TC_HEAD_DIMS, two launches
# (``stu_bwd_f32`` for dk and dv, ``stu_bwd_dq_f32`` for dq) whose blocks own BWD_TILE keys and BWD_TILE
# queries of one (b, h); other dims take the SIMT kernel, one launch, one block per (b, h).
TC_HEAD_DIMS = (32, 64)
BWD_TILE = 64
# The (keys, queries) tile one block of ``stu_ds_f32`` owns: BWD_TILE x BWD_TILE on the tensor cores (the
# backward's dims), these on the SIMT kernel (see :func:`ds_tile`)
DS_TILE_KEYS, DS_TILE_QUERIES = 128, 32
INT32_MAX = 2**31 - 1


# ------------------------------------------------------------------ relative bias


def _float_bucket(n: int, reciprocal: np.float32) -> int:
    return int(np.float32(np.log(np.float64(np.float32(n)))) * reciprocal)


@functools.lru_cache(maxsize=None)
def bucket_thresholds() -> tp.Tuple[int, ...]:
    """``thresholds[j - 1]`` is the smallest |Δt| in bucket j, for every bucket
    an int32 difference can reach (71 of them). Bucket 0 starts at 0."""
    reciprocal = np.float32(1.0) / np.float32(0.301)
    thresholds = []
    for j in range(1, _float_bucket(INT32_MAX, reciprocal) + 1):
        lo, hi = 1, INT32_MAX  # the bucket of lo is below j, that of hi is not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if _float_bucket(mid, reciprocal) >= j:
                hi = mid
            else:
                lo = mid
        thresholds.append(hi)
    return tuple(thresholds)


@functools.lru_cache(maxsize=None)
def _thresholds_on(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # cached: it must also serve calls that record a graph
        return torch.tensor(bucket_thresholds(), dtype=torch.int32, device=device)


def bucket(diff: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Log bucket of int32 timestamp differences, int32 in [0, num_buckets]:
    ``_bucket`` of the JAX package in integer arithmetic (see the module
    docstring)."""
    if diff.dtype != torch.int32:
        raise TypeError(f"bucket: differences must be int32, got {diff.dtype}")
    buckets = torch.bucketize(diff.abs(), _thresholds_on(diff.device), right=True, out_int32=True)
    return buckets.clamp_(max=num_buckets)


def time_buckets(ts: torch.Tensor, l: int, num_buckets: int) -> torch.Tensor:
    """(B, L, L) buckets of ``ts[:, q + 1] - ts[:, k]`` for (B, L + 2) timestamps."""
    ts = ts.to(torch.int32)
    return bucket(ts[:, 1 : l + 1, None] - ts[:, None, :l], num_buckets)


def bucket_sums(
    values: torch.Tensor, buckets: torch.Tensor, n_entries: int, tile: tp.Tuple[int, int]
) -> torch.Tensor:
    """``out[j] = values[buckets == j].sum()`` for (B, L, L) values, the plain
    twin of the bucket sums of ``stu_ds_f32`` in its order: per block of the
    kernel's grid, a (keys, queries) ``tile`` in block order (batch row, key
    tile, query tile), one masked reduction for each bucket an int32
    difference can reach (the others stay 0), then the blocks' partials
    summed. The memory is a few temporaries of ``values``' size."""
    keys, queries = tile
    b, l, _ = values.shape
    n_k, n_q = -(-l // keys), -(-l // queries)
    pad = (0, n_k * keys - l, 0, n_q * queries - l)

    def blocks(x: torch.Tensor) -> torch.Tensor:  # (B * n_k * n_q, queries * keys), block order
        return x.reshape(b, n_q, queries, n_k, keys).permute(0, 3, 1, 2, 4).reshape(b * n_k * n_q, -1)

    vals, bks = blocks(F.pad(values, pad)), blocks(F.pad(buckets, pad, value=-1))
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    n_reachable = min(n_entries, len(bucket_thresholds()) + 1)
    partials = torch.stack([torch.where(bks == j, vals, zero).sum(dim=1) for j in range(n_reachable)], dim=1)
    return F.pad(partials.sum(dim=0), (0, n_entries - n_reachable))


def toeplitz_bias(pos_weights: torch.Tensor, l: int) -> torch.Tensor:
    """(2L − 1,) weights -> (L, L) matrix ``w[k - q + L - 1]`` by the
    pad/repeat/reshape construction, whose autograd adjoint sums each diagonal
    in a fixed order."""
    t = F.pad(pos_weights[: 2 * l - 1].float(), (0, l))
    return t.repeat(l)[:-l].reshape(l, 3 * l - 2)[:, l - 1 : 2 * l - 1]


def combined_bias(
    buckets: tp.Optional[torch.Tensor],  # (B, L, L) int32, or None without the time bias
    time_weights: tp.Optional[torch.Tensor],
    pos_weights: tp.Optional[torch.Tensor],  # None without the positional bias
    l: int,
    device: torch.device,
) -> torch.Tensor:
    """The relative bias the kernels stream: (B, L, L) with the time bias,
    (1, L, L) without it. The lookup is a plain gather."""
    if buckets is not None:
        bias = time_weights.float()[buckets]
        return bias if pos_weights is None else bias + toeplitz_bias(pos_weights, l)[None]
    if pos_weights is not None:
        return toeplitz_bias(pos_weights, l)[None]
    return torch.zeros((1, l, l), dtype=torch.float32, device=device)


# ------------------------------------------------------------------ plain twins


def _mask(timeline: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """(B, 1, L, L) multiplicative mask: allowed · tl_q · tl_k."""
    return (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None]


def stu_reference(
    q: torch.Tensor,  # (B, H, L, ad)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, L, lh)
    bias: torch.Tensor,  # (B|1, L, L)
    allowed: torch.Tensor,  # (B|1, L, L) multiplicative
    timeline: torch.Tensor,  # (B, L) multiplicative
) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel: (B, H, L, lh)."""
    l = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
    a = s * torch.sigmoid(s) / l * _mask(timeline, allowed)
    return torch.einsum("bhqk,bhkd->bhqd", a, v)


def _score_grad(q, k, v, bias, allowed, timeline, dout) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(a, ds), both (B, H, L, L): the math of ``_stu_score_grad_tile``."""
    l = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
    sig = torch.sigmoid(s)
    mask = _mask(timeline, allowed)
    a = (s * sig) * (mask / l)
    da = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = (da * mask / l) * (sig * (1.0 + s * (1.0 - sig)))
    return a, ds


def stu_bwd_reference(q, k, v, bias, allowed, timeline, dout) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the backward kernel: (dq, dk, dv)."""
    a, ds = _score_grad(q, k, v, bias, allowed, timeline, dout)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dv = torch.einsum("bhqk,bhqd->bhkd", a, dout)
    return dq, dk, dv


def stu_ds_reference(
    q, k, v, bias, allowed, timeline, dout, buckets: tp.Optional[torch.Tensor] = None, n_entries: int = 0
) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """Plain PyTorch twin of the score-gradient kernel: ds summed over heads,
    (B, L, L), and, given the (B, L, L) buckets, its sums by bucket, (n_entries,),
    per block of the kernel's tile for these head dims and then over the blocks."""
    ds = _score_grad(q, k, v, bias, allowed, timeline, dout)[1].sum(dim=1)
    if buckets is None:
        return ds, None
    return ds, bucket_sums(ds, buckets, n_entries, ds_tile(q.shape[3], v.shape[3]))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (ties to even), kept as f32."""
    return x.to(torch.bfloat16).float()


def _bf16_length(l: int) -> float:
    """L as the bf16 divisor the JAX route divides by (a Python int meets a bf16
    array there): L itself up to 256, and wherever it has 8 significant bits."""
    return float(torch.tensor(float(l), dtype=torch.bfloat16))


def _bf16_activation(s: torch.Tensor, l: int) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s_b, sig, a0) of f32 scores: s_b = bf16(s), sig = bf16(1 / bf16(1 +
    bf16(exp(−s_b)))), a0 = bf16(bf16(s_b · sig) / bf16(L))."""
    sb = _round_bf16(s)
    sig = _round_bf16(1.0 / _round_bf16(1.0 + _round_bf16(torch.exp(-sb))))
    return sb, sig, _round_bf16(_round_bf16(sb * sig) / _bf16_length(l))


def _scores_f32(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + bias[:, None]


def stu_bf16_reference(q, k, v, bias, allowed, timeline) -> torch.Tensor:
    """Plain PyTorch twin of ``stu_fwd_bf16``: bf16 (B, H, L, lh) from bf16 q,
    k, v and f32 bias, allowed, timeline, rounded as the module docstring says."""
    a0 = _bf16_activation(_scores_f32(q, k, bias), q.shape[2])[2]
    a = _round_bf16(a0 * _mask(timeline, allowed))
    return torch.einsum("bhqk,bhkd->bhqd", a, v.float()).to(torch.bfloat16)


def _score_grad_bf16(q, k, v, bias, allowed, timeline, dout) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(a, ds), both (B, H, L, L) f32: a holds bf16 values, ds the f32 sum of
    the chain rule's two bf16 terms."""
    l = q.shape[2]
    sb, sig, a0 = _bf16_activation(_scores_f32(q, k, bias), l)
    mask = _mask(timeline, allowed)
    a = _round_bf16(a0 * mask)
    da = _round_bf16(torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float()))
    dsi = _round_bf16(_round_bf16(da * mask) / _bf16_length(l))
    dsig = _round_bf16(dsi * sb)
    ds = _round_bf16(dsi * sig) + _round_bf16(dsig * _round_bf16(sig * _round_bf16(1.0 - sig)))
    return a, ds


def stu_bwd_bf16_reference(q, k, v, bias, allowed, timeline, dout) -> tp.Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of ``stu_bwd_bf16`` and ``stu_bwd_dq_bf16``: bf16
    (dq, dk, dv), each an f32 sum over the whole row rounded once."""
    a, ds = _score_grad_bf16(q, k, v, bias, allowed, timeline, dout)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", a, dout.float())
    return dq.to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def stu_ds_bf16_reference(
    q, k, v, bias, allowed, timeline, dout, buckets: tp.Optional[torch.Tensor] = None, n_entries: int = 0
) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """Plain PyTorch twin of ``stu_ds_bf16``: the f32 ds summed over heads,
    (B, L, L), and, given buckets, its sums by bucket per 64 x 64 tile and
    then over the tiles (f32; the caller casts them to the table's dtype)."""
    ds = _score_grad_bf16(q, k, v, bias, allowed, timeline, dout)[1].sum(dim=1)
    if buckets is None:
        return ds, None
    return ds, bucket_sums(ds, buckets, n_entries, (BWD_TILE, BWD_TILE))


# ------------------------------------------------------------------ kernel wrappers


def _check(kernel: str, q, k, v, bias, allowed, timeline, dout=None, dtype=torch.float32) -> tp.Tuple[int, int]:
    """Input checks of the wrappers (q, k, v and dout of ``dtype``, the masks
    f32); returns the batch strides of bias and allowed."""
    tensors = {"q": q, "k": k, "v": v}
    if dout is not None:
        tensors["dout"] = dout
    _native.require_cuda(kernel, dtype, **tensors)
    _native.require_cuda_f32(kernel, bias=bias, allowed=allowed, timeline=timeline)
    if {t.device for t in (bias, allowed, timeline)} != {q.device}:
        raise ValueError(f"{kernel}: all inputs must be on one device")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(
            f"{kernel}: q, k must be (B, H, L, ad) and v (B, H, L, lh), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    b, _, l, ad = q.shape
    lh = v.shape[3]
    if ad not in SUPPORTED_HEAD_DIMS or lh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{kernel}: attention dim {ad} and hidden dim {lh} must be in {SUPPORTED_HEAD_DIMS}")
    if dout is not None and dout.shape != v.shape:
        raise ValueError(f"{kernel}: dout must match v, got {tuple(dout.shape)}")
    for name, t in (("bias", bias), ("allowed", allowed)):
        if t.dim() != 3 or t.shape[0] not in (1, b) or t.shape[1:] != (l, l) or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous (1|{b}, {l}, {l}), got {tuple(t.shape)}")
    if timeline.shape != (b, l) or not timeline.is_contiguous():
        raise ValueError(f"{kernel}: timeline must be contiguous ({b}, {l}), got {tuple(timeline.shape)}")
    for t in (q, k, v) if dout is None else (q, k, v, dout):
        _native.require_aligned(kernel, t, (0, 1, 2))
    return (l * l if bias.shape[0] > 1 else 0), (l * l if allowed.shape[0] > 1 else 0)


def _blhd_empty(b: int, h: int, l: int, d: int, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A (B, H, L, d) view over (B, L, H, d) memory: the layer's layout."""
    return torch.empty((b, l, h, d), dtype=dtype, device=device).transpose(1, 2)


def _bf16_inputs(kernel: str, **tensors: torch.Tensor) -> bool:
    """Whether q, k, v (and dout) are bf16 (a mixed set raises ``TypeError``)."""
    return _native.same_dtype(kernel, **tensors) == torch.bfloat16


def _strides(*tensors: torch.Tensor) -> tp.Tuple[int, ...]:
    return tuple(s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2)))


def stu_fwd(q, k, v, bias, allowed, timeline) -> torch.Tensor:
    """The forward (kernel ``stu_fwd_f32``): on the tensor cores at the head
    dims of :func:`bwd_on_tensor_cores` (launch key ``stu_fwd``), else the SIMT
    kernel (``stu_fwd_simt``). q, k (B, H, L, ad) and v (B, H, L, lh) with any
    strides and a unit last one; on CUDA the output is a (B, H, L, lh) view
    over (B, L, H, lh) memory. bf16 q, k, v take kernel 17's bf16 form
    (``stu_fwd_bf16``, launch key of that name) and give a bf16 output."""
    bf16 = _bf16_inputs("stu_fwd", q=q, k=k, v=v)
    if q.device.type == "cpu":
        return (stu_bf16_reference if bf16 else stu_reference)(q, k, v, bias, allowed, timeline)
    dtype = torch.bfloat16 if bf16 else torch.float32
    bias_sb, allowed_sb = _check("stu_fwd", q, k, v, bias, allowed, timeline, dtype=dtype)
    b, h, l, ad = q.shape
    lh = v.shape[3]
    out = _blhd_empty(b, h, l, lh, q.device, dtype)
    lib = _native.load("stu_attention_bf16", _SIGNATURES_BF16) if bf16 else _native.load("stu_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        status = (lib.stu_fwd_bf16 if bf16 else lib.stu_fwd_f32)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), allowed.data_ptr(), timeline.data_ptr(),
            out.data_ptr(), b, h, l, ad, lh, *_strides(q, k, v, out), bias_sb, allowed_sb,
            _native.current_stream_ptr(q.device),
        )
    _native.check_launch("stu_fwd_bf16" if bf16 else "stu_fwd" if bwd_on_tensor_cores(ad, lh) else "stu_fwd_simt",
                         status)
    return out


def bwd_on_tensor_cores(ad: int, lh: int) -> bool:
    """Whether the backward of attention dim ``ad`` and hidden dim ``lh`` runs
    on the tensor cores (two launches) rather than the SIMT kernel (one); the
    forward and the score-gradient kernel take the tensor cores at the same
    dims."""
    return ad in TC_HEAD_DIMS and lh in TC_HEAD_DIMS


def ds_tile(ad: int, lh: int) -> tp.Tuple[int, int]:
    """(keys, queries) of the tile one block of ``stu_ds_f32`` owns at these
    head dims: 64 x 64 on the tensor cores, 128 x 32 on the SIMT kernel."""
    return (BWD_TILE, BWD_TILE) if bwd_on_tensor_cores(ad, lh) else (DS_TILE_KEYS, DS_TILE_QUERIES)


def stu_bwd(q, k, v, bias, allowed, timeline, dout) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`stu_fwd`: on the tensor cores (see
    :func:`bwd_on_tensor_cores`) kernel ``stu_bwd_f32`` for dk and dv, then
    ``stu_bwd_dq_f32`` for dq (launch keys ``stu_bwd``, ``stu_bwd_dq``), else
    ``stu_bwd_f32`` for all three. On CUDA each is a (B, H, L, d) view over
    (B, L, H, d) memory. bf16 inputs take kernel 18's bf16 form (two launches,
    bf16 gradients)."""
    if _bf16_inputs("stu_bwd", q=q, k=k, v=v, dout=dout):
        return _stu_bwd_bf16(q, k, v, bias, allowed, timeline, dout)
    if q.device.type == "cpu":
        return stu_bwd_reference(q, k, v, bias, allowed, timeline, dout)
    bias_sb, allowed_sb = _check("stu_bwd", q, k, v, bias, allowed, timeline, dout)
    b, h, l, ad = q.shape
    lh = v.shape[3]
    dq, dk = (_blhd_empty(b, h, l, ad, q.device) for _ in range(2))
    dv = _blhd_empty(b, h, l, lh, q.device)
    lib = _native.load("stu_attention", _SIGNATURES)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(), allowed.data_ptr(),
                timeline.data_ptr())
    stream = _native.current_stream_ptr(q.device)
    with torch.cuda.device(q.device):
        status = lib.stu_bwd_f32(
            *pointers, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, l, ad, lh,
            *_strides(q, k, v, dout, dq, dk, dv), bias_sb, allowed_sb, stream,
        )
        _native.check_launch("stu_bwd", status)
        if bwd_on_tensor_cores(ad, lh):
            status = lib.stu_bwd_dq_f32(
                *pointers, dq.data_ptr(), b, h, l, ad, lh, *_strides(q, k, v, dout, dq), bias_sb, allowed_sb, stream
            )
            _native.check_launch("stu_bwd_dq", status)
    return dq, dk, dv


def stu_ds(
    q, k, v, bias, allowed, timeline, dout, buckets: tp.Optional[torch.Tensor] = None, n_entries: int = 0
) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
    """The gradient of the score ``q kᵀ + bias`` summed over heads, (B, L, L)
    (kernel ``stu_ds_f32``, one block per :func:`ds_tile` tile) and, given the
    (B, L, L) int32 time buckets, its sums by bucket, (n_entries,): the
    kernel's per-block partials added up in block order. Without buckets the
    second result is None. bf16 inputs take kernel 19's bf16 form
    (``stu_ds_bf16``, 64 x 64 tiles at every head dim); ds and the sums stay
    f32."""
    bf16 = _bf16_inputs("stu_ds", q=q, k=k, v=v, dout=dout)
    if q.device.type == "cpu":
        reference = stu_ds_bf16_reference if bf16 else stu_ds_reference
        return reference(q, k, v, bias, allowed, timeline, dout, buckets, n_entries)
    kernel = "stu_ds_bf16" if bf16 else "stu_ds"
    bias_sb, allowed_sb = _check(kernel, q, k, v, bias, allowed, timeline, dout,
                                 torch.bfloat16 if bf16 else torch.float32)
    b, h, l, ad = q.shape
    lh = v.shape[3]
    ds = torch.empty((b, l, l), dtype=torch.float32, device=q.device)
    partials, buckets_ptr, partials_ptr, n_partials = None, None, None, 0
    if buckets is not None:
        if (
            buckets.dtype != torch.int32 or buckets.device != q.device or buckets.shape != (b, l, l)
            or not buckets.is_contiguous() or n_entries <= 0
        ):
            raise ValueError(f"{kernel}: buckets must be contiguous int32 ({b}, {l}, {l}) on {q.device}, n_entries > 0")
        keys, queries = (BWD_TILE, BWD_TILE) if bf16 else ds_tile(ad, lh)
        n_partials = b * -(-l // keys) * -(-l // queries)
        partials = torch.empty((n_partials, n_entries), dtype=torch.float32, device=q.device)
        buckets_ptr, partials_ptr = buckets.data_ptr(), partials.data_ptr()
    lib = _native.load("stu_attention_bf16", _SIGNATURES_BF16) if bf16 else _native.load("stu_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        status = (lib.stu_ds_bf16 if bf16 else lib.stu_ds_f32)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(), allowed.data_ptr(),
            timeline.data_ptr(), ds.data_ptr(), b, h, l, ad, lh, *_strides(q, k, v, dout),
            bias_sb, allowed_sb, buckets_ptr, partials_ptr, n_entries, n_partials,
            _native.current_stream_ptr(q.device),
        )
    _native.check_launch(kernel, status)
    return ds, (None if partials is None else partials.sum(dim=0))


def _stu_bwd_bf16(q, k, v, bias, allowed, timeline, dout) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return stu_bwd_bf16_reference(q, k, v, bias, allowed, timeline, dout)
    bias_sb, allowed_sb = _check("stu_bwd_bf16", q, k, v, bias, allowed, timeline, dout, torch.bfloat16)
    b, h, l, ad = q.shape
    lh = v.shape[3]
    dq, dk = (_blhd_empty(b, h, l, ad, q.device, torch.bfloat16) for _ in range(2))
    dv = _blhd_empty(b, h, l, lh, q.device, torch.bfloat16)
    lib = _native.load("stu_attention_bf16", _SIGNATURES_BF16)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(), allowed.data_ptr(),
                timeline.data_ptr())
    stream = _native.current_stream_ptr(q.device)
    with torch.cuda.device(q.device):
        status = lib.stu_bwd_bf16(
            *pointers, dk.data_ptr(), dv.data_ptr(), b, h, l, ad, lh, *_strides(q, k, v, dout, dk, dv),
            bias_sb, allowed_sb, stream,
        )
        _native.check_launch("stu_bwd_bf16", status)
        status = lib.stu_bwd_dq_bf16(
            *pointers, dq.data_ptr(), b, h, l, ad, lh, *_strides(q, k, v, dout, dq), bias_sb, allowed_sb, stream
        )
        _native.check_launch("stu_bwd_dq_bf16", status)
    return dq, dk, dv


# ------------------------------------------------------------------ autograd


class _STUAttention(torch.autograd.Function):
    """Forward kernel, backward kernel and, when a table needs its gradient,
    the score-gradient kernel and the two table reductions."""

    @staticmethod
    def forward(ctx, q, k, v, buckets, timeline, allowed, time_weights, pos_weights):  # type: ignore[override]
        with torch.no_grad():
            bias = combined_bias(buckets, time_weights, pos_weights, q.shape[2], q.device)
        ctx.save_for_backward(q, k, v, buckets, timeline, allowed, time_weights, pos_weights, bias)
        return stu_fwd(q, k, v, bias, allowed, timeline)

    @staticmethod
    def backward(ctx, dout):  # type: ignore[override]
        q, k, v, buckets, timeline, allowed, time_weights, pos_weights, bias = ctx.saved_tensors
        per16 = 16 // dout.element_size()
        if dout.stride(-1) != 1 or dout.data_ptr() % 16 or any(dout.stride(i) % per16 for i in range(3)):
            dout = dout.contiguous()
        dq, dk, dv = stu_bwd(q, k, v, bias, allowed, timeline, dout)
        dtw = dpw = None
        if ctx.needs_input_grad[6] or ctx.needs_input_grad[7]:
            if ctx.needs_input_grad[6]:
                ds, dtw = stu_ds(q, k, v, bias, allowed, timeline, dout, buckets, time_weights.shape[0])
                dtw = dtw.to(time_weights.dtype)
            else:
                ds, _ = stu_ds(q, k, v, bias, allowed, timeline, dout)
            if ctx.needs_input_grad[7]:
                with torch.enable_grad():
                    pw = pos_weights.detach().requires_grad_()
                    (dpw,) = torch.autograd.grad(toeplitz_bias(pw, q.shape[2]), pw, ds.sum(dim=0))
        return dq, dk, dv, None, None, None, dtw, dpw


def stu_attention(
    q: torch.Tensor,  # (B, H, L, ad)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, L, lh)
    buckets: tp.Optional[torch.Tensor],  # (B, L, L) int32 time buckets, with time_weights
    timeline: torch.Tensor,  # (B, L) float 0/1
    allowed: torch.Tensor,  # (B|1, L, L) float multiplicative mask
    time_weights: tp.Optional[torch.Tensor],  # (num_buckets + 1,)
    pos_weights: tp.Optional[torch.Tensor],  # (2L − 1,)
) -> torch.Tensor:
    """Differentiable STU attention (B, H, L, lh): the kernels on CUDA, the
    twins on the CPU, the same ``autograd.Function`` on both. A table that is
    None turns its bias off."""
    if (buckets is None) != (time_weights is None):
        raise ValueError("stu_attention: buckets and time_weights come together")
    return _STUAttention.apply(q, k, v, buckets, timeline, allowed, time_weights, pos_weights)


def stu_dot_product_attention(
    q: torch.Tensor,  # (B, L, H, ad) — the layout the layer's projection produces
    k: torch.Tensor,
    v: torch.Tensor,  # (B, L, H, lh)
    ts: tp.Optional[torch.Tensor],  # (B, L + 2) integer timestamps, the last column repeated
    timeline: torch.Tensor,  # (B, L)
    allowed: torch.Tensor,  # (L, L) or (B|1, L, L) multiplicative mask
    time_weights: tp.Optional[torch.Tensor],
    pos_weights: tp.Optional[torch.Tensor],
    num_buckets: int,
) -> torch.Tensor:
    """STU attention entry point for the layer, (B, L, H, d) in and out. The
    transposes are views: the kernels read and write this layout through
    strides. ``allowed`` may vary by batch row (a key-padding mask)."""
    l = q.shape[1]
    buckets = None
    if time_weights is not None:
        if ts is None:
            raise ValueError("stu_dot_product_attention: the time bias needs timestamps")
        buckets = time_buckets(ts, l, num_buckets)
    if allowed.dim() == 2:
        allowed = allowed[None]
    out = stu_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), buckets, timeline.float().contiguous(),
        allowed.float().contiguous(), time_weights, pos_weights,
    )
    return out.transpose(1, 2)
