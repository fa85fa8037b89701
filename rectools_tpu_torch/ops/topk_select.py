"""Grouped exact top-k: one pass over wide score rows, then a narrow merge.

Port of rectools_tpu/ops/topk_select.py.

1. **Stage 1, kernel** (:func:`group_topm`): view each row as G groups of 128
   columns and reduce each group to its top-``m`` values and lane ids, ties
   toward the lowest lane (``csrc/topk_select.cu`` on CUDA,
   :func:`group_topm_reference` on the CPU).
2. **Stage 2**: the top k of the (B, G·m) candidates by a stable descending
   ``torch.sort``. ``torch.topk`` is not used: on CUDA it does not promise
   lowest-index-first among ties, and ``lax.top_k`` does.
3. **Certificate**: a group can hide an element of the top k only if its m-th
   kept value still ties or beats the provisional k-th value. Then the batch is
   suspect and the exact fallback (a full stable sort) recomputes it.

:func:`grouped_top_k_candidates` returns the fast result and the suspect flag
as device tensors, so a serving loop can dispatch every batch before it reads
any flag (ops/topk.py); :func:`grouped_exact_top_k` reads the flag at once.
"""

import ctypes
import typing as tp

import torch
import torch.nn.functional as F

from . import _native

GROUP_W = 128
DEFAULT_M = 12
_C = ctypes.c_void_p
_SIGNATURES = {
    "group_topm_f32": (_C, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _C, _C, _C),
}

TopK = tp.Tuple[torch.Tensor, torch.Tensor]


def group_topm_reference(scores: torch.Tensor, m: int) -> TopK:
    """Plain PyTorch twin: (B, G·128) -> values (B, G, m) f32, lane ids (B, G, m) int32.

    m rounds of (max, first maximal lane, mask to -inf), as the TPU kernel does;
    an all -inf group yields lane 0 every round.
    """
    b, n = scores.shape
    g = n // GROUP_W
    cur = scores.reshape(b * g, GROUP_W).to(torch.float32, copy=True)
    vals = torch.empty((b * g, m), dtype=torch.float32, device=scores.device)
    lanes = torch.empty((b * g, m), dtype=torch.int64, device=scores.device)
    for j in range(m):
        mx = cur.max(dim=1, keepdim=True).values
        lane = (cur == mx).to(torch.uint8).argmax(dim=1)  # first maximal lane
        vals[:, j] = mx[:, 0]
        lanes[:, j] = lane
        cur.scatter_(1, lane[:, None], float("-inf"))
    return vals.reshape(b, g, m), lanes.to(torch.int32).reshape(b, g, m)


def group_topm(scores: torch.Tensor, m: int) -> TopK:
    """Per 128-column group of each row: the top-m values and lane ids.

    ``scores`` is (B, G·128) float32 with a unit column stride; on CUDA its row
    stride may exceed G·128 (a view into a wider buffer) but must be a multiple
    of 4. Returns values (B, G, m) f32 and lane ids (B, G, m) int32.
    """
    if scores.device.type == "cpu":
        return group_topm_reference(scores, m)
    _native.require_cuda_f32("group_topm", scores=scores)
    if scores.dim() != 2 or scores.shape[1] % GROUP_W:
        raise ValueError(f"group_topm: scores must be (B, G*{GROUP_W}), got {tuple(scores.shape)}")
    if not 1 <= m <= GROUP_W:
        raise ValueError(f"group_topm: m must be in [1, {GROUP_W}], got {m}")
    _native.require_aligned("group_topm", scores, (0,))
    b, n = scores.shape
    g = n // GROUP_W
    vals = torch.empty((b, g, m), dtype=torch.float32, device=scores.device)
    lanes = torch.empty((b, g, m), dtype=torch.int32, device=scores.device)
    lib = _native.load("topk_select", _SIGNATURES)
    with torch.cuda.device(scores.device):
        status = lib.group_topm_f32(
            scores.data_ptr(), b, g, scores.stride(0), m, vals.data_ptr(), lanes.data_ptr(),
            _native.current_stream_ptr(scores.device),
        )
    _native.check_launch("group_topm", status)
    return vals, lanes


def pick_m(n_pad: int, k: int) -> int:
    """Candidates per group: enough that G·m >= k, and at least DEFAULT_M so the
    certificate almost never fires on un-clustered scores
    (rectools_tpu/ops/topk_select.py:106-113)."""
    return max(DEFAULT_M, -(-k // (n_pad // GROUP_W)))


def sorted_top_k(scores: torch.Tensor, k: int) -> TopK:
    """Exact top k by a full stable descending sort: values f32, indices int64,
    ties lowest index first (``lax.top_k`` order). The certificate's fallback."""
    vals, idx = torch.sort(scores.to(torch.float32), dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].contiguous()


def grouped_top_k_candidates(scores: torch.Tensor, k: int) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fast path without a host sync: (values (B, k) f32, indices (B, k) int64,
    suspect () bool). The values and indices are exact unless ``suspect``."""
    b, n = scores.shape
    n_pad = -(-n // GROUP_W) * GROUP_W
    g = n_pad // GROUP_W
    m = pick_m(n_pad, k)
    if m > GROUP_W or k > n:
        raise ValueError(f"k={k} too large for grouped top-k over {n} columns")
    padded = scores if scores.dtype == torch.float32 else scores.to(torch.float32)
    if n_pad != n:
        padded = F.pad(padded, (0, n_pad - n), value=float("-inf"))
    gv, gl = group_topm(padded, m)  # (B, G, m)
    group_base = torch.arange(g, dtype=torch.int64, device=scores.device)[None, :, None] * GROUP_W
    cand_idx = (gl.to(torch.int64) + group_base).reshape(b, g * m)
    cand_vals = gv.reshape(b, g * m)
    sorted_vals, pos = torch.sort(cand_vals, dim=1, descending=True, stable=True)
    top_vals = sorted_vals[:, :k].contiguous()
    top_idx = cand_idx.gather(1, pos[:, :k])
    kth = top_vals[:, k - 1 : k]
    group_floor = gv[:, :, m - 1]
    suspect = (group_floor >= kth).any()
    return top_vals, top_idx, suspect


def grouped_exact_top_k(
    scores: torch.Tensor,  # (B, N)
    k: int,
    fallback: tp.Optional[tp.Callable[[torch.Tensor, int], TopK]] = None,
) -> TopK:
    """Exact top k of each row (values f32, indices int64), lowest index first
    among ties on the fast path. Reads the certificate on the host at once;
    ``fallback(scores, k)`` (default :func:`sorted_top_k`) serves a suspect
    batch and is cast to the fast path's dtypes."""
    top_vals, top_idx, suspect = grouped_top_k_candidates(scores, k)
    if bool(suspect):
        fv, fi = (fallback or sorted_top_k)(scores, k)
        return fv.to(torch.float32), fi.to(torch.int64)
    return top_vals, top_idx
