"""Grouped exact top-k: one pass over wide score rows, then a narrow merge.

Port of rectools_tpu/ops/topk_select.py.

1. **Stage 1, kernel** (:func:`group_topm`): view each row as G groups of 128
   columns and reduce each group to its top-``m`` values and lane ids, ties
   toward the lowest lane (``csrc/topk_select.cu`` on CUDA,
   :func:`group_topm_reference` on the CPU). On CUDA ``m <= SELECT_MAX_M``
   takes the thread-per-group kernel (launch key ``group_topm``), a larger m
   the sorting kernel (``group_topm_warp``: eight lanes a group sort its 128
   (value, lane) pairs by a bitonic network and store the first m).
2. **Stage 2**: the top k of the (B, G·m) candidates by a stable descending
   ``torch.sort``. ``torch.topk`` is not used: on CUDA it does not promise
   lowest-index-first among ties, and ``lax.top_k`` does.
3. **Certificate**: a group can hide an element of the top k only if its m-th
   kept element comes before the provisional k-th in that order (a greater
   value, or an equal value at a lower index; a tie at -inf always counts,
   since the kernel reports lane 0 for such slots). Then the batch is suspect
   and the exact fallback (a full stable sort) recomputes it. With ``m >= k``
   and a finite k-th no group can: its m kept would be k or more elements
   ahead of the k-th.

:func:`grouped_top_k_candidates` returns the fast result and the suspect flag
as device tensors, so a serving loop can dispatch every batch before it reads
any flag (ops/topk.py); :func:`grouped_exact_top_k` reads the flag at once.
"""

import collections
import ctypes
import typing as tp

import torch
import torch.nn.functional as F

from . import _native

GROUP_W = 128
DEFAULT_M = 12
SELECT_MAX_M = 16  # the largest m of the thread-per-group kernel (``kSelectMaxM`` in csrc/topk_select.cu)
_C = ctypes.c_void_p
_SIGNATURES = {
    "group_topm_f32": (_C, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _C, _C, _C),
}

TopK = tp.Tuple[torch.Tensor, torch.Tensor]

# Batches whose certificate failed and that the exact sort served, by caller
# ("exact_top_k", "rank_topk", "query_batch", "random_rank_topk");
# chip_smoke.py reads them.
FALLBACKS: tp.Counter[str] = collections.Counter()


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
    _native.require_cuda_f32("group_topm", forward_only=True, scores=scores)
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
    _native.check_launch("group_topm" if m <= SELECT_MAX_M else "group_topm_warp", status)
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


def grouped_top_k_candidates(
    scores: torch.Tensor, k: int, m: tp.Optional[int] = None
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fast path without a host sync: (values (B, k) f32, indices (B, k) int64,
    suspect () bool). The values and indices are exact unless ``suspect``.
    ``m`` candidates a group (default :func:`pick_m`); ``m >= k`` is never
    suspect while the k-th value is finite."""
    b, n = scores.shape
    n_pad = -(-n // GROUP_W) * GROUP_W
    g = n_pad // GROUP_W
    m = pick_m(n_pad, k) if m is None else m
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
    kth_val, kth_idx = top_vals[:, k - 1 : k], top_idx[:, k - 1 : k]
    floor_val, floor_idx = gv[:, :, m - 1], cand_idx.reshape(b, g, m)[:, :, m - 1]
    # a -inf slot's lane is not its element's (the kernel gives lane 0), so a tie there is suspect
    tie_ahead = (floor_idx < kth_idx) | torch.isneginf(floor_val)
    suspect = ((floor_val > kth_val) | ((floor_val == kth_val) & tie_ahead)).any()
    return top_vals, top_idx, suspect


def grouped_exact_top_k(
    scores: torch.Tensor,  # (B, N)
    k: int,
    fallback: tp.Optional[tp.Callable[[torch.Tensor, int], TopK]] = None,
    m: tp.Optional[int] = None,
) -> TopK:
    """Exact top k of each row (values f32, indices int64), lowest index first
    among ties on the fast path. Reads the certificate on the host at once;
    ``fallback(scores, k)`` (default :func:`sorted_top_k`) serves a suspect
    batch and is cast to the fast path's dtypes."""
    top_vals, top_idx, suspect = grouped_top_k_candidates(scores, k, m)
    if bool(suspect):
        FALLBACKS["exact_top_k"] += 1
        fv, fi = (fallback or sorted_top_k)(scores, k)
        return fv.to(torch.float32), fi.to(torch.int64)
    return top_vals, top_idx
