"""Streaming logsumexp, its gradients and the softmax-CE gradients:
hand-written CUDA kernels and their plain PyTorch twins.

Port of rectools_tpu/ops/softmax_lse.py, every route the full-catalog softmax
loss and its public ops take:

- :func:`streaming_lse` — ``logsumexp_n(sessions @ itemsᵀ + row_bias)[m]``
  without the (M, N) logits reaching device memory. Without a bias it is
  ``lse_partials_f32`` (kernel 6: per-chunk (max, Σexp) partials combined in
  torch), or ``lse_f32`` (kernel 15: one running max per row) when
  ``USE_PARTIALS_FWD`` is False; ``bounded_shift=True`` takes
  ``lse_shift_f32`` (kernel 16: a fixed per-row shift and two windows, no
  max); with a bias it is ``lse_bias_f32`` (kernel 8: kernel 6's partials
  with the bias added to each logit), whatever ``bounded_shift`` says, as in
  JAX. It is differentiable through one
  ``torch.autograd.Function`` whose backward is the generic VJP of the JAX
  ``_streaming_lse_bwd`` from the saved lse: the single-pass
  ``lse_bwd_fused_f32`` (kernel 9) while its partial sums fit
  ``FUSED_BWD_PARTIALS_BUDGET``, else ``lse_bwd_ds_f32`` + ``lse_bwd_di_f32``
  (kernels 10 and 11). The bias gets no gradient.
- :func:`sharded_streaming_lse` — the item table row-sharded over one axis of
  a process mesh: each rank runs :func:`streaming_lse` on its slice with a
  0 / -1e30 validity bias and the ranks merge their results with one (M,)
  sized all-gather. This is the loss of mesh training.
- :func:`softmax_grads_from_z` — ``ds = P @ items`` and ``di = Pᵀ @ sessions``
  with ``P = exp(sessions @ itemsᵀ − z)``: ``grads_z_fused_f32`` (kernel 12)
  while its partials fit the budget, else ``grads_z_ds_f32`` +
  ``grads_z_di_f32`` (kernels 13 and 14).
- :func:`softmax_ce_grads_from_z` — ``ds = (P − D) @ items`` and
  ``di = (P − D)ᵀ @ sessions`` with ``D = coeff · onehot(y)`` (kernel 7). In
  this order: above the JAX package's partials budget for the loss's tiling
  (:func:`ce_takes_split_route`: catalogs above 81,920 items at 51,200 × 128)
  it is :func:`softmax_grads_from_z` and the label term in plain torch, as
  the JAX fallback does; else, while the fused kernel's partials fit
  ``FUSED_BWD_PARTIALS_BUDGET``, one pass (``ce_fused_f32``, kernels 9 and
  12's grid with the label term in the probability tile); else two kernels
  launched back to back (``ce_ds_f32``, ``ce_di_f32``), each recomputing the
  logits. The single-device CE loss differentiates through it.

The gradient kernels, fused (9, 12 and 7's one pass) and split (7's two
launches, 10, 11, 13, 14), run their products on the tensor cores in 3xTF32
(each f32 operand split into two TF32 halves, about f32 accuracy) for D in
32..128, on SIMT f32 tiles for D = 16 and 256. So do the logits products of
the lse forwards 6, 8, 15 and 16 (kernel 15 in clusters of blocks that share
a session tile and merge their rows' (max, Σexp) through distributed shared
memory: :func:`lse_cluster_plan`; kernel 16 on kernel 6's grid, with plain
sums of the two windows in place of the running max).

bf16 sessions and items (mixed-precision training) take bf16 forms of
kernels 6 to 16 in ``csrc/softmax_lse_bf16.cu``: bf16 tensor-core products
with f32 accumulation, the lse, the gradients and their partials in f32
unless stated, as the JAX kernels do for bf16 inputs.

- kernel 6 ``lse_partials_bf16`` (launch key ``lse_partials_fwd_bf16``) and
  kernel 8 ``lse_bias_bf16`` (``lse_bias_fwd_bf16``: the same kernel with
  the bias added to each f32 logit; a zero bias gives kernel 6's bits);
- kernel 15 ``lse_bf16`` (``lse_fwd_bf16``, ``USE_PARTIALS_FWD = False``):
  the same kernel with one running (max, Σexp) per row, in clusters of
  :func:`lse_cluster_plan` as the f32 form; kernel 16 ``lse_shift_bf16``
  (``lse_shift_fwd_bf16``, ``bounded_shift=True``): the same kernel with
  plain sums of the two shifted windows, from a shift computed on the
  widened towers (rectools_tpu/ops/softmax_lse.py:364-365);
- kernel 7's bf16 forms, in ``csrc/ce_grads_bf16.cu`` (a ds role and a di
  role on ``wgmma``, each keeping its accumulator and its probability tile
  in registers): the one pass ``ce_fused_bf16`` (``ce_grads_fused_bf16``,
  both roles in one launch): the probability operand (P − D) rounded to
  bf16 once before both products, its ds partials per 2,048-row chunk
  stored in bf16 (``BF16_DS_PARTIALS``, counted at 2 bytes by the plan), di
  written whole in f32; above the budget its two launches ``ce_ds_bf16``
  (``ce_grads_ds_bf16``: each 2,048-row step's ds sum rounded to bf16 and
  added to the chunk's f32 partial, the plan's chunks a whole number of
  steps, so that the one pass's arithmetic differs only in the order of f32
  sums) and ``ce_di_bf16`` (``ce_grads_di_bf16``);
- the softmax gradients from z: kernel 12 ``grads_z_fused_bf16`` (kernel 7's
  engine in ``csrc/ce_grads_bf16.cu`` without the label term, both roles in
  one launch: P = exp(logit − z) rounded once, bf16 ds partials per
  2,048-row chunk counted at 2 bytes as JAX's route test counts them, di
  written whole in f32), or above the budget kernels 13 ``grads_z_ds_bf16``
  (ds summed in f32 over every chunk, no bf16 partial) and 14
  ``grads_z_di_bf16`` (the same rounded P). Above
  :func:`ce_takes_split_route`'s bf16 threshold (163,840 items at 51,200 ×
  128) the CE gradients take them and the label term in f32;
- the generic lse backward, kernel 9 ``lse_bwd_fused_bf16``
  (``lse_bwd_fused_bf16``: kernel 7's grid, pw = exp((logit + bias) − lse) ·
  dlse rounded to bf16 once for both products, f32 ds partials: the
  partials budget counts 4 bytes an entry whatever the dtype, as JAX's
  route test does), or above the budget kernels 10 ``lse_bwd_ds_bf16`` (the
  same pw, ds summed in f32) and 11 ``lse_bwd_di_bf16`` (its own rounding
  points: p and s · dlse each rounded to bf16, di = pᵀ (s · dlse) summed in
  f32). ds and di come back in f32; the autograd functions round them to
  bf16, as JAX's VJP does. This is the mesh loss's route.

Their twins (:func:`streaming_lse_bf16_reference`,
:func:`streaming_lse_bias_bf16_reference`,
:func:`softmax_ce_grads_from_z_bf16_reference`,
:func:`softmax_grads_from_z_bf16_reference`,
:func:`streaming_lse_bwd_bf16_reference`) multiply the bf16 values in f32,
which is exact, so twin and card differ only in the order of f32 sums.
They take every width of ``SUPPORTED_D``, on bf16 tiles of their own
(:func:`_bwd_tile`; 64-row session tiles in the gradient kernels at D = 256).
Kernels 15 and 16's twins (:func:`streaming_lse_carried_bf16_reference`,
:func:`lse_shift_sums_bf16_reference`) are their f32 twins on the widened
values in the same way.

CPU tensors take the twins, which walk the catalog in item chunks exactly as
the kernels walk their tiles (per-chunk partials, a running max or fixed
shifts for the lse; label correction and tail handling per chunk for the
gradients; the summation order of the fused or the split backward, whose ds
sums are partials per item chunk of :func:`split_bwd_plan`). Rows
with ``z = +inf`` (PAD targets, ``coeff = 0``) contribute nothing.
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
    # sessions, items, lse; M, N, D; cluster, item rows per rank; stream
    "lse_f32": (_C, _C, _C, _LL, _LL, _I, _I, _LL, _C),
    # sessions, items, max partials, sum partials; M, N, D; chunk rows; stream
    "lse_partials_f32": (_C, _C, _C, _C, _LL, _LL, _I, _LL, _C),
    # sessions, items, shift, window-1 partials, window-2 partials; M, N, D; chunk rows; stream
    "lse_shift_f32": (_C, _C, _C, _C, _C, _LL, _LL, _I, _LL, _C),
    # sessions, items, bias, max partials, sum partials; M, N, D; chunk rows; stream
    "lse_bias_f32": (_C, _C, _C, _C, _C, _LL, _LL, _I, _LL, _C),
    # sessions, items, z, y (int64), coeff, ds partials; M, N, D; chunk rows, chunks; stream
    "ce_ds_f32": (_C,) * 6 + (_LL, _LL, _I, _LL, _LL, _C),
    # sessions, items, z, y (int64), coeff, di; M, N, D; stream
    "ce_di_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    # sessions, items, z, y (int64), coeff, ds partials, di partials; M, N, D; chunk rows, tiles per group,
    # session groups; stream
    "ce_fused_f32": (_C,) * 7 + (_LL, _LL, _I, _LL, _LL, _LL, _C),
    # sessions, items, bias, lse, dlse, ds partials; M, N, D; chunk rows, chunks; stream
    "lse_bwd_ds_f32": (_C,) * 6 + (_LL, _LL, _I, _LL, _LL, _C),
    # sessions, items, bias, lse, dlse, di; M, N, D; stream
    "lse_bwd_di_f32": (_C,) * 6 + (_LL, _LL, _I, _C),
    # sessions, items, bias, lse, dlse, ds partials, di partials; M, N, D; chunk rows, tiles per group, session
    # groups; stream
    "lse_bwd_fused_f32": (_C,) * 7 + (_LL, _LL, _I, _LL, _LL, _LL, _C),
    # sessions, items, z, ds partials; M, N, D; chunk rows, chunks; stream
    "grads_z_ds_f32": (_C,) * 4 + (_LL, _LL, _I, _LL, _LL, _C),
    # sessions, items, z, di; M, N, D; stream
    "grads_z_di_f32": (_C,) * 4 + (_LL, _LL, _I, _C),
    # sessions, items, z, ds partials, di partials; M, N, D; chunk rows, tiles per group, session groups; stream
    "grads_z_fused_f32": (_C,) * 5 + (_LL, _LL, _I, _LL, _LL, _LL, _C),
}
SUPPORTED_D = (16, 32, 64, 128, 256)
TWIN_CHUNK = 2048  # item columns per step of the plain twins
NEG_BIG = -1e30  # bias of an item row that only pads a shard
TILE = 64  # item rows per tile of every kernel, session rows per tile of the SIMT kernels

# The forward without a bias: kernel 6 (per-chunk partials, the JAX default
# `_USE_PARTIALS_FWD = True`) or, set to False, kernel 15 (one running max per
# row). Read at every call.
USE_PARTIALS_FWD = True
LSE_CHUNK = 2048  # item rows a block of kernels 6, 8 and 16 owns (why: csrc/softmax_lse.cu)
# Kernel 15 on the tensor-core tile: a cluster of up to this many blocks
# shares a session tile, each rank walking a contiguous share of the item
# tiles (`lse_cluster_plan`)
LSE_CLUSTER_MAX = 8

# Kernel 16's second window: terms scaled by e^64 inside the exp, which
# carries exact coverage from bound gaps of ~64 to ~128; window 1 is kept
# while its sum is at least e^-20 (rectools_tpu/ops/softmax_lse.py:47, 379-386).
WINDOW2_OFFSET = 64.0
WINDOW1_FLOOR = 2.061e-9

# The fused backward writes its ds partials per item chunk, (n_chunks, M, D),
# and its di partials per group of session tiles, (n_groups, N, D). Above this
# many bytes of partials the backward takes the two split kernels instead: a
# few ds partials that do not grow with the catalog, one more logit pass (the
# JAX package's constant and rule).
FUSED_BWD_PARTIALS_BUDGET = 512 * 1024 * 1024
FUSED_BWD_CHUNK = 2048  # item rows a block of the fused backward owns
# The f32 gradient kernels' tile by feature width: (session rows per tile,
# blocks of the fused kernel per multiprocessor, most item chunks of the split
# ds kernel). D in 32..128 take the tensor-core tile (one block of up to 227 KB
# of shared memory per multiprocessor; the split ds kernel cuts the catalog
# into up to 4 chunks to fill its last wave), 16 and 256 the SIMT tile (two
# fused blocks; the split ds kernel walks the whole catalog). The kernels are
# built for the same rows and reject a grid of other session groups or item
# chunks.
_BWD_TILE = {d: (128, 1, 4) if 32 <= d <= 128 else (TILE, 2, 1) for d in SUPPORTED_D}
# The bf16 gradient kernels' tile (csrc/softmax_lse_bf16.cu ``grad_bm``): one
# block per multiprocessor and up to 4 split ds chunks at every width, 128-row
# session tiles, 64-row ones at D = 256 (where a warp's ds slice of 32 rows
# would take 128 f32 registers a thread).
_BWD_TILE_BF16 = {d: (64 if d > 128 else 128, 1, 4) for d in SUPPORTED_D}


def _bwd_tile(d: int, dtype: torch.dtype = torch.float32) -> tp.Tuple[int, int, int]:
    """The gradient kernels' tile for towers of width ``d`` and ``dtype``: the
    bf16 forms' own or the f32 kernels'."""
    return (_BWD_TILE_BF16 if dtype == torch.bfloat16 else _BWD_TILE)[d]


_SIGNATURES_BF16 = {
    # sessions, items, max partials, sum partials; M, N, D; chunk rows; stream
    "lse_partials_bf16": (_C, _C, _C, _C, _LL, _LL, _I, _LL, _C),
    # sessions, items, bias, max partials, sum partials; M, N, D; chunk rows; stream
    "lse_bias_bf16": (_C, _C, _C, _C, _C, _LL, _LL, _I, _LL, _C),
    # sessions, items, bias, lse, dlse, f32 ds partials, f32 di partials; M, N, D; chunk rows, tiles per group,
    # session groups; stream
    "lse_bwd_fused_bf16": (_C,) * 7 + (_LL, _LL, _I, _LL, _LL, _LL, _C),
    # sessions, items, bias, lse, dlse, f32 ds partials; M, N, D; chunk rows, chunks; stream
    "lse_bwd_ds_bf16": (_C,) * 6 + (_LL, _LL, _I, _LL, _LL, _C),
    # sessions, items, bias, lse, dlse, f32 di; M, N, D; stream
    "lse_bwd_di_bf16": (_C,) * 6 + (_LL, _LL, _I, _C),
    # sessions, items, z, f32 ds partials; M, N, D; chunk rows, chunks; stream
    "grads_z_ds_bf16": (_C,) * 4 + (_LL, _LL, _I, _LL, _LL, _C),
    # sessions, items, z, f32 di; M, N, D; stream
    "grads_z_di_bf16": (_C,) * 4 + (_LL, _LL, _I, _C),
    # sessions, items, f32 shift, f32 window-1 partials, f32 window-2 partials; M, N, D; chunk rows; stream
    "lse_shift_bf16": (_C, _C, _C, _C, _C, _LL, _LL, _I, _LL, _C),
    # sessions, items, f32 lse; M, N, D; cluster, item rows per rank; stream
    "lse_bf16": (_C, _C, _C, _LL, _LL, _I, _I, _LL, _C),
    # kernel (0: 6 / 8 / 15 / 16, 1: the one pass, 2: split ds, 3: split di, 4: 11), D -> bytes of shared memory a
    # block
    "lse_bf16_smem_bytes": (_I, _I),
}
# kernel 7's bf16 forms and kernel 12's (csrc/ce_grads_bf16.cu)
_SIGNATURES_CE_BF16 = {
    # sessions, items, z, y (int64), coeff, ds partials, f32 di; M, N, D; chunk rows, bf16 partials; stream
    "ce_fused_bf16": (_C,) * 7 + (_LL, _LL, _I, _LL, _I, _C),
    # sessions, items, z, ds partials, f32 di; M, N, D; chunk rows, bf16 partials; stream
    "grads_z_fused_bf16": (_C,) * 5 + (_LL, _LL, _I, _LL, _I, _C),
    # sessions, items, z, y (int64), coeff, f32 ds partials; M, N, D; chunk rows, chunks, step rows; stream
    "ce_ds_bf16": (_C,) * 6 + (_LL, _LL, _I, _LL, _LL, _LL, _C),
    # sessions, items, z, y (int64), coeff, f32 di; M, N, D; stream
    "ce_di_bf16": (_C,) * 6 + (_LL, _LL, _I, _C),
    # D -> bytes of shared memory a block
    "ce_grads_bf16_smem_bytes": (_I,),
}
# kernel 7's ds partials in bf16 for bf16 inputs: the JAX package's constant
# and default (rectools_tpu/ops/softmax_lse.py:456-473); False stores them in f32
BF16_DS_PARTIALS = True


def streaming_lse_reference(sessions: torch.Tensor, items: torch.Tensor, chunk: int = TWIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_f32`` (kernel 15): running (max, Σexp) over
    item chunks."""
    m_run = torch.full((sessions.shape[0],), float("-inf"), dtype=torch.float32, device=sessions.device)
    l_run = torch.zeros_like(m_run)
    for start in range(0, items.shape[0], chunk):
        logits = sessions @ items[start : start + chunk].T
        m_new = torch.maximum(m_run, logits.max(dim=1).values)
        l_run = l_run * torch.exp(m_run - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m_run = m_new
    return m_run + torch.log(l_run)


def lse_cluster_plan(n: int) -> tp.Tuple[int, int]:
    """(cluster size, item rows per rank) of kernel 15 on the tensor-core
    tile, a function of the catalog alone (so the bits are the card's on any
    card): up to ``LSE_CLUSTER_MAX`` ranks, each ceil(tiles / ranks) 64-row
    item tiles; a rank past the last tile adds nothing."""
    tiles = max(1, -(-n // TILE))
    cluster = min(LSE_CLUSTER_MAX, tiles)
    return cluster, -(-tiles // cluster) * TILE


def combine_lse_partials(m_part: torch.Tensor, l_part: torch.Tensor) -> torch.Tensor:
    """(M,) lse from (n_chunks, M) per-chunk maxima and Σexp(logit − max):
    the JAX combine (rectools_tpu/ops/softmax_lse.py:411-413)."""
    m_all = m_part.max(dim=0).values
    l_all = (l_part * torch.exp(m_part - m_all[None])).sum(dim=0)
    return m_all + torch.log(l_all)


def streaming_lse_partials_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    chunk: int = LSE_CHUNK,
    row_bias: tp.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_partials_f32`` (kernel 6) and, given
    ``row_bias``, of ``lse_bias_f32`` (kernel 8): each item chunk's (max,
    Σexp) of the logits plus the bias, the max from -1e30 as in the kernels,
    then :func:`combine_lse_partials`."""
    if items.shape[0] == 0:
        return torch.full((sessions.shape[0],), float("-inf"), device=sessions.device)
    m_parts, l_parts = [], []
    for start in range(0, items.shape[0], chunk):
        logits = sessions @ items[start : start + chunk].T
        if row_bias is not None:
            logits = logits + row_bias[start : start + chunk][None, :]
        m_j = logits.max(dim=1).values.clamp(min=NEG_BIG)
        m_parts.append(m_j)
        l_parts.append(torch.exp(logits - m_j[:, None]).sum(dim=1))
    return combine_lse_partials(torch.stack(m_parts), torch.stack(l_parts))


def lse_shift(sessions: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """(M,) per-row upper bound of the logits, ``‖s_m‖ · max_n ‖item_n‖``
    (Cauchy-Schwarz; rectools_tpu/ops/softmax_lse.py:364-365), in f32 from
    the widened towers as JAX computes it (bf16 squares and sums would round
    at other points); a tower in a wider type stays in it."""
    sessions, items = (t.float() if t.dtype == torch.bfloat16 else t for t in (sessions, items))
    if items.shape[0] == 0:
        return torch.zeros((sessions.shape[0],), device=sessions.device)
    item_max_norm = torch.sqrt((items * items).sum(dim=1).max())
    return torch.sqrt((sessions * sessions).sum(dim=1)) * item_max_norm


def select_shift_window(shift: torch.Tensor, l: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Per row: ``shift + log l`` while window 1's sum stays at least e^-20,
    else ``shift − 64 + log l2``; both sums flushed to 0 (a bound gap past
    ~128, outside the contract) give −inf, never NaN."""
    return torch.where(l >= WINDOW1_FLOOR, shift + torch.log(l), (shift - WINDOW2_OFFSET) + torch.log(l2))


def lse_shift_sums_reference(
    sessions: torch.Tensor, items: torch.Tensor, chunk: int = LSE_CHUNK
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``lse_shift_f32`` (kernel 16): (shift, l, l2)
    with l = Σ exp(logit − shift) and l2 = Σ exp(logit − shift + 64), summed
    per item chunk and then over the chunks."""
    shift = lse_shift(sessions, items)
    if items.shape[0] == 0:
        return shift, torch.zeros_like(shift), torch.zeros_like(shift)
    l_parts, l2_parts = [], []
    for start in range(0, items.shape[0], chunk):
        shifted = sessions @ items[start : start + chunk].T - shift[:, None]
        l_parts.append(torch.exp(shifted).sum(dim=1))
        l2_parts.append(torch.exp(shifted + WINDOW2_OFFSET).sum(dim=1))
    return shift, torch.stack(l_parts).sum(dim=0), torch.stack(l2_parts).sum(dim=0)


def streaming_lse_shift_reference(
    sessions: torch.Tensor, items: torch.Tensor, chunk: int = LSE_CHUNK
) -> torch.Tensor:
    """Plain PyTorch twin of the ``bounded_shift`` forward: kernel 16's sums
    and the window selection."""
    return select_shift_window(*lse_shift_sums_reference(sessions, items, chunk))


def lse_shift_sums_bf16_reference(
    sessions: torch.Tensor, items: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``lse_shift_bf16`` (kernel 16 on bf16 towers):
    kernel 16's twin on the widened values (the shift from them too, as JAX's
    ``items.astype(jnp.float32)``), in the kernel's item chunks."""
    return lse_shift_sums_reference(sessions.float(), items.float())


def streaming_lse_carried_bf16_reference(sessions: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_bf16`` (kernel 15 on bf16 towers): kernel
    15's running (max, Σexp) twin on the widened values."""
    return streaming_lse_reference(sessions.float(), items.float())


def streaming_lse_bias_reference(
    sessions: torch.Tensor, items: torch.Tensor, row_bias: torch.Tensor, chunk: int = LSE_CHUNK
) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_bias_f32`` (kernel 8), in its item chunks.
    Each chunk's max starts at -1e30 as in the kernel, so a table whose every
    row is invalid gives ``-1e30 + log(count)`` and never NaN; a zero bias
    gives kernel 6's twin, bit for bit."""
    return streaming_lse_partials_reference(sessions, items, chunk, row_bias)


def split_bwd_plan(
    m: int, n: int, d: int, n_sms: int, step_rows: int = TILE, dtype: torch.dtype = torch.float32
) -> tp.Tuple[int, int]:
    """(item chunks, rows per chunk) of the split ds kernels (7's ``ce_ds_f32``,
    10, 13; ``dtype`` picks the bf16 forms' tile). On the tensor-core tiles a
    block owns (session tile, item chunk), one block per multiprocessor: of 1
    to ``_bwd_tile(d, dtype)[2]`` chunks (no more than the 64-row item tiles)
    the count whose grid fills its last wave best, the fewest on a tie (one
    block per session tile leaves 4 of 400 in the last wave at the training
    width). Each chunk writes a ds partial of M · D floats whatever the
    catalog; the caller sums them in order. The f32 SIMT tile walks the whole
    catalog in one chunk. ``step_rows`` (a multiple of 64) rounds the rows per
    chunk up to a multiple of it: kernel 7's bf16 ds launch rounds each
    2,048-row step, which then starts where a chunk of its one pass starts."""
    tile_rows, blocks_per_sm, max_chunks = _bwd_tile(d, dtype)
    n_tiles = max(1, -(-n // TILE))
    m_tiles = max(1, -(-m // tile_rows))
    wave = blocks_per_sm * n_sms

    def fill(chunks: int) -> float:
        return m_tiles * chunks / (-(-m_tiles * chunks // wave) * wave)

    chunks = max(range(1, min(max_chunks, n_tiles) + 1), key=lambda c: (fill(c), -c))
    tiles_per_chunk = -(-n_tiles // chunks)
    step_tiles = step_rows // TILE
    tiles_per_chunk = -(-tiles_per_chunk // step_tiles) * step_tiles  # whole steps
    return -(-n_tiles // tiles_per_chunk), tiles_per_chunk * TILE


def _grads_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    weights: tp.Callable[[torch.Tensor, int], torch.Tensor],
    chunk: int,
    partials: bool,
    di_terms: tp.Optional[tp.Tuple[tp.Callable[[torch.Tensor, int], torch.Tensor], torch.Tensor]] = None,
    round_steps: bool = False,
    dtype: torch.dtype = torch.float32,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(pw @ items, pwᵀ @ sessions) with ``pw = weights(logits, start)`` per
    step of ``chunk`` item rows. ``partials=True`` sums one ds partial per step
    at the end, as a fused kernel's caller does; ``False`` takes the split ds
    kernel's order: one partial per item chunk of :func:`split_bwd_plan` (at an
    H100's 132 multiprocessors), each a running sum over its steps, summed at
    the end. ``di_terms = (di_weights, rows)`` gives di as
    ``di_weights(logits, start)ᵀ @ rows`` instead (a split di kernel that
    rounds its own operands). ``round_steps`` rounds each step's ds term to
    bf16 before it is added (bf16 ds partials; in the split order the plan's
    chunks then start on a step). ``dtype`` is the towers' dtype before the
    twin widened them: it picks the split plan's tile."""
    m, n = sessions.shape[0], items.shape[0]
    step = chunk if round_steps else TILE
    ds_rows = chunk if partials else split_bwd_plan(m, n, sessions.shape[1], 132, step, dtype)[1]
    di = torch.empty_like(items)
    ds_parts = []
    for lo in range(0, n, ds_rows):
        hi = min(lo + ds_rows, n)
        part = None
        for start in range(lo, hi, chunk):
            block = items[start : min(start + chunk, hi)]
            logits = sessions @ block.T
            pw = weights(logits, start)
            term = pw @ block
            if round_steps:
                term = term.to(torch.bfloat16).float()
            part = term if part is None else part + term
            if di_terms is None:
                di[start : start + block.shape[0]] = pw.T @ sessions
            else:
                di[start : start + block.shape[0]] = di_terms[0](logits, start).T @ di_terms[1]
        ds_parts.append(part)
    if not ds_parts:
        return torch.zeros_like(sessions), di
    return (torch.stack(ds_parts).sum(dim=0) if len(ds_parts) > 1 else ds_parts[0]), di


def streaming_lse_bwd_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    row_bias: torch.Tensor,
    lse: torch.Tensor,
    dlse: torch.Tensor,
    chunk: int = TWIN_CHUNK,
    partials: bool = True,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the lse backward kernels (9, or 10 + 11): (ds, di)
    with ``pw = exp((logits + bias) − lse) · dlse``, ``ds = pw @ items`` and
    ``di = pwᵀ @ sessions``, in the fused (``partials=True``) or split order."""

    def weights(logits: torch.Tensor, start: int) -> torch.Tensor:
        logits = logits + row_bias[start : start + logits.shape[1]][None, :]
        return torch.exp(logits - lse[:, None]) * dlse[:, None]

    return _grads_reference(sessions, items, weights, chunk, partials)


def softmax_grads_from_z_reference(
    sessions: torch.Tensor, items: torch.Tensor, z: torch.Tensor, chunk: int = TWIN_CHUNK, partials: bool = True
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel 12 (``partials=True``: one ds partial per
    chunk, summed at the end) or of kernels 13 + 14 (``False``: a running sum
    per item chunk of the split plan, the chunks summed at the end): (P @
    items, Pᵀ @ sessions) with ``P = exp(logits − z)``."""
    return _grads_reference(sessions, items, lambda logits, start: torch.exp(logits - z[:, None]), chunk, partials)


def softmax_ce_grads_from_z_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    z: torch.Tensor,
    y: torch.Tensor,
    coeff: torch.Tensor,
    chunk: int = TWIN_CHUNK,
    partials: bool = True,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel 7: (ds, di) in the order of
    ``ce_fused_f32`` (``partials=True``: one ds partial per chunk, summed at
    the end) or of ``ce_ds_f32`` + ``ce_di_f32`` (``False``: a running sum per
    item chunk of the split plan, the chunks summed at the end)."""

    def weights(logits: torch.Tensor, start: int) -> torch.Tensor:
        pw = torch.exp(logits - z[:, None])
        cols = torch.arange(start, start + logits.shape[1], device=sessions.device)
        return torch.where(cols[None, :] == y[:, None], pw - coeff[:, None], pw)

    return _grads_reference(sessions, items, weights, chunk, partials)


def streaming_lse_bf16_reference(sessions: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_partials_bf16`` (kernel 6 on bf16 towers):
    kernel 6's twin on the bf16 values in f32. A product of two bf16 values is
    exact in f32, so the logits are the card's up to the order of their sums."""
    return streaming_lse_partials_reference(sessions.float(), items.float())


def streaming_lse_bias_bf16_reference(
    sessions: torch.Tensor, items: torch.Tensor, row_bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin of ``lse_bias_bf16`` (kernel 8 on bf16 towers):
    kernel 8's twin on the bf16 values in f32, the f32 bias added to each f32
    logit (rectools_tpu/ops/softmax_lse.py:116-124). A zero bias gives
    :func:`streaming_lse_bf16_reference`, bit for bit."""
    return streaming_lse_partials_reference(sessions.float(), items.float(), LSE_CHUNK, row_bias)


def streaming_lse_bwd_bf16_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    row_bias: torch.Tensor,
    lse: torch.Tensor,
    dlse: torch.Tensor,
    partials: bool = True,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the lse backward on bf16 towers, (ds, di) in
    f32. ``partials=True``: kernel 9 (``lse_bwd_fused_bf16``,
    rectools_tpu/ops/softmax_lse.py:253-263), pw = exp((logit + bias) − lse)
    · dlse in f32 rounded to bf16 once, one f32 ds partial per item chunk
    summed at the end, di = pwᵀ s in f32. ``False``: kernels 10 + 11, ds from
    the same pw as a running sum per item chunk of :func:`split_bwd_plan`
    (:220-231), di from p = exp((logit + bias) − lse) and s · dlse, each
    rounded to bf16 (:275-287)."""
    s, it = sessions.float(), items.float()

    def probs(logits: torch.Tensor, start: int) -> torch.Tensor:
        return torch.exp((logits + row_bias[start : start + logits.shape[1]][None, :]) - lse[:, None])

    def weights(logits: torch.Tensor, start: int) -> torch.Tensor:
        return (probs(logits, start) * dlse[:, None]).to(torch.bfloat16).float()

    def rounded_probs(logits: torch.Tensor, start: int) -> torch.Tensor:
        return probs(logits, start).to(torch.bfloat16).float()

    di_terms = None if partials else (rounded_probs, (s * dlse[:, None]).to(torch.bfloat16).float())
    return _grads_reference(s, it, weights, FUSED_BWD_CHUNK, partials, di_terms, dtype=torch.bfloat16)


def softmax_ce_grads_from_z_bf16_reference(
    sessions: torch.Tensor,
    items: torch.Tensor,
    z: torch.Tensor,
    y: torch.Tensor,
    coeff: torch.Tensor,
    partials: bool = True,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel 7 on bf16 towers, (ds, di) in f32: per
    2,048-row item step (``FUSED_BWD_CHUNK``) the f32 logits and (P − D) in
    f32, rounded to bf16 once before both products
    (rectools_tpu/ops/softmax_lse.py:672-693); the step's ds term summed in
    f32 and rounded to bf16 under ``BF16_DS_PARTIALS``; di = (P − D)ᵀ s in
    f32. ``partials=True``: the one pass ``ce_fused_bf16``, the steps' ds
    partials summed at the end. ``False``: its two launches ``ce_ds_bf16`` +
    ``ce_di_bf16``, the same rounded steps added to a running sum per item
    chunk of :func:`split_bwd_plan` (its chunks a whole number of steps), the
    chunks summed at the end: the one pass's arithmetic in another order of
    f32 sums."""
    s, it = sessions.float(), items.float()

    def weights(logits: torch.Tensor, start: int) -> torch.Tensor:
        pw = torch.exp(logits - z[:, None])
        cols = torch.arange(start, start + logits.shape[1], device=s.device)
        return torch.where(cols[None, :] == y[:, None], pw - coeff[:, None], pw).to(torch.bfloat16).float()

    return _grads_reference(s, it, weights, FUSED_BWD_CHUNK, partials, round_steps=BF16_DS_PARTIALS,
                            dtype=torch.bfloat16)


def softmax_grads_from_z_bf16_reference(
    sessions: torch.Tensor, items: torch.Tensor, z: torch.Tensor, partials: bool = True
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the softmax gradients from z on bf16 towers,
    (ds, di) in f32, with P = exp(logit − z) in f32 rounded to bf16 once for
    both products. ``partials=True``: kernel 12 (``grads_z_fused_bf16``,
    rectools_tpu/ops/softmax_lse.py:611-640) in the order of kernel 7's bf16
    engine, which runs it: one ds partial per 2,048-row item chunk, stored in
    bf16 under ``BF16_DS_PARTIALS`` (:818-820) and summed in f32 at the end,
    di = Pᵀ s whole in f32 (no partials per group of session rows).
    :func:`softmax_ce_grads_from_z_bf16_reference` with coeff = 0, bit for
    bit. ``False``: kernels 13 + 14 (:757-790), ds summed in f32 over every
    chunk with nothing rounded between them (a running sum per item chunk of
    :func:`split_bwd_plan`), di = Pᵀ s in f32."""
    s, it = sessions.float(), items.float()

    def weights(logits: torch.Tensor, start: int) -> torch.Tensor:
        return torch.exp(logits - z[:, None]).to(torch.bfloat16).float()

    return _grads_reference(s, it, weights, FUSED_BWD_CHUNK, partials, round_steps=partials and BF16_DS_PARTIALS,
                            dtype=torch.bfloat16)


def _bf16_operands(kernel: str, sessions: torch.Tensor, items: torch.Tensor) -> bool:
    """Whether the towers are bf16 (a mixed pair raises). The bf16 forms take
    every width of ``SUPPORTED_D``; ``_check`` refuses another on the card."""
    return _native.same_dtype(kernel, sessions=sessions, items=items) == torch.bfloat16


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


def _launch_chunked_lse(
    kernel: str,
    sessions: torch.Tensor,
    items: torch.Tensor,
    shift: tp.Optional[torch.Tensor] = None,
    row_bias: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 6, kernel 8 (given ``row_bias``) or kernel 16 (given
    ``shift``), their bf16 forms on bf16 towers, on (session tile, item
    chunk) blocks; returns its two f32 (n_chunks, M) partials."""
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    n_chunks = -(-n // LSE_CHUNK)
    part_a = torch.empty((n_chunks, m), dtype=torch.float32, device=sessions.device)
    part_b = torch.empty_like(part_a)
    if sessions.dtype == torch.bfloat16:
        lib, suffix = _native.load("softmax_lse_bf16", _SIGNATURES_BF16), "_bf16"
    else:
        lib, suffix = _native.load("softmax_lse", _SIGNATURES), "_f32"
    stream = _native.current_stream_ptr(sessions.device)
    pointers = (sessions.data_ptr(), items.data_ptr())
    tail = (part_a.data_ptr(), part_b.data_ptr(), m, n, d, LSE_CHUNK, stream)
    with torch.cuda.device(sessions.device):
        if row_bias is not None:
            status = getattr(lib, f"lse_bias{suffix}")(*pointers, row_bias.data_ptr(), *tail)
        elif shift is None:
            status = getattr(lib, f"lse_partials{suffix}")(*pointers, *tail)
        else:
            status = getattr(lib, f"lse_shift{suffix}")(*pointers, shift.data_ptr(), *tail)
    _native.check_launch(kernel, status)
    return part_a, part_b


def lse_shift_sums(
    sessions: torch.Tensor, items: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(shift, l, l2) of the ``bounded_shift`` forward (kernel 16, its bf16
    form on bf16 towers; their twins on the CPU): the per-row f32 shift and
    the two windows' f32 sums."""
    bf16 = _bf16_operands("lse_shift_fwd", sessions, items)
    if sessions.device.type == "cpu":
        return (lse_shift_sums_bf16_reference if bf16 else lse_shift_sums_reference)(sessions, items)
    kernel = "lse_shift_fwd_bf16" if bf16 else "lse_shift_fwd"
    _native.require_cuda(kernel, torch.bfloat16 if bf16 else torch.float32, sessions=sessions, items=items)
    m, n, _ = _check(kernel, sessions, items)
    shift = lse_shift(sessions, items).contiguous()
    if m == 0 or n == 0:
        return shift, torch.zeros_like(shift), torch.zeros_like(shift)
    l_part, l2_part = _launch_chunked_lse(kernel, sessions, items, shift=shift)
    return shift, l_part.sum(dim=0), l2_part.sum(dim=0)  # fixed-order sums over the chunks


def streaming_lse_fwd(
    sessions: torch.Tensor,
    items: torch.Tensor,
    row_bias: tp.Optional[torch.Tensor] = None,
    bounded_shift: bool = False,
) -> torch.Tensor:
    """(M,) float32 lse, no autograd: with a bias kernel 8; without one
    kernel 16 for ``bounded_shift``, else kernel 6 (or 15 when
    ``USE_PARTIALS_FWD`` is False). Kernels 6 and 8 give per-chunk partials
    that :func:`combine_lse_partials` merges. bf16 towers take the bf16 form
    of the same kernel (a bias stays f32)."""
    if row_bias is None and bounded_shift:
        return select_shift_window(*lse_shift_sums(sessions, items))
    bf16 = _bf16_operands("lse_fwd", sessions, items)
    partials = USE_PARTIALS_FWD
    if sessions.device.type == "cpu":
        if row_bias is not None:
            return (streaming_lse_bias_bf16_reference if bf16 else streaming_lse_bias_reference)(
                sessions, items, row_bias)
        if bf16:
            return (streaming_lse_bf16_reference if partials else streaming_lse_carried_bf16_reference)(sessions, items)
        return (streaming_lse_partials_reference if partials else streaming_lse_reference)(sessions, items)
    kernel = "lse_bias_fwd" if row_bias is not None else "lse_partials_fwd" if partials else "lse_fwd"
    kernel += "_bf16" if bf16 else ""
    _native.require_cuda(kernel, torch.bfloat16 if bf16 else torch.float32, sessions=sessions, items=items)
    m, n, d = _check(kernel, sessions, items)
    if row_bias is not None:
        _native.require_cuda_f32(kernel, row_bias=row_bias)
        _check_vectors(kernel, n, "item row", row_bias=row_bias)
    if m == 0 or n == 0:
        return torch.full((m,), float("-inf"), device=sessions.device)
    if row_bias is not None or partials:
        return combine_lse_partials(*_launch_chunked_lse(kernel, sessions, items, row_bias=row_bias))
    lse = torch.empty((m,), dtype=torch.float32, device=sessions.device)
    if bf16:
        lib, entry = _native.load("softmax_lse_bf16", _SIGNATURES_BF16), "lse_bf16"
    else:
        lib, entry = _native.load("softmax_lse", _SIGNATURES), "lse_f32"
    with torch.cuda.device(sessions.device):
        status = getattr(lib, entry)(
            sessions.data_ptr(), items.data_ptr(), lse.data_ptr(), m, n, d, *lse_cluster_plan(n),
            _native.current_stream_ptr(sessions.device),
        )
    _native.check_launch(kernel, status)
    return lse


def fused_bwd_plan(
    m: int, n: int, d: int, n_sms: int, ds_itemsize: int = 4, dtype: torch.dtype = torch.float32
) -> tp.Tuple[int, int, int]:
    """(tiles per session group, n_groups, bytes of partials) of the fused
    backward kernels (7, 9 and 12) on ``dtype`` towers: one block per (item
    chunk, session group), and no more blocks than fit the multiprocessors at
    once, so that all run in one wave (a few blocks over it and the last ones
    run alone: twice the time). The ds partials count ``ds_itemsize`` bytes an
    entry (2 for kernel 7's bf16 partials), the di partials 4."""
    tile_rows, blocks_per_sm, _ = _bwd_tile(d, dtype)
    n_chunks = max(1, -(-n // FUSED_BWD_CHUNK))
    m_tiles = max(1, -(-m // tile_rows))
    tiles_per_group = -(-m_tiles // max(1, blocks_per_sm * n_sms // n_chunks))
    n_groups = -(-m_tiles // tiles_per_group)
    return tiles_per_group, n_groups, (n_chunks * m * ds_itemsize + n_groups * n * 4) * d


def _fused_or_split(
    prefix: str,
    sessions: torch.Tensor,
    items: torch.Tensor,
    row_pointers: tp.Tuple[int, ...],
    key: str = "",
    bf16: bool = False,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(ds, di) in f32 from ``{prefix}_fused_f32`` while its partials fit
    ``FUSED_BWD_PARTIALS_BUDGET``, else from ``{prefix}_ds_f32`` (on the grid
    of :func:`split_bwd_plan`) and ``{prefix}_di_f32``; ``row_pointers`` are
    the kernels' inputs after the sessions and the items. Launch keys:
    ``{key}_fused`` / ``_ds`` / ``_di``, ``key`` defaulting to ``prefix``.
    ``bf16`` takes the bf16 forms (``{prefix}_fused_bf16`` & co. of
    ``softmax_lse_bf16.cu``, launch keys ending in ``_bf16``) on the same
    grids, f32 ds partials. (Kernels 7 and 12 in bf16 take
    :func:`_ce_grads_bf16` and :func:`_grads_z_bf16`.)"""
    key = key or prefix
    suffix = "_bf16" if bf16 else "_f32"
    key_suffix = "_bf16" if bf16 else ""
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    if m == 0 or n == 0:
        return torch.zeros((m, d), device=sessions.device), torch.zeros((n, d), device=sessions.device)
    n_sms = torch.cuda.get_device_properties(sessions.device).multi_processor_count
    tiles_per_group, n_groups, partials_bytes = fused_bwd_plan(m, n, d, n_sms, 4, sessions.dtype)
    lib = _native.load("softmax_lse_bf16", _SIGNATURES_BF16) if bf16 else _native.load("softmax_lse", _SIGNATURES)
    stream = _native.current_stream_ptr(sessions.device)
    args = (sessions.data_ptr(), items.data_ptr(), *row_pointers)
    if partials_bytes <= FUSED_BWD_PARTIALS_BUDGET:
        n_chunks = -(-n // FUSED_BWD_CHUNK)
        ds_part = torch.empty((n_chunks, m, d), dtype=torch.float32, device=sessions.device)
        di_part = torch.empty((n_groups, n, d), dtype=torch.float32, device=sessions.device)
        with torch.cuda.device(sessions.device):
            status = getattr(lib, f"{prefix}_fused{suffix}")(
                *args, ds_part.data_ptr(), di_part.data_ptr(), m, n, d, FUSED_BWD_CHUNK, tiles_per_group, n_groups,
                stream,
            )
        _native.check_launch(f"{key}_fused{key_suffix}", status)
        # fixed-order f32 sums of the partials (rectools_tpu/ops/softmax_lse.py:745, :840)
        ds = ds_part.sum(dim=0) if n_chunks > 1 else ds_part[0]
        di = di_part.sum(dim=0) if n_groups > 1 else di_part[0]
        return ds, di
    n_chunks, chunk_rows = split_bwd_plan(m, n, d, n_sms, TILE, sessions.dtype)
    ds_part = torch.empty((n_chunks, m, d), dtype=torch.float32, device=sessions.device)
    di = torch.empty((n, d), dtype=torch.float32, device=sessions.device)
    with torch.cuda.device(sessions.device):
        status = getattr(lib, f"{prefix}_ds{suffix}")(*args, ds_part.data_ptr(), m, n, d, chunk_rows, n_chunks, stream)
        _native.check_launch(f"{key}_ds{key_suffix}", status)
        status = getattr(lib, f"{prefix}_di{suffix}")(*args, di.data_ptr(), m, n, d, stream)
    _native.check_launch(f"{key}_di{key_suffix}", status)
    return (ds_part.sum(dim=0) if n_chunks > 1 else ds_part[0]), di  # a fixed-order sum of the chunks


def _fused_on_the_card(m: int, n: int, d: int, ds_itemsize: int = 4, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the card would take the fused kernel on ``dtype`` towers, its ds
    partials counted at ``ds_itemsize`` bytes; the CPU twins keep that
    summation order, or the split kernels' (132 = an H100's
    multiprocessors)."""
    return fused_bwd_plan(m, n, d, 132, ds_itemsize, dtype)[2] <= FUSED_BWD_PARTIALS_BUDGET


def streaming_lse_bwd(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    row_bias: tp.Optional[torch.Tensor],  # (N,) or None = all zeros
    lse: torch.Tensor,  # (M,) the forward's result
    dlse: torch.Tensor,  # (M,) cotangent, any sign
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(ds, di) of :func:`streaming_lse` in f32: kernel 9, or kernels 10 + 11
    when the fused kernel's partials would pass ``FUSED_BWD_PARTIALS_BUDGET``;
    bf16 towers take their bf16 forms by the same rule (the partials counted
    at 4 bytes, as the JAX package counts them for either dtype)."""
    bf16 = _bf16_operands("lse_bwd", sessions, items)
    if row_bias is None:
        row_bias = torch.zeros((items.shape[0],), dtype=torch.float32, device=items.device)
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    if sessions.device.type == "cpu":
        twin = streaming_lse_bwd_bf16_reference if bf16 else streaming_lse_bwd_reference
        return twin(sessions, items, row_bias, lse, dlse, partials=_fused_on_the_card(m, n, d, 4, sessions.dtype))
    _native.require_cuda("lse_bwd", torch.bfloat16 if bf16 else torch.float32, sessions=sessions, items=items)
    _native.require_cuda_f32("lse_bwd", row_bias=row_bias, lse=lse, dlse=dlse)
    _check("lse_bwd", sessions, items)
    _check_vectors("lse_bwd", n, "item row", row_bias=row_bias)
    _check_vectors("lse_bwd", m, "session row", lse=lse, dlse=dlse)
    return _fused_or_split(
        "lse_bwd", sessions, items, (row_bias.data_ptr(), lse.data_ptr(), dlse.data_ptr()), bf16=bf16
    )


class _StreamingLSE(torch.autograd.Function):
    """Kernel 6, 15, 16 or 8 forward, kernel 9 (or 10 + 11) backward from the
    saved lse, whichever forward made it (the JAX custom VJP's rule); the bias
    is a constant validity mask and gets no gradient. The gradients come back
    in the towers' dtype (rounded once from f32 for bf16 towers, as JAX's
    ``ds.astype(sessions.dtype)``)."""

    @staticmethod
    def forward(ctx, sessions, items, row_bias, bounded_shift):  # type: ignore[override]
        lse = streaming_lse_fwd(sessions, items, row_bias, bounded_shift)
        ctx.save_for_backward(sessions, items, row_bias, lse)
        return lse

    @staticmethod
    def backward(ctx, dlse):  # type: ignore[override]
        sessions, items, row_bias, lse = ctx.saved_tensors
        ds, di = streaming_lse_bwd(sessions, items, row_bias, lse, dlse.float().contiguous())
        return ds.to(sessions.dtype), di.to(items.dtype), None, None


def streaming_lse(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    row_bias: tp.Optional[torch.Tensor] = None,  # (N,) additive; -1e30 = invalid row
    bounded_shift: bool = False,
) -> torch.Tensor:
    """(M,) ``logsumexp_n(sessions @ itemsᵀ + row_bias)`` in float32,
    differentiable in ``sessions`` and ``items``.

    ``bounded_shift=True`` (no bias) takes the fixed-shift forward (kernel
    16): exact while the Cauchy-Schwarz bound gap (``‖s_m‖ · max ‖item‖``
    minus the row's largest logit) stays under ~120, and −inf beyond ~170
    (both windows flushed); it is meant for callers that control their
    embedding scale. With a bias it is ignored, as in the JAX package."""
    if row_bias is not None and row_bias.requires_grad:
        raise ValueError("streaming_lse: row_bias is a constant validity mask and cannot require a gradient")
    if torch.is_grad_enabled() and (sessions.requires_grad or items.requires_grad):
        return _StreamingLSE.apply(sessions, items, row_bias, bounded_shift)
    return streaming_lse_fwd(sessions, items, row_bias, bounded_shift)


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
        # sum of the shards' parts; each shard owns its rows of di. Both are
        # rounded to the towers' dtype first, so bf16 towers sum ds in bf16,
        # as JAX's transpose of the replicated input does (a no-op for f32)
        ds = collectives.all_reduce_sum(ds.to(sessions.dtype), group)
        di = torch.cat(collectives.all_gather(di_local.to(local_items.dtype), group))[: ctx.n_items]
        return ds, di, None, None


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
    sums parameter gradients over it (in f32, where JAX sums the bf16 tower
    gradient over the data axis in bf16: a standing divergence, ROADMAP.md
    §3)."""
    del data_axis
    _bf16_operands("sharded_lse", sessions, items)  # one dtype
    return _ShardedStreamingLSE.apply(sessions.contiguous(), items.contiguous(), mesh, shard_axis)


def softmax_grads_from_z(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    z: torch.Tensor,  # (M,) f32: lse - log(row cotangent magnitude), +inf = ignore row
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(ds, di) = (P @ items, Pᵀ @ sessions) with ``P = exp(sessions @ itemsᵀ −
    z)``: the nonnegative-cotangent softmax backward
    (rectools_tpu/ops/softmax_lse.py:793-868). A caller whose per-row lse
    cotangent is ``c >= 0`` up to one scalar sign passes ``z = lse − log(c)``
    and applies the sign to the outputs. Kernel 12 while its partials fit
    ``FUSED_BWD_PARTIALS_BUDGET``, else kernels 13 + 14. bf16 towers take
    their bf16 forms by the same rule, kernel 12's ds partials counted at
    their real itemsize (2 bytes under ``BF16_DS_PARTIALS``, as JAX's route
    test counts them: rectools_tpu/ops/softmax_lse.py:818-821); (ds, di) come
    back in f32."""
    bf16 = _bf16_operands("grads_z", sessions, items)
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    if sessions.device.type == "cpu":
        if bf16:
            fused = _fused_on_the_card(m, n, d, _ds_itemsize(torch.bfloat16), torch.bfloat16)
            return softmax_grads_from_z_bf16_reference(sessions, items, z, partials=fused)
        return softmax_grads_from_z_reference(sessions, items, z, partials=_fused_on_the_card(m, n, d))
    if bf16:
        _native.require_cuda("grads_z", torch.bfloat16, sessions=sessions, items=items)
        _native.require_cuda_f32("grads_z", z=z)
    else:
        _native.require_cuda_f32("grads_z", sessions=sessions, items=items, z=z)
    _check("grads_z", sessions, items)
    _check_vectors("grads_z", m, "session row", z=z)
    if bf16:
        return _grads_z_bf16(sessions, items, z)
    return _fused_or_split("grads_z", sessions, items, (z.data_ptr(),))


def _grads_z_bf16(
    sessions: torch.Tensor, items: torch.Tensor, z: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 12's bf16 forms, (ds, di) in f32, by :func:`_fused_or_split`'s
    rule with the ds partials counted at their itemsize (2 bytes under
    ``BF16_DS_PARTIALS``): the one pass ``grads_z_fused_bf16`` (launch key of
    the same name; kernel 7's engine without the label term,
    ``csrc/ce_grads_bf16.cu``) while :func:`fused_bwd_plan`'s partials fit
    ``FUSED_BWD_PARTIALS_BUDGET`` (the plan still counts the di partials of
    the f32 form, which this one does not allocate, as JAX's route test
    counts its own): ds partials per ``FUSED_BWD_CHUNK`` item rows summed here
    in f32 in chunk order, di whole. Else kernels 13 + 14 (through
    :func:`_fused_or_split`). z is read by TMA, which wants it 16-byte aligned
    (a misaligned view is copied)."""
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    dev = sessions.device
    if m == 0 or n == 0:
        return torch.zeros((m, d), device=dev), torch.zeros((n, d), device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if fused_bwd_plan(m, n, d, n_sms, _ds_itemsize(torch.bfloat16), torch.bfloat16)[2] > FUSED_BWD_PARTIALS_BUDGET:
        # the plan at 4 bytes a ds partial is over the budget too: kernels 13 + 14
        return _fused_or_split("grads_z", sessions, items, (z.data_ptr(),), bf16=True)
    z = z if z.data_ptr() % 16 == 0 else z.clone()
    lib = _native.load("ce_grads_bf16", _SIGNATURES_CE_BF16)
    n_chunks = -(-n // FUSED_BWD_CHUNK)
    ds_part = torch.empty((n_chunks, m, d), dtype=torch.bfloat16 if BF16_DS_PARTIALS else torch.float32, device=dev)
    di = torch.empty((n, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.grads_z_fused_bf16(sessions.data_ptr(), items.data_ptr(), z.data_ptr(), ds_part.data_ptr(),
                                        di.data_ptr(), m, n, d, FUSED_BWD_CHUNK, int(BF16_DS_PARTIALS),
                                        _native.current_stream_ptr(dev))
    _native.check_launch("grads_z_fused_bf16", status)
    # a fixed-order f32 sum of the partials (rectools_tpu/ops/softmax_lse.py:840)
    return (ds_part.float().sum(dim=0) if n_chunks > 1 else ds_part[0].float()), di


def _ds_itemsize(dtype: torch.dtype) -> int:
    """Bytes of one ds partial entry of kernel 7 for towers of ``dtype``
    (rectools_tpu/ops/softmax_lse.py:476-479 ``_ds_partials_dtype``)."""
    return 2 if dtype == torch.bfloat16 and BF16_DS_PARTIALS else 4


def ce_takes_split_route(m: int, n: int, d: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the softmax-CE gradients of (M, D) session rows against an
    (N, D) catalog of ``dtype`` leave kernel 7, by the JAX package's rule: the
    loss's tiling for that dtype (rectools_tpu/models/nn/transformers/
    losses.py:25-27, 119-127), capped by its backward (:214-215), then the
    fused kernel's ds partials ``ceil(N / chunk_n) · pad(M, block_m) · D``
    entries at their real itemsize (2 bytes for bf16 partials) against the
    budget (rectools_tpu/ops/softmax_lse.py:720-723). At M = 51,200 and
    D = 128: in f32 (256, 4096) tiles, 26.2 MB a chunk, so catalogs above
    81,920 items take the split route; in bf16 (384, 4096) tiles, 13.2 MB a
    chunk, above 163,840 items."""
    bf16 = dtype == torch.bfloat16
    if d <= 128:
        block_m, chunk_n = (512, 4096) if bf16 else (256, 4096)
    else:
        block_m, chunk_n = (512, 4096) if bf16 else (512, 2048)
    block_m = min(block_m, 384)
    chunk_n = min(chunk_n, max(1024, (4096 * 128 // max(d, 1)) // 1024 * 1024))
    partials_bytes = -(-n // chunk_n) * (-(-m // block_m) * block_m) * d * _ds_itemsize(dtype)
    return partials_bytes > FUSED_BWD_PARTIALS_BUDGET


def softmax_ce_grads_from_z(
    sessions: torch.Tensor,  # (M, D)
    items: torch.Tensor,  # (N, D)
    z: torch.Tensor,  # (M,) f32: lse - log(row cotangent magnitude), +inf = ignore row
    y: torch.Tensor,  # (M,) int label ids; rows with coeff == 0 are ignored
    coeff: torch.Tensor,  # (M,) f32 nonnegative row cotangent magnitude
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(ds, di) = ((P − D) @ items, (P − D)ᵀ @ sessions). Above
    :func:`ce_takes_split_route`'s threshold the JAX very-large-catalog route
    (rectools_tpu/ops/softmax_lse.py:748-754): :func:`softmax_grads_from_z`,
    then ``ds −= coeff · items[y]`` and ``di −= segment-sum(coeff · sessions,
    y)`` outside any kernel. The segment sum is
    ``index_put_(accumulate=True)``, which sorts the labels and adds each
    run in order: the same bits on every run (``index_add_`` would use float
    atomics on the card). Below it kernel 7: one pass (``ce_fused_f32``,
    launch key ``ce_grads_fused``) while its partials fit
    ``FUSED_BWD_PARTIALS_BUDGET``, else two launches (``ce_grads_ds``,
    ``ce_grads_di``). bf16 towers take the bf16 forms by the same routes,
    the threshold and the plan at bf16 itemsizes (launch keys ending in
    ``_bf16``), and get (ds, di) in f32."""
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    bf16 = _bf16_operands("ce_grads", sessions, items)
    dtype = torch.bfloat16 if bf16 else torch.float32
    on_card = sessions.device.type != "cpu"
    if on_card:
        if bf16:
            _native.require_cuda("ce_grads_bf16", dtype, sessions=sessions, items=items)
            _native.require_cuda_f32("ce_grads_bf16", z=z, coeff=coeff)
        else:
            _native.require_cuda_f32("ce_grads", sessions=sessions, items=items, z=z, coeff=coeff)
        _check("ce_grads", sessions, items)
        if z.shape != (m,) or coeff.shape != (m,) or y.shape != (m,):
            raise ValueError(f"ce_grads: z, y and coeff must be ({m},)")
        if y.device != sessions.device or y.dtype.is_floating_point:
            raise ValueError(f"ce_grads: y must be an integer tensor on {sessions.device}")
    y = y.to(torch.int64).contiguous()
    if ce_takes_split_route(m, n, d, dtype):
        return _large_catalog_route(sessions, items, z, y, coeff)
    fused = _fused_on_the_card(m, n, d, _ds_itemsize(dtype), dtype)
    if not on_card and bf16:
        return softmax_ce_grads_from_z_bf16_reference(sessions, items, z, y, coeff, partials=fused)
    if not on_card:
        return softmax_ce_grads_from_z_reference(sessions, items, z, y, coeff, partials=fused)
    z, coeff = z.contiguous(), coeff.contiguous()
    if bf16:
        return _ce_grads_bf16(sessions, items, z, y, coeff)
    return _fused_or_split("ce", sessions, items, (z.data_ptr(), y.data_ptr(), coeff.data_ptr()), key="ce_grads")


def _ce_grads_bf16(
    sessions: torch.Tensor, items: torch.Tensor, z: torch.Tensor, y: torch.Tensor, coeff: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7's bf16 forms (``csrc/ce_grads_bf16.cu``), (ds, di) in f32,
    by :func:`_fused_or_split`'s rule: the one pass ``ce_fused_bf16`` (launch
    key ``ce_grads_fused_bf16``) while :func:`fused_bwd_plan`'s partials fit
    ``FUSED_BWD_PARTIALS_BUDGET``: ds partials per ``FUSED_BWD_CHUNK`` item
    rows (bf16 under ``BF16_DS_PARTIALS``) summed here in f32 in chunk order,
    di whole. Else its two launches ``ce_ds_bf16`` + ``ce_di_bf16`` (keys
    ``ce_grads_ds_bf16`` / ``ce_grads_di_bf16``): f32 ds partials per item
    chunk of :func:`split_bwd_plan`, each 2,048-row step rounded to bf16
    before it is added (under ``BF16_DS_PARTIALS``), as the one pass rounds
    its partials; the chunks summed here in order. z, y (int64) and coeff are
    contiguous; the kernels read them by TMA, which wants them 16-byte
    aligned (a misaligned view is copied)."""
    m, n, d = sessions.shape[0], items.shape[0], sessions.shape[1]
    dev = sessions.device
    if m == 0 or n == 0:
        return torch.zeros((m, d), device=dev), torch.zeros((n, d), device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _native.load("ce_grads_bf16", _SIGNATURES_CE_BF16)
    stream = _native.current_stream_ptr(dev)
    vectors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in (z, y, coeff)]
    args = (sessions.data_ptr(), items.data_ptr(), *(t.data_ptr() for t in vectors))
    di = torch.empty((n, d), dtype=torch.float32, device=dev)
    if fused_bwd_plan(m, n, d, n_sms, _ds_itemsize(torch.bfloat16), torch.bfloat16)[2] <= FUSED_BWD_PARTIALS_BUDGET:
        n_chunks = -(-n // FUSED_BWD_CHUNK)
        ds_part = torch.empty((n_chunks, m, d), dtype=torch.bfloat16 if BF16_DS_PARTIALS else torch.float32,
                              device=dev)
        with torch.cuda.device(dev):
            status = lib.ce_fused_bf16(*args, ds_part.data_ptr(), di.data_ptr(), m, n, d, FUSED_BWD_CHUNK,
                                       int(BF16_DS_PARTIALS), stream)
        _native.check_launch("ce_grads_fused_bf16", status)
        # a fixed-order f32 sum of the partials (rectools_tpu/ops/softmax_lse.py:745)
        return (ds_part.float().sum(dim=0) if n_chunks > 1 else ds_part[0].float()), di
    step_rows = FUSED_BWD_CHUNK if BF16_DS_PARTIALS else 0
    n_chunks, chunk_rows = split_bwd_plan(m, n, d, n_sms, step_rows or TILE, torch.bfloat16)
    ds_part = torch.empty((n_chunks, m, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.ce_ds_bf16(*args, ds_part.data_ptr(), m, n, d, chunk_rows, n_chunks, step_rows, stream)
        _native.check_launch("ce_grads_ds_bf16", status)
        status = lib.ce_di_bf16(*args, di.data_ptr(), m, n, d, stream)
    _native.check_launch("ce_grads_di_bf16", status)
    return (ds_part.sum(dim=0) if n_chunks > 1 else ds_part[0]), di


def _large_catalog_route(
    sessions: torch.Tensor, items: torch.Tensor, z: torch.Tensor, y: torch.Tensor, coeff: torch.Tensor
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The JAX very-large-catalog route (rectools_tpu/ops/softmax_lse.py
    :748-754): :func:`softmax_grads_from_z`, then the label term in f32
    whatever the towers' dtype, ``ds −= coeff · items[y]`` and ``di −=
    segment-sum(coeff · sessions, y)`` (a sorted, in-order ``index_put_``)."""
    ds, di = softmax_grads_from_z(sessions, items, z)
    coeff_col = coeff[:, None]
    labels = torch.zeros(di.shape, dtype=torch.float32, device=di.device)
    labels.index_put_((y,), coeff_col * sessions.float(), accumulate=True)
    return ds - coeff_col * items[y].float(), di - labels
