"""Batched exact top-k MIPS — the serving engine.

Port of rectools_tpu/ops/topk.py (exact, one-shot scoring):

  scores = subjects @ objects.T      (torch.matmul in full f32, TF32 off)
  scores[seen pairs] = finfo.min     (scatter of padded per-row seen lists)
  top k over objects                 (grouped selection, ops/topk_select.py)

Distance semantics follow the JAX engine: DOT ranks and reports the dot;
COSINE ranks by the dot against L2-normalised objects and reports it divided
by the subject norm; EUCLIDEAN ranks by ``2·dot − |o|²`` and reports the
distance, ascending.

The object table is padded to at least one spare column past the catalog
(a multiple of 128 wide); that column is masked like every padded one, so it
serves as the fill index of the seen lists: torch ``scatter_`` raises on the
out-of-range fill that JAX's ``mode="drop"`` discards.

:class:`TopKEngine` holds the object table on the device and scores subject
batches against it: ``query_batch_async`` dispatches one batch and returns
device tensors; ``query_batch`` (the API of the ANN tools, tools/ann.py)
splits the rows into ``batch_size`` batches and returns numpy arrays.
:func:`rank_topk` serves a model's recommend through the same loop
(:func:`_serve_batches`): it dispatches every batch first and brings the
results to the host once; the grouped selection's certificate flags come
back with them, and only a suspect batch (one where a group may hide an
element of the top k: adversarial layouts, or k above m on a catalog whose
best items share groups) is recomputed by the exact sort and counted in
``topk_select.FALLBACKS`` under its caller's key.

Scores are never chunked over objects: a batch's score block is
``batch_size`` × N_pad × 4 bytes (260 MB at 4,096 rows and 15,872 columns).
Rows are scored independently, so splitting rows gives the same result as
the JAX engine's one-shot scoring and its object-chunked scorer above 1 GiB.
The JAX engine's ``use_bfloat16`` storage and its chunked scorer are not
ported. ``approximate=True`` takes the same exact route: off the TPU
``jax.lax.approx_max_k`` is exact too, so the port returns what JAX returns
on the CPU and meets every ``recall_target``.
"""

import math
import typing as tp
from enum import Enum

import numpy as np
import torch
from scipy import sparse

from .. import native as _native
from ..utils.device import DeviceLike, full_f32_matmul, host_to_device, resolve_device
from .topk_select import FALLBACKS, grouped_exact_top_k, grouped_top_k_candidates, sorted_top_k


class Distance(Enum):
    """Distance metrics for ranking (reference rank/rank.py:25)."""

    DOT = 1
    COSINE = 2
    EUCLIDEAN = 3


NEG_INF = float(np.finfo(np.float32).min)

Handles = tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, tp.Optional[torch.Tensor]]


def exact_top_k(scores: torch.Tensor, k: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Exact top k of each row: values f32, indices int64, lowest index first
    among ties (the grouped selector, falling back to a full sort)."""
    return grouped_exact_top_k(scores, k)


def _score_mask_topk(
    subjects: torch.Tensor,  # (B, D) f32
    objects_t: torch.Tensor,  # (D, N_pad) f32 (COSINE: pre-normalised)
    seen_idx: torch.Tensor,  # (B, S) int64, fill = n_valid_objects
    obj_norm_sq: torch.Tensor,  # (N_pad,) f32
    n_valid_objects: int,  # objects >= this are padding
    k: int,
    mode: Distance,
    exact: bool = False,
) -> Handles:
    """(top_idx (B, k) int64, report_scores (B, k) f32, valid (B, k) bool,
    suspect () bool or None). ``exact=True`` skips the grouped selector."""
    with full_f32_matmul():
        dots = torch.matmul(subjects, objects_t)  # (B, N_pad)
    rank_scores = 2.0 * dots - obj_norm_sq[None, :] if mode == Distance.EUCLIDEAN else dots
    rank_scores[:, n_valid_objects:] = NEG_INF
    rank_scores.scatter_(1, seen_idx, NEG_INF)
    if exact:
        top_scores, top_idx = sorted_top_k(rank_scores, k)
        suspect = None
    else:
        top_scores, top_idx, suspect = grouped_top_k_candidates(rank_scores, k)
    valid = top_scores > (NEG_INF / 2)

    if mode == Distance.COSINE:
        sub_norm = torch.linalg.vector_norm(subjects, dim=1, keepdim=True)
        report = torch.where(sub_norm > 0, top_scores / sub_norm, top_scores)
    elif mode == Distance.EUCLIDEAN:
        sub_norm_sq = (subjects * subjects).sum(dim=1, keepdim=True)
        report = torch.sqrt(torch.clamp(sub_norm_sq - top_scores, min=0.0))
    else:
        report = top_scores
    return top_idx, report, valid, suspect


class TopKEngine:
    """Device-resident object table + batched subject scoring.

    ``batch_size``, ``approximate`` and ``recall_target`` are the JAX
    engine's; ``approximate=True`` is served exactly (see the module
    docstring), and both are kept for the callers that read them back.
    """

    def __init__(
        self,
        objects: tp.Union[np.ndarray, torch.Tensor],  # (N, D)
        distance: Distance = Distance.DOT,
        batch_size: int = 4096,
        approximate: bool = False,
        recall_target: float = 0.95,
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.distance = distance
        self.batch_size = batch_size
        self.approximate = approximate
        self.recall_target = recall_target
        obj = torch.as_tensor(objects, dtype=torch.float32, device=self.device)
        self.n_objects, self.dim = obj.shape
        if distance == Distance.COSINE:
            # zero-norm rows stay zero, tiny nonzero norms divide exactly
            norms = torch.linalg.vector_norm(obj, dim=1, keepdim=True)
            obj = obj / torch.where(norms == 0, torch.ones_like(norms), norms)
        n_pad = int(math.ceil((self.n_objects + 1) / 128)) * 128
        objects_t = torch.zeros((self.dim, n_pad), dtype=torch.float32, device=self.device)
        objects_t[:, : self.n_objects] = obj.T
        self._objects_t = objects_t
        self._obj_norm_sq = (objects_t * objects_t).sum(dim=0)
        self.fill = self.n_objects  # first padded column: masked, a valid scatter index

    def query_batch_async(
        self,
        subjects: tp.Union[np.ndarray, torch.Tensor],  # (B, D)
        k: int,
        seen_idx: tp.Optional[np.ndarray] = None,  # (B, S), entries `fill` are padding
        exact: bool = False,
    ) -> Handles:
        """Dispatch one query batch; returns device tensors without a host sync."""
        if isinstance(subjects, torch.Tensor):
            sub = subjects.to(device=self.device, dtype=torch.float32)
        else:
            sub = host_to_device(np.asarray(subjects, dtype=np.float32), self.device)
        if seen_idx is None or seen_idx.shape[1] == 0:
            seen_idx = np.full((sub.shape[0], 1), self.fill, dtype=np.int64)
        seen = host_to_device(np.asarray(seen_idx, dtype=np.int64), self.device)
        return _score_mask_topk(
            sub, self._objects_t, seen, self._obj_norm_sq, self.n_objects, min(k, self.n_objects),
            self.distance, exact,
        )

    def query_batch(
        self,
        subjects: tp.Union[np.ndarray, torch.Tensor],  # (B, D)
        k: int,
        seen_idx: tp.Optional[np.ndarray] = None,  # (B, S), entries >= n_objects are padding
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-min(k, n_objects) of every row: numpy (idx (B, k) int32, report
        scores (B, k) f32, valid (B, k) bool), JAX ``query_batch``'s contract.
        Rows go in ``batch_size`` batches, all dispatched before one fetch; a
        batch whose certificate failed is sorted again and counted in
        ``FALLBACKS["query_batch"]``."""
        k_eff = min(k, self.n_objects)
        b = subjects.shape[0]
        if b == 0:
            return np.zeros((0, k_eff), np.int32), np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), bool)
        if seen_idx is not None:
            seen_idx = np.asarray(seen_idx, dtype=np.int64)
            seen_idx = np.where(seen_idx >= self.n_objects, self.fill, seen_idx)

        def batches() -> tp.Iterator[tp.Tuple[tp.Any, tp.Optional[np.ndarray]]]:
            for start in range(0, b, self.batch_size):
                rows = slice(start, start + self.batch_size)
                yield subjects[rows], None if seen_idx is None else seen_idx[rows]

        idx, scores, valid = _serve_batches(self, batches(), k, "query_batch")
        return idx.astype(np.int32), scores, valid


def _serve_batches(
    engine: TopKEngine,
    batches: tp.Iterable[tp.Tuple[tp.Any, tp.Optional[np.ndarray]]],
    k: int,
    caller: str,
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The serving loop: dispatch every (subjects, seen) batch (kernel
    launches queue on the stream while the host prepares the next batch),
    bring all results to the host in one fetch, then sort again each batch
    whose certificate failed, counted in ``FALLBACKS[caller]``. Returns the
    batches' rows stacked: idx int64, report scores f32, valid bool."""
    pending: tp.List[tp.Tuple[tp.Any, tp.Optional[np.ndarray], Handles]] = []
    for sub_block, seen in batches:
        pending.append((sub_block, seen, engine.query_batch_async(sub_block, k, seen)))
    idx_all, scores_all, valid_all, suspect = _fetch([p[2] for p in pending])
    offsets = np.concatenate(([0], np.cumsum([len(p[2][0]) for p in pending])))
    FALLBACKS[caller] += int(suspect.sum())
    for bi in np.flatnonzero(suspect):
        sub_block, seen, _ = pending[bi]
        idx_b, scores_b, valid_b, _ = _fetch([engine.query_batch_async(sub_block, k, seen, exact=True)])
        lo, hi = offsets[bi], offsets[bi + 1]
        idx_all[lo:hi], scores_all[lo:hi], valid_all[lo:hi] = idx_b, scores_b, valid_b
    return idx_all, scores_all, valid_all


def _csr_rows_to_padded_idx(csr: sparse.csr_matrix, rows: np.ndarray, fill: int) -> np.ndarray:
    """Per-row column indices, padded ragged -> (len(rows), max_len) int32:
    the native host ops when they load, else vectorised numpy."""
    indptr = csr.indptr
    lengths = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    max_len = int(lengths.max()) if len(lengths) else 0
    n = len(rows)
    if max_len == 0:
        return np.full((n, 0), fill, dtype=np.int32)
    native_out = _native.csr_rows_padded_native(csr.indices, indptr, rows, max_len, fill)
    if native_out is not None:
        return native_out
    out = np.full((n, max_len), fill, dtype=np.int32)
    total = int(lengths.sum())
    row_pos = np.repeat(np.arange(n), lengths)
    col_pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    src_idx = np.repeat(indptr[rows].astype(np.int64), lengths) + col_pos
    out[row_pos, col_pos] = csr.indices[src_idx]
    return out


def _seen_columns(
    filter_pairs_csr: sparse.csr_matrix,
    batch_pos: np.ndarray,
    sorted_object_whitelist: tp.Optional[np.ndarray],
    fill: int,
) -> np.ndarray:
    """The seen lists of a batch's rows as score columns, padded with
    ``fill``: object ids, or their whitelist positions (a seen object off the
    whitelist becomes ``fill``)."""
    seen_orig = _csr_rows_to_padded_idx(filter_pairs_csr, batch_pos, fill=-1)
    if sorted_object_whitelist is not None and seen_orig.shape[1] > 0:
        pos = np.searchsorted(sorted_object_whitelist, seen_orig)
        pos_clipped = np.clip(pos, 0, len(sorted_object_whitelist) - 1)
        hit = (seen_orig >= 0) & (sorted_object_whitelist[pos_clipped] == seen_orig)
        return np.where(hit, pos_clipped, fill)
    return np.where(seen_orig >= 0, seen_orig, fill)


def _fetch(handles: tp.Sequence[Handles]) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One device->host transfer per output kind, for all batches together."""
    idx = torch.cat([h[0] for h in handles]).cpu().numpy()
    scores = torch.cat([h[1] for h in handles]).cpu().numpy()
    valid = torch.cat([h[2] for h in handles]).cpu().numpy()
    flags = [h[3] if h[3] is not None else torch.zeros((), dtype=torch.bool, device=h[0].device) for h in handles]
    suspect = torch.stack(flags).cpu().numpy()
    return idx, scores, valid, suspect


def rank_topk(
    subjects: tp.Union[np.ndarray, sparse.csr_matrix, torch.Tensor],
    objects: tp.Union[np.ndarray, torch.Tensor],
    subject_ids: np.ndarray,
    k: int,
    distance: Distance = Distance.DOT,
    filter_pairs_csr: tp.Optional[sparse.csr_matrix] = None,
    sorted_object_whitelist: tp.Optional[np.ndarray] = None,
    batch_size: int = 4096,
    device: DeviceLike = "cuda",
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank top-k objects for each subject. Returns (subject_ids, object_ids,
    scores) flattened triplets, sorted by rank per subject (contract of
    reference rank/rank.py:36-64). ``filter_pairs_csr`` rows align with
    ``subject_ids`` positions."""
    dev = resolve_device(device)
    if sorted_object_whitelist is not None:
        if isinstance(objects, torch.Tensor):
            object_block: tp.Any = objects[host_to_device(np.asarray(sorted_object_whitelist), objects.device)]
        else:
            object_block = np.asarray(objects, dtype=np.float32)[sorted_object_whitelist]
    else:
        object_block = objects
    engine = TopKEngine(object_block, distance=distance, batch_size=batch_size, device=dev)
    fill = engine.fill
    subject_ids = np.asarray(subject_ids)
    if len(subject_ids) == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64), np.array([], dtype=np.float32)

    def batches() -> tp.Iterator[tp.Tuple[tp.Any, tp.Optional[np.ndarray]]]:
        for start in range(0, len(subject_ids), batch_size):
            batch_pos = np.arange(start, min(start + batch_size, len(subject_ids)))
            batch_subject_ids = subject_ids[batch_pos]
            if sparse.issparse(subjects):
                sub_block: tp.Any = np.asarray(subjects[batch_subject_ids].todense(), dtype=np.float32)
            elif isinstance(subjects, torch.Tensor):
                sub_block = subjects[host_to_device(batch_subject_ids.astype(np.int64), subjects.device)]
            else:
                sub_block = np.asarray(subjects[batch_subject_ids], dtype=np.float32)
            seen = None
            if filter_pairs_csr is not None:
                seen = _seen_columns(filter_pairs_csr, batch_pos, sorted_object_whitelist, fill)
            yield sub_block, seen

    idx_all, scores_all, valid_all = _serve_batches(engine, batches(), k, "rank_topk")

    # vectorised strip of masked entries; rows stay rank-sorted
    flat_valid = valid_all.ravel()
    flat_idx = idx_all.ravel()[flat_valid]
    subj_rep = np.repeat(subject_ids.astype(np.int64), valid_all.sum(axis=1))
    if sorted_object_whitelist is not None:
        obj_ids = np.asarray(sorted_object_whitelist)[flat_idx].astype(np.int64)
    else:
        obj_ids = flat_idx.astype(np.int64)
    return subj_rep, obj_ids, scores_all.ravel()[flat_valid].astype(np.float32)


# ----------------------------------------------------------------------- random ranking

ScoreDraw = tp.Callable[[int, tp.Tuple[int, int]], torch.Tensor]


def uniform_draws(generator: torch.Generator) -> ScoreDraw:
    """A ``draw`` for :func:`random_rank_topk`: batch ``bi``'s block of iid
    U[0, 1) scores from ``generator`` (on its device), advancing it; a second
    call for the same batch gives the same block again from the generator
    state saved at the first."""
    states: tp.Dict[int, torch.Tensor] = {}

    def draw(bi: int, shape: tp.Tuple[int, int]) -> torch.Tensor:
        source = generator
        if bi in states:
            source = torch.Generator(device=generator.device)
            source.set_state(states[bi])
        else:
            states[bi] = generator.get_state()
        return torch.rand(shape, generator=source, device=generator.device)

    return draw


def _random_mask_topk(
    scores: torch.Tensor,  # (B, N_pad) f32, overwritten
    seen_idx: torch.Tensor,  # (B, S) int64, fill = n_valid_objects
    n_valid_objects: int,
    k: int,
    exact: bool = False,
) -> Handles:
    """Uniform-random ranking with seen-filtering on a drawn score block, the
    MIPS path's masking (port of JAX ``_random_mask_topk``): (top_idx, top
    scores, valid, suspect or None)."""
    scores[:, n_valid_objects:] = NEG_INF
    scores.scatter_(1, seen_idx, NEG_INF)
    if exact:
        top_scores, top_idx = sorted_top_k(scores, k)
        suspect = None
    else:
        top_scores, top_idx, suspect = grouped_top_k_candidates(scores, k)
    return top_idx, top_scores, top_scores > (NEG_INF / 2), suspect


def random_rank_topk(
    draw: ScoreDraw,
    n_objects: int,
    subject_ids: np.ndarray,
    k: int,
    filter_pairs_csr: tp.Optional[sparse.csr_matrix] = None,
    sorted_object_whitelist: tp.Optional[np.ndarray] = None,
    batch_size: int = 4096,
    device: DeviceLike = "cuda",
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random top-k per subject with seen / whitelist filtering on the device
    (port of JAX ``random_rank_topk``). Batch ``bi``'s (B, N_pad) scores are
    ``draw(bi, (B, N_pad))`` (:func:`uniform_draws`; the tests inject JAX's
    draws); the candidates are padded to a multiple of 128 with at least one
    spare, masked column. Scores returned are per-subject ranks n_reco..1, the
    reference RandomModel's contract. A batch whose certificate fails is drawn
    again and sorted exactly."""
    dev = resolve_device(device)
    n_candidates = len(sorted_object_whitelist) if sorted_object_whitelist is not None else n_objects
    n_pad = int(math.ceil((n_candidates + 1) / 128)) * 128
    fill = n_candidates
    k_eff = min(k, n_candidates)
    subject_ids = np.asarray(subject_ids)
    if k_eff == 0 or len(subject_ids) == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64), np.array([], dtype=np.float32)

    pending: tp.List[tp.Tuple[np.ndarray, torch.Tensor, Handles]] = []
    for bi, start in enumerate(range(0, len(subject_ids), batch_size)):
        batch_pos = np.arange(start, min(start + batch_size, len(subject_ids)))
        seen = None if filter_pairs_csr is None else _seen_columns(filter_pairs_csr, batch_pos,
                                                                   sorted_object_whitelist, fill)
        if seen is None or seen.shape[1] == 0:  # nothing seen: one column of fill
            seen = np.full((len(batch_pos), 1), fill, dtype=np.int64)
        seen_dev = host_to_device(seen.astype(np.int64), dev)
        scores = draw(bi, (len(batch_pos), n_pad)).to(device=dev, dtype=torch.float32)
        pending.append((subject_ids[batch_pos], seen_dev, _random_mask_topk(scores, seen_dev, n_candidates, k_eff)))

    idx_all, _, valid_all, suspect = _fetch([p[2] for p in pending])
    offsets = np.concatenate(([0], np.cumsum([len(p[0]) for p in pending])))
    FALLBACKS["random_rank_topk"] += int(suspect.sum())
    for bi in np.flatnonzero(suspect):
        _, seen_dev, _ = pending[bi]
        scores = draw(int(bi), (len(seen_dev), n_pad)).to(device=dev, dtype=torch.float32)
        idx_b, _, valid_b, _ = _fetch([_random_mask_topk(scores, seen_dev, n_candidates, k_eff, exact=True)])
        idx_all[offsets[bi] : offsets[bi + 1]], valid_all[offsets[bi] : offsets[bi + 1]] = idx_b, valid_b

    counts = valid_all.sum(axis=1)
    flat_idx = idx_all.ravel()[valid_all.ravel()]
    if sorted_object_whitelist is not None:
        obj_ids = np.asarray(sorted_object_whitelist)[flat_idx].astype(np.int64)
    else:
        obj_ids = flat_idx.astype(np.int64)
    all_subj = np.concatenate([p[0] for p in pending]).astype(np.int64)
    ends = np.cumsum(counts)
    positions = np.arange(int(ends[-1])) - np.repeat(ends - counts, counts)
    scores_out = (np.repeat(counts, counts) - positions).astype(np.float32)
    return np.repeat(all_subj, counts), obj_ids, scores_out
