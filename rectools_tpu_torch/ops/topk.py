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

The serving loop (:func:`rank_topk`) dispatches every batch first and brings
the results to the host once; the grouped selection's certificate flags come
back with them, and only a suspect batch (rare; adversarial layouts) is
recomputed by the exact sort.
"""

import math
import typing as tp
from enum import Enum

import numpy as np
import torch
from scipy import sparse

from ..utils.device import DeviceLike, full_f32_matmul, host_to_device, resolve_device
from .topk_select import grouped_exact_top_k, grouped_top_k_candidates, sorted_top_k


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
    """Device-resident object table + batched subject scoring."""

    def __init__(
        self,
        objects: tp.Union[np.ndarray, torch.Tensor],  # (N, D)
        distance: Distance = Distance.DOT,
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.distance = distance
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


def _csr_rows_to_padded_idx(csr: sparse.csr_matrix, rows: np.ndarray, fill: int) -> np.ndarray:
    """Per-row column indices, padded ragged -> (len(rows), max_len), in
    vectorised numpy (the native C++ copy is a later port)."""
    indptr = csr.indptr
    lengths = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    max_len = int(lengths.max()) if len(lengths) else 0
    n = len(rows)
    out = np.full((n, max_len), fill, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return out
    row_pos = np.repeat(np.arange(n), lengths)
    col_pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    src_idx = np.repeat(indptr[rows].astype(np.int64), lengths) + col_pos
    out[row_pos, col_pos] = csr.indices[src_idx]
    return out


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
    engine = TopKEngine(object_block, distance=distance, device=dev)
    fill = engine.fill
    subject_ids = np.asarray(subject_ids)

    # Two-phase serving loop: dispatch every batch (kernel launches queue on
    # the stream), then bring all results to the host in one fetch.
    pending: tp.List[tp.Tuple[np.ndarray, tp.Any, tp.Optional[np.ndarray], Handles]] = []
    for start in range(0, len(subject_ids), batch_size):
        batch_pos = np.arange(start, min(start + batch_size, len(subject_ids)))
        batch_subject_ids = subject_ids[batch_pos]
        if sparse.issparse(subjects):
            sub_block: tp.Any = np.asarray(subjects[batch_subject_ids].todense(), dtype=np.float32)
        elif isinstance(subjects, torch.Tensor):
            sub_block = subjects[host_to_device(batch_subject_ids.astype(np.int64), subjects.device)]
        else:
            sub_block = np.asarray(subjects[batch_subject_ids], dtype=np.float32)

        seen: tp.Optional[np.ndarray] = None
        if filter_pairs_csr is not None:
            seen_orig = _csr_rows_to_padded_idx(filter_pairs_csr, batch_pos, fill=-1)
            if sorted_object_whitelist is not None and seen_orig.shape[1] > 0:
                # original object ids -> whitelist positions; misses -> fill
                pos = np.searchsorted(sorted_object_whitelist, seen_orig)
                pos_clipped = np.clip(pos, 0, len(sorted_object_whitelist) - 1)
                hit = (seen_orig >= 0) & (sorted_object_whitelist[pos_clipped] == seen_orig)
                seen = np.where(hit, pos_clipped, fill)
            else:
                seen = np.where(seen_orig >= 0, seen_orig, fill)
        pending.append((batch_subject_ids, sub_block, seen, engine.query_batch_async(sub_block, k, seen)))

    if not pending:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64), np.array([], dtype=np.float32)
    idx_all, scores_all, valid_all, suspect = _fetch([p[3] for p in pending])
    sizes = [len(p[0]) for p in pending]
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    for bi in np.flatnonzero(suspect):
        # certificate failed: recompute this batch with the exact sort
        batch_subject_ids, sub_block, seen, _ = pending[bi]
        idx_b, scores_b, valid_b, _ = _fetch([engine.query_batch_async(sub_block, k, seen, exact=True)])
        lo, hi = offsets[bi], offsets[bi + 1]
        idx_all[lo:hi], scores_all[lo:hi], valid_all[lo:hi] = idx_b, scores_b, valid_b

    # vectorised strip of masked entries; rows stay rank-sorted
    flat_valid = valid_all.ravel()
    flat_idx = idx_all.ravel()[flat_valid]
    all_subj = np.concatenate([p[0] for p in pending]).astype(np.int64)
    subj_rep = np.repeat(all_subj, valid_all.sum(axis=1))
    if sorted_object_whitelist is not None:
        obj_ids = np.asarray(sorted_object_whitelist)[flat_idx].astype(np.int64)
    else:
        obj_ids = flat_idx.astype(np.int64)
    return subj_rep, obj_ids, scores_all.ravel()[flat_valid].astype(np.float32)
