"""Model-level helpers (port of rectools_tpu/models/utils.py; reference
rectools/models/utils.py:28-136)."""

import typing as tp

import numpy as np
from scipy import sparse


def get_viewed_item_ids(user_items: sparse.csr_matrix, user_id: int) -> np.ndarray:
    """Item ids the user interacted with (CSR indptr slice)."""
    return user_items.indices[user_items.indptr[user_id] : user_items.indptr[user_id + 1]]


def recommend_from_scores(
    scores: np.ndarray,
    k: int,
    sorted_blacklist: tp.Optional[np.ndarray] = None,
    sorted_whitelist: tp.Optional[np.ndarray] = None,
    ascending: bool = False,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Top-k ids by score with optional white/black lists
    (reference models/utils.py:52-136)."""
    scores = np.asarray(scores)
    ids = np.arange(len(scores))

    if sorted_whitelist is not None:
        mask = np.isin(ids, sorted_whitelist, assume_unique=True)
        ids, scores = ids[mask], scores[mask]
    if sorted_blacklist is not None:
        mask = ~np.isin(ids, sorted_blacklist, assume_unique=True)
        ids, scores = ids[mask], scores[mask]

    if ascending:
        scores = -scores

    n = min(k, len(scores))
    if n == 0:
        return np.array([], dtype=int), np.array([])
    top_unsorted = np.argpartition(scores, -n)[-n:]
    order = np.argsort(-scores[top_unsorted], kind="stable")
    top = top_unsorted[order]
    reco_scores = scores[top]
    if ascending:
        reco_scores = -reco_scores
    return ids[top], reco_scores
