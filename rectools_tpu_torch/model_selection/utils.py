"""Split helpers.

The port's copy of ``rectools_tpu/model_selection/utils.py``.

Behavioral parity target: reference rectools/model_selection/utils.py
(``get_not_seen_mask``). The implementation here is key-encoding based
rather than sparse-matrix based: each (user, item) pair is packed into a
single uint64 and membership is one vectorized ``np.isin`` — the same
flatten-the-pair trick the JAX package's seen filter uses in ``ops/topk.py``.
"""

import numpy as np


def get_not_seen_mask(
    train_users: np.ndarray,
    train_items: np.ndarray,
    test_users: np.ndarray,
    test_items: np.ndarray,
) -> np.ndarray:
    """Boolean mask over test interactions: True where the (user, item) pair
    never occurs in train.

    Pairs are compared by packing ``user * row_width + item`` into uint64,
    which turns the 2-D membership test into a sorted 1-D ``np.isin``.

    >>> import numpy as np
    >>> tr_u, tr_i = np.array([0, 0, 1]), np.array([10, 11, 10])
    >>> te_u, te_i = np.array([0, 1, 2]), np.array([11, 12, 10])
    >>> get_not_seen_mask(tr_u, tr_i, te_u, te_i)
    array([False,  True,  True])
    """
    if len(train_users) != len(train_items):
        raise ValueError("train_users and train_items carry different numbers of interactions")
    if len(test_users) != len(test_items):
        raise ValueError("test_users and test_items carry different numbers of interactions")

    if len(test_users) == 0:
        return np.zeros(0, dtype=bool)
    if len(train_users) == 0:
        return np.ones(len(test_users), dtype=bool)

    # Internal ids are non-negative ints well below 2**32, so the packed key
    # u * width + i cannot overflow uint64.
    width = np.uint64(max(int(train_items.max()), int(test_items.max())) + 1)
    train_keys = train_users.astype(np.uint64) * width + train_items.astype(np.uint64)
    test_keys = test_users.astype(np.uint64) * width + test_items.astype(np.uint64)
    return ~np.isin(test_keys, train_keys)
