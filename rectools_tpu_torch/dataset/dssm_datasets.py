"""Host-side data builders for DSSM training and inference: the port's copy
of rectools_tpu/dataset/dssm_datasets.py (numpy and scipy only).

Equivalent of reference rectools/dataset/torch_datasets.py:33-213, re-worked
for whole-batch feeding: instead of per-row torch Dataset __getitem__ calls,
these builders keep the CSR matrices and produce whole fixed-shape dense
minibatches with fully vectorized positive/negative sampling.
"""

import typing as tp

import numpy as np
from scipy import sparse

from .dataset import Dataset

Batch = tp.Tuple[np.ndarray, ...]


class DSSMTrainDataset:
    """Training data: user features + interactions rows, weight-proportional
    positive and uniform negative item sampling
    (reference torch_datasets.py:45-110)."""

    def __init__(
        self,
        items: sparse.csr_matrix,
        users: sparse.csr_matrix,
        interactions: sparse.csr_matrix,
    ) -> None:
        self.items = items
        self.users = users
        self.interactions = interactions
        if not self.interactions.sum(1).all() or (self.interactions < 0).sum(1).any():
            raise ValueError(
                "Impossible to sample from a row that either contains only negative items"
                " or contains any negatively signed integers."
                "Make sure that all rows from interactions have at least 1 positive item"
            )

    @classmethod
    def from_dataset(cls, dataset: Dataset) -> "DSSMTrainDataset":
        ui_matrix = dataset.get_user_item_matrix()
        item_features = dataset.get_hot_item_features()
        user_features = dataset.get_hot_user_features()
        if item_features is None:
            raise AttributeError("Item features attribute of dataset could not be None")
        if user_features is None:
            raise AttributeError("User features attribute of dataset could not be None")
        return cls(items=item_features.get_sparse(), users=user_features.get_sparse(), interactions=ui_matrix)

    def __len__(self) -> int:
        return self.interactions.shape[0]

    def sample_positives(self, rows: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Weight-proportional positive per row, vectorized over the batch via
        per-row cumulative-sum inversion (no python loop)."""
        csr = self.interactions
        indptr, indices, data = csr.indptr, csr.indices, csr.data
        starts = indptr[rows]
        lengths = indptr[rows + 1] - starts

        total = int(lengths.sum())
        seg_end = np.cumsum(lengths)
        seg_start = seg_end - lengths
        flat = np.repeat(starts, lengths) + (np.arange(total) - np.repeat(seg_start, lengths))
        vals = data[flat]
        global_cums = np.cumsum(vals)
        seg_offsets = np.repeat(global_cums[seg_start] - vals[seg_start], lengths)
        within_cums = global_cums - seg_offsets  # cumsum restarted per row

        row_sums = within_cums[seg_end - 1]
        targets = rng.random(len(rows)) * row_sums
        # first element whose within-row cumsum exceeds the target
        hit = within_cums > np.repeat(targets, lengths)
        first_hit = np.zeros(len(rows), dtype=np.int64)
        hit_idx = np.flatnonzero(hit)
        if len(hit_idx):
            seg_of = np.searchsorted(seg_end, hit_idx, side="right")
            uniq, first = np.unique(seg_of, return_index=True)
            first_hit[uniq] = hit_idx[first] - seg_start[uniq]
        return indices[starts + np.minimum(first_hit, lengths - 1)]

    def make_batch(self, rows: np.ndarray, rng: np.random.Generator) -> Batch:
        """(user_features, interactions, pos_item_features, neg_item_features)
        as dense float32 arrays for one batch of user rows."""
        pos_items = self.sample_positives(rows, rng)
        neg_items = rng.integers(0, self.interactions.shape[1], size=len(rows))
        user_features = np.asarray(self.users[rows].todense(), dtype=np.float32)
        interactions = np.asarray(self.interactions[rows].todense(), dtype=np.float32)
        pos = np.asarray(self.items[pos_items].todense(), dtype=np.float32)
        neg = np.asarray(self.items[neg_items].todense(), dtype=np.float32)
        return user_features, interactions, pos, neg


class DSSMItemDataset:
    """Inference data: item feature rows (reference torch_datasets.py:113-151)."""

    def __init__(self, items: sparse.csr_matrix) -> None:
        self.items = items

    @classmethod
    def from_dataset(cls, dataset: Dataset) -> "DSSMItemDataset":
        if dataset.item_features is not None:
            return cls(dataset.item_features.get_sparse())
        raise AttributeError("Item features attribute of dataset could not be None")

    def __len__(self) -> int:
        return self.items.shape[0]

    def dense_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.asarray(self.items[rows].todense(), dtype=np.float32)


class DSSMUserDataset:
    """Inference data: user feature + interaction rows
    (reference torch_datasets.py:154-213)."""

    def __init__(
        self,
        users: sparse.csr_matrix,
        interactions: sparse.csr_matrix,
        keep_users: tp.Optional[tp.Sequence[int]] = None,
    ) -> None:
        if users.shape[0] != interactions.shape[0]:
            raise ValueError("Number of rows in user features matrix and in interactions matrix must be the same")
        if keep_users is not None:
            self.users = users[keep_users]
            self.interactions = interactions[keep_users]
        else:
            self.users = users
            self.interactions = interactions

    @classmethod
    def from_dataset(cls, dataset: Dataset, keep_users: tp.Optional[tp.Sequence[int]] = None) -> "DSSMUserDataset":
        if dataset.user_features is not None:
            return cls(
                dataset.user_features.get_sparse(),
                dataset.get_user_item_matrix(include_warm_users=True),
                keep_users,
            )
        raise AttributeError("User features attribute of dataset could not be None")

    def __len__(self) -> int:
        return self.users.shape[0]

    def dense_rows(self, rows: np.ndarray) -> tp.Tuple[np.ndarray, np.ndarray]:
        return (
            np.asarray(self.users[rows].todense(), dtype=np.float32),
            np.asarray(self.interactions[rows].todense(), dtype=np.float32),
        )
