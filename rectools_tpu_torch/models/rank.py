"""Ranker over the GPU top-k engine (port of rectools_tpu/models/rank.py;
contract per reference rank/rank.py:36-64). Mesh sharding is a later port."""

import typing as tp

import numpy as np
import torch
from scipy import sparse

from ..ops.topk import Distance, rank_topk
from ..utils.device import DeviceLike, resolve_device

__all__ = ["Distance", "Ranker", "TorchRanker"]


class Ranker(tp.Protocol):
    """Protocol: batched top-k ranking returning flattened sorted triplets."""

    def rank(
        self,
        subject_ids: np.ndarray,
        k: int,
        filter_pairs_csr: tp.Optional[sparse.csr_matrix] = None,
        sorted_object_whitelist: tp.Optional[np.ndarray] = None,
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ...  # pragma: no cover


class TorchRanker:
    """Exact top-k MIPS over subject/object factor matrices on ``device``.

    Factor matrices may be numpy arrays or tensors; tensors already on the
    device stay there (the transformer towers never leave it).
    """

    def __init__(
        self,
        distance: Distance,
        subjects_factors: tp.Union[np.ndarray, sparse.csr_matrix, torch.Tensor],
        objects_factors: tp.Union[np.ndarray, torch.Tensor],
        batch_size: int = 4096,
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.distance = distance
        self.subjects_factors = subjects_factors
        if isinstance(objects_factors, torch.Tensor):
            self.objects_factors: tp.Any = objects_factors
        else:
            self.objects_factors = np.asarray(objects_factors, dtype=np.float32)
        self.batch_size = batch_size

    def rank(
        self,
        subject_ids: np.ndarray,
        k: int,
        filter_pairs_csr: tp.Optional[sparse.csr_matrix] = None,
        sorted_object_whitelist: tp.Optional[np.ndarray] = None,
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        subject_ids = np.asarray(subject_ids)
        if filter_pairs_csr is not None and filter_pairs_csr.shape[0] != len(subject_ids):
            raise ValueError("Number of rows in `filter_pairs_csr` must match `subject_ids` length")
        return rank_topk(
            subjects=self.subjects_factors,
            objects=self.objects_factors,
            subject_ids=subject_ids,
            k=k,
            distance=self.distance,
            filter_pairs_csr=filter_pairs_csr,
            sorted_object_whitelist=sorted_object_whitelist,
            batch_size=self.batch_size,
            device=self.device,
        )
