"""Item-item kNN models: the port of rectools_tpu/models/item_knn.py
(equivalent of reference rectools/models/implicit_knn.py:91-255, which wraps
implicit.nearest_neighbours ItemItemRecommender/Cosine/TFIDF/BM25).

The item-item similarity table S = W(X)^T W(X) (W = per-variant weighting) is
accumulated on the model's ``device`` by the same blocked Gram as EASE, then
truncated to its top K per row on the device by the grouped top-k (kernel 3 on
the card) in blocks of ``TRUNCATE_BLOCK_ROWS`` rows: ties keep the lowest
index, as ``lax.top_k`` does (``torch.topk`` promises no tie order on CUDA).
The plain variant's co-counts are integers and tie often, and a row's top K
may crowd into one group of 128 ids, so every group keeps K candidates: then
no tie or crowding can hide an entry of the top K. u2i scoring = user-history
CSR rows x S through the top-k ranking engine; i2i = similarity-row ranking
via one-hot subjects.
"""

import typing as tp

import numpy as np
import torch
import typing_extensions as tpe
from scipy import sparse

from ..dataset import Dataset
from ..ops.linalg import gram_matrix
from ..ops.topk_select import GROUP_W, grouped_exact_top_k
from ..utils.device import resolve_device
from .base import ModelBase, ModelConfig
from .rank import Distance, TorchRanker

TRUNCATE_BLOCK_ROWS = 4096  # rows of S per top-K selection, the serving batch

KnnVariant = tp.Literal["plain", "cosine", "tfidf", "bm25"]


def _idf(ui_csr: sparse.csr_matrix) -> np.ndarray:
    """Per-user inverse document frequency over the item axis
    (implicit's convention: idf = log(N_items) - log1p(df_user))."""
    n_items = ui_csr.shape[1]
    df = np.bincount(ui_csr.tocoo().row, minlength=ui_csr.shape[0]).astype(np.float64)
    return np.log(n_items) - np.log1p(df)


def apply_weighting(
    ui_csr: sparse.csr_matrix, variant: KnnVariant, k1: float = 100.0, b: float = 0.8
) -> sparse.csr_matrix:
    """Weight the user-item matrix so that X^T X gives the variant's similarity.

    X = items-over-users; weighting conventions follow implicit's
    nearest_neighbours module (cosine row-normalization, tf-idf sqrt*idf,
    BM25 with K1/B length normalization).
    """
    x = ui_csr.astype(np.float64).copy()
    if variant == "plain":
        return x
    coo = x.tocoo()
    if variant == "cosine":
        # Normalize item vectors (columns of ui): S becomes cosine similarity.
        col_norms = np.sqrt(np.asarray(x.multiply(x).sum(axis=0)).ravel())
        col_norms[col_norms == 0] = 1.0
        data = coo.data / col_norms[coo.col]
    elif variant == "tfidf":
        idf = _idf(x)
        data = np.sqrt(coo.data) * idf[coo.row]
    elif variant == "bm25":
        idf = _idf(x)
        # Item "document" lengths over users.
        item_sums = np.asarray(x.sum(axis=0)).ravel()
        avg_len = item_sums.mean() if item_sums.size else 1.0
        length_norm = (1.0 - b) + b * item_sums / max(avg_len, 1e-12)
        data = coo.data * (k1 + 1.0) / (k1 * length_norm[coo.col] + coo.data) * idf[coo.row]
    else:
        raise ValueError(f"Unknown weighting variant: {variant}")
    return sparse.csr_matrix((data, (coo.row, coo.col)), shape=x.shape)


def _truncate_topk_rows(s: torch.Tensor, k: int, block_rows: int = TRUNCATE_BLOCK_ROWS) -> torch.Tensor:
    """Keep only the top-k entries of each row, zero the rest. Each group of
    128 columns keeps k candidates, so the grouped selection is exact and its
    certificate cannot fail, however many entries tie."""
    out = torch.zeros_like(s)
    m = min(k, GROUP_W)
    for start in range(0, s.shape[0], block_rows):
        top_vals, top_idx = grouped_exact_top_k(s[start : start + block_rows], k, m=m)
        out[start : start + block_rows].scatter_(1, top_idx, top_vals)
    return out


class ItemKNNModelConfig(ModelConfig):
    """Config for `ItemKNNModel`."""

    K: int = 10
    variant: KnnVariant = "plain"
    K1: float = 100.0
    B: float = 0.8
    device: str = "cuda"


class ItemKNNModel(ModelBase[ItemKNNModelConfig]):
    """Item-item collaborative kNN with plain/cosine/tf-idf/BM25 weighting."""

    recommends_for_warm = False
    recommends_for_cold = False

    config_class = ItemKNNModelConfig

    def __init__(
        self,
        K: int = 10,
        variant: KnnVariant = "plain",
        K1: float = 100.0,
        B: float = 0.8,
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.K = K
        self.variant = variant
        self.K1 = K1
        self.B = B
        self.similarity: np.ndarray  # (n_items, n_items) top-K truncated

    def _get_config(self) -> ItemKNNModelConfig:
        return ItemKNNModelConfig(
            cls=self.__class__, K=self.K, variant=self.variant, K1=self.K1, B=self.B, verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: ItemKNNModelConfig) -> tpe.Self:
        return cls(
            K=config.K, variant=config.variant, K1=config.K1, B=config.B, verbose=config.verbose, device=config.device
        )

    def _fit(self, dataset: Dataset) -> None:
        ui_csr = dataset.get_user_item_matrix(include_weights=True)
        weighted = apply_weighting(ui_csr, self.variant, self.K1, self.B).astype(np.float32)
        s = gram_matrix(weighted.tocsr(), device=self.device)
        k = min(self.K, s.shape[0])
        self.similarity = _truncate_topk_rows(s, k).cpu().numpy()

    def _similarity_t(self) -> torch.Tensor:
        """S^T, the ranker's object table: S uploaded as it is and transposed
        on the device (a view), where a host transpose would copy the table."""
        return torch.as_tensor(self.similarity, device=resolve_device(self.device)).T

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        user_items = dataset.get_user_item_matrix(include_weights=True)
        ranker = TorchRanker(Distance.DOT, user_items, self._similarity_t(), device=self.device)
        filter_csr = user_items[user_ids] if filter_viewed else None
        return ranker.rank(
            subject_ids=user_ids,
            k=k,
            filter_pairs_csr=filter_csr,
            sorted_object_whitelist=sorted_item_ids_to_recommend,
        )

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = self.similarity.shape[0]
        one_hot = sparse.identity(n, dtype=np.float32, format="csr")
        ranker = TorchRanker(Distance.DOT, one_hot, self._similarity_t(), device=self.device)
        return ranker.rank(
            subject_ids=target_ids,
            k=k,
            filter_pairs_csr=None,
            sorted_object_whitelist=sorted_item_ids_to_recommend,
        )
