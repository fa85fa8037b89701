"""Base class for embedding-dot-product models: the port of
rectools_tpu/models/vector.py (reference rectools/models/vector.py:39).

User/item factor tables score through the GPU top-k engine on the model's
``device`` (``TorchRanker``); biases fold into padded vectors exactly as in
the reference (vector.py:105-134) so DOT ranking covers
`bias_u + bias_i + <e_u, e_i>`.
"""

import typing as tp

import attr
import numpy as np

from ..dataset import Dataset
from .base import ModelBase, ModelConfig_T
from .rank import Distance, TorchRanker


@attr.s(auto_attribs=True)
class Factors:
    """Embeddings and optional biases."""

    embeddings: np.ndarray
    biases: tp.Optional[np.ndarray] = None


class VectorModel(ModelBase[ModelConfig_T]):
    """Models that represent users and items as vectors."""

    u2i_dist: Distance = NotImplemented
    i2i_dist: Distance = NotImplemented
    device: str  # set by subclasses: "cuda" or "cpu"

    def _rank_on_engine(
        self,
        distance: Distance,
        subjects: np.ndarray,
        objects: np.ndarray,
        subject_ids: np.ndarray,
        k: int,
        seen_csr: tp.Optional[tp.Any] = None,
        whitelist: tp.Optional[np.ndarray] = None,
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        engine = TorchRanker(distance, subjects, objects, device=self.device)
        return engine.rank(subject_ids, k, filter_pairs_csr=seen_csr, sorted_object_whitelist=whitelist)

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        seen_csr = None
        if filter_viewed:
            seen_csr = dataset.get_user_item_matrix(include_weights=False)[user_ids]
        user_vectors, item_vectors = self._get_u2i_vectors(dataset)
        return self._rank_on_engine(
            self.u2i_dist, user_vectors, item_vectors, user_ids, k,
            seen_csr=seen_csr, whitelist=sorted_item_ids_to_recommend,
        )

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        subjects, objects = self._get_i2i_vectors(dataset)
        return self._rank_on_engine(
            self.i2i_dist, subjects, objects, target_ids, k,
            whitelist=sorted_item_ids_to_recommend,
        )

    @staticmethod
    def _fold_biases(distance: Distance, factors: Factors, side: str) -> np.ndarray:
        """Fold additive biases into the embedding space so the plain MIPS
        kernel scores them for free.

        For DOT the target score is ``b_s + b_o + <e_s, e_o>``: prefixing
        subjects with ``(b_s, 1)`` and objects with ``(1, b_o)`` makes the two
        cross terms of the padded dot product reproduce exactly the bias sum.
        For COSINE/EUCLIDEAN the bias joins as one shared extra coordinate on
        both sides (reference convention, vector.py:105-134).
        """
        biases = factors.biases
        assert biases is not None
        bias_col = biases.reshape(-1, 1)
        ones_col = np.ones_like(bias_col)
        if distance == Distance.DOT:
            prefix = (bias_col, ones_col) if side == "subject" else (ones_col, bias_col)
        elif distance in (Distance.COSINE, Distance.EUCLIDEAN):
            prefix = (bias_col,)
        else:
            raise ValueError(f"Unexpected distance `{distance}`")
        return np.hstack(prefix + (factors.embeddings,))

    def _get_u2i_vectors(self, dataset: Dataset) -> tp.Tuple[np.ndarray, np.ndarray]:
        user_factors = self._get_users_factors(dataset)
        item_factors = self._get_items_factors(dataset)
        if user_factors.biases is not None and item_factors.biases is not None:
            return (
                self._fold_biases(self.u2i_dist, user_factors, "subject"),
                self._fold_biases(self.u2i_dist, item_factors, "object"),
            )
        return user_factors.embeddings, item_factors.embeddings

    def _get_i2i_vectors(self, dataset: Dataset) -> tp.Tuple[np.ndarray, np.ndarray]:
        item_factors = self._get_items_factors(dataset)
        if item_factors.biases is not None:
            return (
                self._fold_biases(self.i2i_dist, item_factors, "subject"),
                self._fold_biases(self.i2i_dist, item_factors, "object"),
            )
        return item_factors.embeddings, item_factors.embeddings

    def _get_users_factors(self, dataset: Dataset) -> Factors:
        raise NotImplementedError()

    def _get_items_factors(self, dataset: Dataset) -> Factors:
        raise NotImplementedError()
