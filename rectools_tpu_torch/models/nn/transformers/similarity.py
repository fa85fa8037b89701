"""Similarity heads: session/item towers -> logits; owns u2i ranking.

Port of rectools_tpu/models/nn/transformers/similarity.py.
"""

import typing as tp

import numpy as np
import torch
from scipy import sparse
from torch import nn

from ...base import InternalRecoTriplet
from ...rank import Distance, TorchRanker

EPSILON_COSINE_DIST = 1e-8

_DISTANCE_FROM_STR = {"dot": Distance.DOT, "cosine": Distance.COSINE}


class SimilarityModuleBase(nn.Module):
    """Base class for similarity modules."""

    def _get_full_catalog_logits(self, session_embs: torch.Tensor, item_embs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError()

    def _get_pos_neg_logits(
        self, session_embs: torch.Tensor, item_embs: torch.Tensor, candidate_item_ids: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError()

    def session_tower_forward(self, session_embs: torch.Tensor) -> torch.Tensor:
        """Forward pass for session tower."""
        return session_embs

    def item_tower_forward(self, item_embs: torch.Tensor) -> torch.Tensor:
        """Forward pass for item tower."""
        return item_embs

    def catalog_loss_towers(
        self, session_embs: torch.Tensor, item_embs: torch.Tensor
    ) -> tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]]:
        """(s, i) such that ``einsum('bld,nd->bln', s, i)`` equals
        `_get_full_catalog_logits`, or None when the module's logits are not a
        plain dot product (disables the fused softmax loss)."""
        return None

    def forward(
        self,
        session_embs: torch.Tensor,
        item_embs: torch.Tensor,
        candidate_item_ids: tp.Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Full-catalog logits (B, L, N), or candidate logits (B, L, C)."""
        raise NotImplementedError()

    def recommend_u2i(
        self,
        user_embs: torch.Tensor,
        item_embs: torch.Tensor,
        user_ids: np.ndarray,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
        ui_csr_for_filter: tp.Optional[sparse.csr_matrix],
    ) -> InternalRecoTriplet:
        """U2I ranking over device-resident tower outputs."""
        raise NotImplementedError()


class DistanceSimilarityModule(SimilarityModuleBase):
    """Dot/cosine logits (reference similarity.py:67-140)."""

    def __init__(self, distance: str = "dot") -> None:
        super().__init__()
        self.distance = distance

    def _dist(self) -> Distance:
        if self.distance not in _DISTANCE_FROM_STR:
            raise ValueError("`distance` can only be either `dot` or `cosine`.")
        return _DISTANCE_FROM_STR[self.distance]

    def _get_full_catalog_logits(self, session_embs: torch.Tensor, item_embs: torch.Tensor) -> torch.Tensor:
        # f32 logits, from bf16 towers too (JAX `preferred_element_type=float32`)
        return torch.einsum("bld,nd->bln", session_embs.float(), item_embs.float())

    def _get_pos_neg_logits(
        self, session_embs: torch.Tensor, item_embs: torch.Tensor, candidate_item_ids: torch.Tensor
    ) -> torch.Tensor:
        # candidates (B, L, C): gather, then a per-position dot
        return torch.einsum("blcd,bld->blc", item_embs[candidate_item_ids].float(), session_embs.float())

    def _normalize(self, embeddings: torch.Tensor) -> torch.Tensor:
        norm_sq = (embeddings * embeddings).sum(dim=-1, keepdim=True)
        return embeddings / torch.sqrt(torch.clamp(norm_sq, min=EPSILON_COSINE_DIST**2))

    def catalog_loss_towers(
        self, session_embs: torch.Tensor, item_embs: torch.Tensor
    ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        if self._dist() == Distance.COSINE:
            return self._normalize(session_embs), self._normalize(item_embs)
        return session_embs, item_embs

    def forward(
        self,
        session_embs: torch.Tensor,
        item_embs: torch.Tensor,
        candidate_item_ids: tp.Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self._dist() == Distance.COSINE:
            session_embs = self._normalize(session_embs)
            item_embs = self._normalize(item_embs)
        if candidate_item_ids is None:
            return self._get_full_catalog_logits(session_embs, item_embs)
        return self._get_pos_neg_logits(session_embs, item_embs, candidate_item_ids)

    def recommend_u2i(
        self,
        user_embs: torch.Tensor,
        item_embs: torch.Tensor,
        user_ids: np.ndarray,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
        ui_csr_for_filter: tp.Optional[sparse.csr_matrix],
    ) -> InternalRecoTriplet:
        ranker = TorchRanker(
            distance=self._dist(),
            subjects_factors=user_embs,
            objects_factors=item_embs,
            device=item_embs.device,
        )
        # rows of user_embs are internal user ids: the ranker gathers each
        # batch's rows on the device and reports the ids themselves
        return ranker.rank(
            subject_ids=user_ids,
            k=k,
            filter_pairs_csr=ui_csr_for_filter,
            sorted_object_whitelist=sorted_item_ids_to_recommend,
        )
