"""Training module — the inference half of
rectools_tpu/models/nn/transformers/training.py.

Holds the backbone (an ``nn.Module`` on the model's device) and serves u2i and
i2i recommendations from it. Training (the optimizer loop, the fused
softmax-CE and the backward kernels) is the next slice of the port.
"""

import typing as tp

import numpy as np
import torch

from ....dataset.dataset import Dataset
from ....utils.device import full_f32_matmul, host_to_device
from ...base import InternalRecoTriplet
from ...rank import Distance, TorchRanker
from .backbone import TransformerBackboneBase
from .data_preparator import BatchLoader

TRAINING_NOT_PORTED = (
    "Training is not ported yet: it is the next slice of the PyTorch port (ROADMAP.md, slice 2: "
    "training). Load weights trained by the JAX package with `load_jax_params` instead."
)


class TransformerTrainingModule:
    """Default module (reference lightning.py:259-449), inference half."""

    i2i_dist = Distance.COSINE

    def __init__(self, backbone: TransformerBackboneBase, device: torch.device) -> None:
        self.backbone = backbone.to(device).eval()
        self.device = device

    def fit(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        raise NotImplementedError(TRAINING_NOT_PORTED)

    # --------------------------------------------------------------- inference

    def _encode_last(self, x: torch.Tensor, item_embs: torch.Tensor) -> torch.Tensor:
        """Session-tower output of the last position for each session."""
        session_embs = self.backbone.encode_sessions({"x": x}, item_embs)
        return self.backbone.similarity_module.session_tower_forward(session_embs[:, -1, :])

    def _catalog_item_embs(self) -> torch.Tensor:
        return self.backbone.item_model.embed_catalog()

    def _catalog_item_tower(self, item_embs: torch.Tensor) -> torch.Tensor:
        return self.backbone.similarity_module.item_tower_forward(item_embs)

    def _get_user_item_embeddings(self, recommend_loader: BatchLoader) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """User (last-position) and item tower outputs, device-resident: every
        batch is dispatched before anything comes back to the host, and the
        ranker consumes the tensors where they are."""
        item_embs = self._catalog_item_embs()
        user_embs = [
            self._encode_last(host_to_device(batch["x"], self.device), item_embs) for batch in recommend_loader
        ]
        return torch.cat(user_embs, dim=0), self._catalog_item_tower(item_embs)

    def recommend_u2i(
        self,
        user_ids: np.ndarray,
        recommend_loader: BatchLoader,
        sorted_item_ids_to_recommend: np.ndarray,
        k: int,
        dataset: Dataset,
        filter_viewed: bool,
    ) -> InternalRecoTriplet:
        """U2I: batch-encode sessions then rank on the top-k engine
        (reference lightning.py:402-426)."""
        ui_csr_for_filter = None
        if filter_viewed:
            ui_csr_for_filter = dataset.get_user_item_matrix(include_weights=False, include_warm_items=True)[user_ids]
        with torch.inference_mode(), full_f32_matmul():
            user_embs, item_embs = self._get_user_item_embeddings(recommend_loader)
            return self.backbone.similarity_module.recommend_u2i(
                user_embs=user_embs,
                item_embs=item_embs,
                user_ids=np.asarray(user_ids),
                k=k,
                sorted_item_ids_to_recommend=sorted_item_ids_to_recommend,
                ui_csr_for_filter=ui_csr_for_filter,
            )

    def recommend_i2i(
        self,
        target_ids: np.ndarray,
        sorted_item_ids_to_recommend: np.ndarray,
        k: int,
    ) -> InternalRecoTriplet:
        """I2I: cosine ranking over raw item-net embeddings
        (reference lightning.py:428-449)."""
        with torch.inference_mode(), full_f32_matmul():
            item_embs = self._catalog_item_embs()
            ranker = TorchRanker(
                distance=self.i2i_dist, subjects_factors=item_embs, objects_factors=item_embs, device=self.device
            )
            return ranker.rank(
                subject_ids=target_ids,
                k=k,
                filter_pairs_csr=None,
                sorted_object_whitelist=sorted_item_ids_to_recommend,
            )
