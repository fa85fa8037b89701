"""EASE: closed-form shallow autoencoder (https://arxiv.org/abs/1905.03375).

The port of rectools_tpu/models/ease.py. Behavioral parity with reference
rectools/models/ease.py:122-188, but the Gram build + inverse run on the
model's ``device`` (see ops/linalg.py) and both u2i and i2i ranking run
through the GPU top-k engine — the reference's host argpartition i2i path
(ease.py:163-188) is replaced by ranking sparse one-hot subjects against the
similarity table. ``mesh_shape`` stays in the config, so JAX configs load;
fitting with it set raises (not ported).
"""

import typing as tp

import numpy as np
import torch
import typing_extensions as tpe
from scipy import sparse

from ..dataset import Dataset
from ..ops.linalg import ease_weight, refuse_mesh
from ..utils.device import resolve_device
from .base import ModelBase, ModelConfig
from .rank import Distance, TorchRanker


class EASEModelConfig(ModelConfig):
    """Config for `EASEModel`."""

    regularization: float = 500.0
    mesh_shape: tp.Optional[tp.Tuple[int, int]] = None
    solver: str = "auto"
    device: str = "cuda"


class EASEModel(ModelBase[EASEModelConfig]):
    """Embarrassingly Shallow Autoencoder.

    Note: fit materializes an (n_items, n_items) dense matrix; reasonable
    catalog size is ~30k items (same bound as the reference).
    """

    recommends_for_warm = False
    recommends_for_cold = False

    config_class = EASEModelConfig

    def __init__(
        self,
        regularization: float = 500.0,
        mesh_shape: tp.Optional[tp.Tuple[int, int]] = None,
        solver: str = "auto",
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.weight: np.ndarray
        self.regularization = regularization
        self.mesh_shape = tuple(mesh_shape) if mesh_shape is not None else None
        self.solver = solver

    def _get_config(self) -> EASEModelConfig:
        return EASEModelConfig(
            cls=self.__class__,
            regularization=self.regularization,
            mesh_shape=self.mesh_shape,
            solver=self.solver,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: EASEModelConfig) -> tpe.Self:
        return cls(
            regularization=config.regularization,
            mesh_shape=config.mesh_shape,
            solver=config.solver,
            verbose=config.verbose,
            device=config.device,
        )

    def _fit(self, dataset: Dataset) -> None:
        refuse_mesh(self.mesh_shape)
        ui_csr = dataset.get_user_item_matrix(include_weights=True)
        self.weight = ease_weight(ui_csr, self.regularization, solver=self.solver, device=self.device)

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        user_items = dataset.get_user_item_matrix(include_weights=True)
        ranker = TorchRanker(Distance.DOT, user_items, self.weight, device=self.device)
        ui_csr_for_filter = user_items[user_ids] if filter_viewed else None
        return ranker.rank(
            subject_ids=user_ids,
            k=k,
            filter_pairs_csr=ui_csr_for_filter,
            sorted_object_whitelist=sorted_item_ids_to_recommend,
        )

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        # scores for target t = weight[t] row: one-hot subjects vs weight^T.
        n = self.weight.shape[0]
        one_hot = sparse.identity(n, dtype=np.float32, format="csr")
        weight_t = torch.as_tensor(self.weight, device=resolve_device(self.device)).T  # transposed on the device
        ranker = TorchRanker(Distance.DOT, one_hot, weight_t, device=self.device)
        return ranker.rank(
            subject_ids=target_ids,
            k=k,
            filter_pairs_csr=None,
            sorted_object_whitelist=sorted_item_ids_to_recommend,
        )
