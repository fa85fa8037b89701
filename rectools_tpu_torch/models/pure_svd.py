"""PureSVD matrix factorization (https://dl.acm.org/doi/10.1145/1864708.1864721).

The port of rectools_tpu/models/pure_svd.py. Behavioral parity with reference
rectools/models/pure_svd.py:88-187. The ARPACK/cupy `svds` call becomes an
eigh of the item Gram matrix on the model's ``device`` (ops/linalg.py
`truncated_svd`): exact eigh for small catalogs, randomized subspace
iteration (matmuls + Householder QR) beyond ~1k items, the JAX package's
dispatch. ``tol``/``maxiter`` map to the iteration's convergence knobs like
the reference maps them to ARPACK. Factor conventions match the reference:
user_factors = U, item_factors = V diag(s); DOT for u2i, COSINE for i2i.
``mesh_shape`` stays in the config, so JAX configs load; fitting with it set
raises (not ported).
"""

import typing as tp

import numpy as np
import typing_extensions as tpe

from ..dataset import Dataset
from ..exceptions import NotFittedError
from ..ops.linalg import refuse_mesh, truncated_svd
from ..utils.device import resolve_device
from .base import ModelConfig
from .rank import Distance
from .vector import Factors, VectorModel


class PureSVDModelConfig(ModelConfig):
    """Config for `PureSVDModel`."""

    factors: int = 10
    tol: float = 0
    maxiter: tp.Optional[int] = None
    random_state: tp.Optional[int] = None
    mesh_shape: tp.Optional[tp.Tuple[int, int]] = None
    solver: str = "auto"
    device: str = "cuda"


class PureSVDModel(VectorModel[PureSVDModelConfig]):
    """Truncated SVD of the user-item matrix."""

    recommends_for_warm = False
    recommends_for_cold = False

    u2i_dist = Distance.DOT
    i2i_dist = Distance.COSINE

    config_class = PureSVDModelConfig

    def __init__(
        self,
        factors: int = 10,
        tol: float = 0,
        maxiter: tp.Optional[int] = None,
        random_state: tp.Optional[int] = None,
        mesh_shape: tp.Optional[tp.Tuple[int, int]] = None,
        solver: str = "auto",
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.factors = factors
        self.tol = tol
        self.maxiter = maxiter
        self.random_state = random_state
        self.mesh_shape = tuple(mesh_shape) if mesh_shape is not None else None
        self.solver = solver
        self.user_factors: np.ndarray
        self.item_factors: np.ndarray

    def _get_config(self) -> PureSVDModelConfig:
        return PureSVDModelConfig(
            cls=self.__class__,
            factors=self.factors,
            tol=self.tol,
            maxiter=self.maxiter,
            random_state=self.random_state,
            mesh_shape=self.mesh_shape,
            solver=self.solver,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: PureSVDModelConfig) -> tpe.Self:
        return cls(
            factors=config.factors,
            tol=config.tol,
            maxiter=config.maxiter,
            random_state=config.random_state,
            mesh_shape=config.mesh_shape,
            solver=config.solver,
            verbose=config.verbose,
            device=config.device,
        )

    def _fit(self, dataset: Dataset) -> None:
        refuse_mesh(self.mesh_shape)
        ui_csr = dataset.get_user_item_matrix(include_weights=True)
        self.user_factors, self.item_factors = truncated_svd(
            ui_csr,
            self.factors,
            tol=self.tol,
            maxiter=self.maxiter,
            random_state=self.random_state,
            solver=self.solver,
            device=self.device,
        )

    def _get_users_factors(self, dataset: Dataset) -> Factors:
        return Factors(self.user_factors)

    def _get_items_factors(self, dataset: Dataset) -> Factors:
        return Factors(self.item_factors)

    def get_vectors(self) -> tp.Tuple[np.ndarray, np.ndarray]:
        """User and item embeddings, shapes (n_users, factors) / (n_items, factors)."""
        if not self.is_fitted:
            raise NotFittedError(self.__class__.__name__)
        return self.user_factors, self.item_factors
