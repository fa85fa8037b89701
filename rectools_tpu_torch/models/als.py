"""iALS matrix factorization on the device: the port of
rectools_tpu/models/als.py (reference rectools/models/implicit_als.py:101-675).

Same training math and feature semantics; the per-row least-squares solver is
the batched solve of ops/als.py on the model's ``device``:

- plain iALS: confidence = alpha * weight, Cholesky LS alternation
- `fit_features_together=True`: factor blocks
  [user explicit | latent | paired-to-item-explicit] x
  [paired-to-user-explicit | latent | item explicit], explicit blocks reset
  after each half-step (reference implicit_als.py:584-628)
- `fit_features_together=False`: plain ALS on latents, then one paired
  half-step per feature block vs the fixed feature matrices, hstack
  (reference implicit_als.py:331-422)
- `fit_partial(epochs)` resumes from current factors
  (reference implicit_als.py:240-248).

The initial latents are the JAX package's numpy draws, so a fit starts from
JAX's factors. ``mesh_shape`` stays in the config, so JAX configs load;
fitting with it set raises (not ported).
"""

import typing as tp

import numpy as np
import typing_extensions as tpe
from scipy import sparse

from ..dataset import Dataset, Features
from ..exceptions import NotFittedError
from ..ops.als import als_fit, als_half_step
from ..ops.linalg import refuse_mesh
from ..utils.device import resolve_device
from .base import ModelConfig
from .rank import Distance
from .vector import Factors, VectorModel


class ALSModelConfig(ModelConfig):
    """Config for `ALSModel`."""

    factors: int = 100
    regularization: float = 0.01
    alpha: float = 1.0
    iterations: int = 15
    random_state: tp.Optional[int] = None
    fit_features_together: bool = False
    mesh_shape: tp.Optional[tp.Tuple[int, int]] = None
    device: str = "cuda"


class ALSModel(VectorModel[ALSModelConfig]):
    """Implicit-feedback Alternating Least Squares with optional explicit features.

    Equivalent of the reference `ImplicitALSWrapperModel` (the wrapped solver
    is built in, so the constructor takes hyperparameters directly).
    """

    recommends_for_warm = False
    recommends_for_cold = False

    u2i_dist = Distance.DOT
    i2i_dist = Distance.COSINE

    config_class = ALSModelConfig

    def __init__(
        self,
        factors: int = 100,
        regularization: float = 0.01,
        alpha: float = 1.0,
        iterations: int = 15,
        random_state: tp.Optional[int] = None,
        fit_features_together: bool = False,
        mesh_shape: tp.Optional[tp.Tuple[int, int]] = None,
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.factors = factors
        self.regularization = regularization
        self.alpha = alpha
        self.iterations = iterations
        self.random_state = random_state
        self.fit_features_together = fit_features_together
        self.mesh_shape = tuple(mesh_shape) if mesh_shape is not None else None
        self.user_factors: np.ndarray
        self.item_factors: np.ndarray
        self._fitted_epochs = 0

    def _get_config(self) -> ALSModelConfig:
        return ALSModelConfig(
            cls=self.__class__,
            factors=self.factors,
            regularization=self.regularization,
            alpha=self.alpha,
            iterations=self.iterations,
            random_state=self.random_state,
            fit_features_together=self.fit_features_together,
            mesh_shape=self.mesh_shape,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: ALSModelConfig) -> tpe.Self:
        return cls(
            factors=config.factors,
            regularization=config.regularization,
            alpha=config.alpha,
            iterations=config.iterations,
            random_state=config.random_state,
            fit_features_together=config.fit_features_together,
            mesh_shape=config.mesh_shape,
            verbose=config.verbose,
            device=config.device,
        )

    # ------------------------------------------------------------------- fit

    def _init_latent(self, n_users: int, n_items: int) -> tp.Tuple[np.ndarray, np.ndarray]:
        """Same init convention as the implicit CPU library
        (reference implicit_als.py:425-440): U(0, 0.01) latents, JAX's draws."""
        rng = np.random.RandomState(self.random_state)
        u = (rng.random((n_users, self.factors)) * 0.01).astype(np.float32)
        i = (rng.random((n_items, self.factors)) * 0.01).astype(np.float32)
        return u, i

    @staticmethod
    def _features_dense(features: tp.Optional[Features], n: int) -> np.ndarray:
        if features is None:
            return np.zeros((n, 0), dtype=np.float32)
        return np.asarray(features.get_dense(), dtype=np.float32)

    def _fit(self, dataset: Dataset) -> None:
        self._fitted_epochs = 0
        self._fit_epochs(dataset, self.iterations, fresh=True)
        self._fitted_epochs = self.iterations

    def _fit_partial(self, dataset: Dataset, epochs: int) -> None:
        fresh = not self.is_fitted
        self._fit_epochs(dataset, epochs, fresh=fresh)
        self._fitted_epochs = (0 if fresh else self._fitted_epochs) + epochs

    def _fit_epochs(self, dataset: Dataset, epochs: int, fresh: bool) -> None:
        refuse_mesh(self.mesh_shape)
        ui_csr = dataset.get_user_item_matrix(include_weights=True).astype(np.float32)
        user_features = dataset.get_hot_user_features()
        item_features = dataset.get_hot_item_features()

        if self.fit_features_together and (user_features is not None or item_features is not None):
            self._fit_together(ui_csr, user_features, item_features, epochs, fresh)
        else:
            self._fit_separately(ui_csr, user_features, item_features, epochs, fresh)

    def _fit_together(
        self,
        ui_csr: sparse.csr_matrix,
        user_features: tp.Optional[Features],
        item_features: tp.Optional[Features],
        epochs: int,
        fresh: bool,
    ) -> None:
        n_users, n_items = ui_csr.shape
        user_explicit = self._features_dense(user_features, n_users)
        item_explicit = self._features_dense(item_features, n_items)
        n_uf, n_if = user_explicit.shape[1], item_explicit.shape[1]

        if fresh:
            u_lat, i_lat = self._init_latent(n_users, n_items)
            user_factors = np.hstack(
                (user_explicit, u_lat, np.zeros((n_users, n_if), dtype=np.float32))
            ).astype(np.float32)
            item_factors = np.hstack(
                (np.zeros((n_items, n_uf), dtype=np.float32), i_lat, item_explicit)
            ).astype(np.float32)
        else:
            user_factors = self.user_factors.copy()
            item_factors = self.item_factors.copy()

        n_total = user_factors.shape[1]
        conf_csr = (self.alpha * ui_csr).tocsr()
        self.user_factors, self.item_factors = als_fit(
            conf_csr,
            user_factors,
            item_factors,
            self.regularization,
            epochs,
            user_reset_cols=(0, n_uf),
            user_reset_values=user_explicit,
            item_reset_cols=(n_total - n_if, n_total),
            item_reset_values=item_explicit,
            device=self.device,
        )

    def _fit_separately(
        self,
        ui_csr: sparse.csr_matrix,
        user_features: tp.Optional[Features],
        item_features: tp.Optional[Features],
        epochs: int,
        fresh: bool,
    ) -> None:
        n_users, n_items = ui_csr.shape
        if fresh or not hasattr(self, "user_factors"):
            u_lat, i_lat = self._init_latent(n_users, n_items)
        else:
            # Keep only the latent block when refitting (reference :355-358).
            u_lat = self.user_factors[:, : self.factors].copy()
            i_lat = self.item_factors[:, : self.factors].copy()

        conf_csr = (self.alpha * ui_csr).tocsr()
        u_lat, i_lat = als_fit(conf_csr, u_lat, i_lat, self.regularization, epochs, device=self.device)

        user_chunks = [u_lat]
        item_chunks = [i_lat]
        iu_csr = conf_csr.T.tocsr(copy=False)

        if user_features is not None:
            user_feature_factors = self._features_dense(user_features, n_users)
            item_paired = als_half_step(iu_csr, user_feature_factors, self.regularization, device=self.device)
            user_chunks.append(user_feature_factors)
            item_chunks.append(item_paired)
        if item_features is not None:
            item_feature_factors = self._features_dense(item_features, n_items)
            user_paired = als_half_step(conf_csr, item_feature_factors, self.regularization, device=self.device)
            item_chunks.append(item_feature_factors)
            user_chunks.append(user_paired)

        self.user_factors = np.hstack(user_chunks).astype(np.float32)
        self.item_factors = np.hstack(item_chunks).astype(np.float32)

    # -------------------------------------------------------------- factors

    def _get_users_factors(self, dataset: Dataset) -> Factors:
        return Factors(self.user_factors)

    def _get_items_factors(self, dataset: Dataset) -> Factors:
        return Factors(self.item_factors)

    def get_vectors(self) -> tp.Tuple[np.ndarray, np.ndarray]:
        """User and item embeddings (incl. feature blocks if fitted with features)."""
        if not self.is_fitted:
            raise NotFittedError(self.__class__.__name__)
        return self.user_factors, self.item_factors
