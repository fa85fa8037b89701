"""BPR model: the port of rectools_tpu/models/bpr.py (reference
rectools/models/implicit_bpr.py:98-284).

Factors include the bias fold-in exactly as the reference exposes them:
user vectors get a fixed ones column, item vectors get the bias column
(implicit_bpr.py:222-232); DOT for u2i, COSINE for i2i. The fit runs on the
model's ``device`` (ops/bpr.py); its permutation and negatives come from a
``torch.Generator`` seeded with ``random_state`` at every fit, so a fit
repeats on one device, while the card, the CPU and JAX draw different numbers.
"""

import typing as tp

import numpy as np
import typing_extensions as tpe

from ..dataset import Dataset
from ..exceptions import NotFittedError
from ..ops.bpr import bpr_fit
from ..utils.device import resolve_device
from .base import ModelConfig
from .rank import Distance
from .vector import Factors, VectorModel


class BPRModelConfig(ModelConfig):
    """Config for `BPRModel`."""

    factors: int = 100
    learning_rate: float = 0.01
    regularization: float = 0.01
    iterations: int = 100
    verify_negative_samples: bool = True
    random_state: tp.Optional[int] = None
    batch_size: int = 8192
    device: str = "cuda"


class BPRModel(VectorModel[BPRModelConfig]):
    """Bayesian Personalized Ranking MF trained with device minibatch SGD."""

    recommends_for_warm = False
    recommends_for_cold = False

    u2i_dist = Distance.DOT
    i2i_dist = Distance.COSINE

    config_class = BPRModelConfig

    def __init__(
        self,
        factors: int = 100,
        learning_rate: float = 0.01,
        regularization: float = 0.01,
        iterations: int = 100,
        verify_negative_samples: bool = True,
        random_state: tp.Optional[int] = None,
        batch_size: int = 8192,
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.factors = factors
        self.learning_rate = learning_rate
        self.regularization = regularization
        self.iterations = iterations
        self.verify_negative_samples = verify_negative_samples
        self.random_state = random_state
        self.batch_size = batch_size
        self.user_embeddings: np.ndarray
        self.item_embeddings: np.ndarray
        self.item_biases: np.ndarray

    def _get_config(self) -> BPRModelConfig:
        return BPRModelConfig(
            cls=self.__class__,
            factors=self.factors,
            learning_rate=self.learning_rate,
            regularization=self.regularization,
            iterations=self.iterations,
            verify_negative_samples=self.verify_negative_samples,
            random_state=self.random_state,
            batch_size=self.batch_size,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: BPRModelConfig) -> tpe.Self:
        return cls(
            factors=config.factors,
            learning_rate=config.learning_rate,
            regularization=config.regularization,
            iterations=config.iterations,
            verify_negative_samples=config.verify_negative_samples,
            random_state=config.random_state,
            batch_size=config.batch_size,
            verbose=config.verbose,
            device=config.device,
        )

    def _train(self, dataset: Dataset, iterations: int,
               initial: tp.Optional[tp.Tuple[np.ndarray, np.ndarray, np.ndarray]]) -> None:
        self.user_embeddings, self.item_embeddings, self.item_biases = bpr_fit(
            dataset.get_user_item_matrix(include_weights=True),
            factors=self.factors,
            learning_rate=self.learning_rate,
            regularization=self.regularization,
            iterations=iterations,
            random_state=self.random_state,
            verify_negative_samples=self.verify_negative_samples,
            batch_size=self.batch_size,
            initial=initial,
            device=self.device,
        )

    def _fit(self, dataset: Dataset) -> None:
        self._train(dataset, self.iterations, None)

    def _fit_partial(self, dataset: Dataset, epochs: int) -> None:
        initial = (self.user_embeddings, self.item_embeddings, self.item_biases) if self.is_fitted else None
        self._train(dataset, epochs, initial)

    def _get_users_factors(self, dataset: Dataset) -> Factors:
        return Factors(self.user_embeddings, np.ones(len(self.user_embeddings), dtype=np.float32))

    def _get_items_factors(self, dataset: Dataset) -> Factors:
        return Factors(self.item_embeddings, self.item_biases)

    def get_vectors(self, add_biases: bool = True) -> tp.Tuple[np.ndarray, np.ndarray]:
        """User/item vectors; biases folded as extra columns when requested
        (reference implicit_bpr.py bias-column convention)."""
        if not self.is_fitted:
            raise NotFittedError(self.__class__.__name__)
        if not add_biases:
            return self.user_embeddings, self.item_embeddings
        users = np.hstack([np.ones((len(self.user_embeddings), 1), dtype=np.float32), self.user_embeddings])
        items = np.hstack([self.item_biases[:, None], self.item_embeddings])
        return users, items
