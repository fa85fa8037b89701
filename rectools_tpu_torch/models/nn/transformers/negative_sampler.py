"""Negative sampling for sampled losses.

Port of rectools_tpu/models/nn/transformers/negative_sampler.py: sampling
runs on host numpy from the training rng stream, so a fit is reproducible for
a fixed seed. The training module draws the default sampler's negatives on
the device instead (``hash_uniform_ints``), as the JAX package does.
"""

import typing as tp

import numpy as np


class TransformerNegativeSamplerBase:
    """Base class for negative samplers."""

    def __init__(self, n_negatives: int, **kwargs: tp.Any) -> None:
        self.n_negatives = n_negatives

    def get_negatives(
        self,
        batch: tp.Dict[str, np.ndarray],
        lowest_id: int,
        highest_id: int,
        rng: np.random.Generator,
        session_len_limit: tp.Optional[int] = None,
        **kwargs: tp.Any,
    ) -> np.ndarray:
        """Return (batch_size, session_len, n_negatives) sampled item ids."""
        raise NotImplementedError()


class CatalogUniformSampler(TransformerNegativeSamplerBase):
    """Uniform negatives over [lowest_id, highest_id)."""

    def get_negatives(
        self,
        batch: tp.Dict[str, np.ndarray],
        lowest_id: int,
        highest_id: int,
        rng: np.random.Generator,
        session_len_limit: tp.Optional[int] = None,
        **kwargs: tp.Any,
    ) -> np.ndarray:
        session_len = session_len_limit if session_len_limit is not None else batch["x"].shape[1]
        return rng.integers(
            low=lowest_id,
            high=highest_id,
            size=(batch["x"].shape[0], session_len, self.n_negatives),
            dtype=np.int64,
        )
