"""Random recommendation model: the port of rectools_tpu/models/random.py
(reference rectools/models/random.py:61).

Random ranking runs on the model's ``device`` through the masked top-k path of
``ops/topk.py`` (``random_rank_topk``: iid U[0, 1) scores, the seen and
whitelist masks, then the grouped top-k). Scores are descending integers
n_reco..1 per user, as in the reference.

The draws come from a ``torch.Generator`` on the model's device, seeded with
``random_state`` (0 when None) at construction and again in ``fit``; every
recommend call advances it, as the JAX model splits its key. A generator
cannot reproduce JAX's keys, and a CPU model draws other numbers than a CUDA
one: the same ``random_state`` repeats on one device.
"""

import typing as tp

import numpy as np
import torch
import typing_extensions as tpe

from ..dataset import Dataset
from ..ops.topk import random_rank_topk, uniform_draws
from ..utils.device import resolve_device
from .base import ModelBase, ModelConfig


class RandomModelConfig(ModelConfig):
    """Config for `RandomModel`."""

    random_state: tp.Optional[int] = None
    device: str = "cuda"


class RandomModel(ModelBase[RandomModelConfig]):
    """Uniform random recommendations over the item catalog (or whitelist)."""

    recommends_for_warm = False
    recommends_for_cold = True

    config_class = RandomModelConfig

    def __init__(self, random_state: tp.Optional[int] = None, verbose: int = 0, device: str = "cuda"):
        super().__init__(verbose=verbose)
        self.random_state = random_state
        self.device = device
        self._generator = self._seeded_generator()
        self.all_item_ids: np.ndarray

    def _seeded_generator(self) -> torch.Generator:
        generator = torch.Generator(device=resolve_device(self.device))
        return generator.manual_seed(self.random_state if self.random_state is not None else 0)

    def _get_config(self) -> RandomModelConfig:
        return RandomModelConfig(
            cls=self.__class__, random_state=self.random_state, verbose=self.verbose, device=self.device
        )

    @classmethod
    def _from_config(cls, config: RandomModelConfig) -> tpe.Self:
        return cls(random_state=config.random_state, verbose=config.verbose, device=config.device)

    def _fit(self, dataset: Dataset) -> None:
        self.all_item_ids = dataset.item_id_map.internal_ids
        self._generator = self._seeded_generator()

    def _rank(
        self,
        subject_ids: np.ndarray,
        k: int,
        filter_csr: tp.Any,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return random_rank_topk(
            uniform_draws(self._generator),
            n_objects=len(self.all_item_ids),
            subject_ids=subject_ids,
            k=k,
            filter_pairs_csr=filter_csr,
            sorted_object_whitelist=sorted_item_ids_to_recommend,
            device=self.device,
        )

    def _recommend_u2i(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        filter_viewed: bool,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        filter_csr = dataset.get_user_item_matrix(include_weights=False)[user_ids] if filter_viewed else None
        return self._rank(user_ids, k, filter_csr, sorted_item_ids_to_recommend)

    def _recommend_i2i(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._recommend_u2i(target_ids, dataset, k, False, sorted_item_ids_to_recommend)

    def _recommend_cold(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        subj_pos, obj, scores = self._rank(np.arange(len(target_ids)), k, None, sorted_item_ids_to_recommend)
        return np.asarray(target_ids)[subj_pos], obj, scores
