"""DSSM two-tower model on the device: the port of rectools_tpu/models/nn/dssm.py.

Behavioral parity with reference rectools/models/nn/dssm.py:54-411: ItemNet =
residual MLP over item features; UserNet = feature tower + interactions tower
concatenated; triplet margin loss (euclidean) on sampled positives vs uniform
negatives; inference materializes user/item vectors then EUCLIDEAN VectorModel
ranking (kernel 3 through ``TorchRanker``); warm targets supported through
features. JAX's jitted Adam step over dense minibatches is one autograd step
and ``torch.optim.Adam(weight_decay=...)``, which adds the decay to the
gradient before the moments as optax's ``chain(add_decayed_weights, adam)``
does.

The batches are JAX's bit for bit: the same numpy generator, seeded with
``random_state``, draws the same sample, permutations, positives and
negatives. The initial weights are flax's distribution (``lecun_normal``: a
normal truncated at two standard deviations, std sqrt(1 / fan_in) / 0.8796)
drawn from a ``torch.Generator`` on the model's device, so the card, the CPU
and JAX start elsewhere; ``models/convert.py`` ``load_jax_dssm_params`` takes
JAX's. A pickle holds the weights as CPU tensors and loads them onto the
config's ``device``.
"""

import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
import typing_extensions as tpe
from torch import nn

from ...dataset import Dataset
from ...dataset.dssm_datasets import DSSMItemDataset, DSSMTrainDataset, DSSMUserDataset
from ...exceptions import NotFittedError
from ...utils.device import full_f32_matmul, host_to_device, resolve_device
from ..base import ModelConfig
from ..rank import Distance
from ..vector import Factors, VectorModel

# flax's truncated_normal initializer: the std of a unit normal cut at +-2
_TRUNCATED_NORMAL_STD = 0.87962566103423978


class ItemTower(nn.Module):
    """Residual MLP over item features (reference dssm.py:54-73)."""

    def __init__(self, n_item_features: int, n_factors: int) -> None:
        super().__init__()
        self.embedding_layer = nn.Linear(n_item_features, n_factors, bias=False)
        self.dense_layer = nn.Linear(n_factors, n_factors, bias=False)
        self.output_layer = nn.Linear(n_factors, n_factors, bias=False)

    def forward(self, item_features: torch.Tensor) -> torch.Tensor:
        emb = F.elu(self.embedding_layer(item_features))
        features = F.elu(self.dense_layer(emb))
        return self.output_layer(emb + features)


class UserTower(nn.Module):
    """Feature tower + interactions tower, concatenated (reference dssm.py:76-101)."""

    def __init__(self, n_user_features: int, n_items: int, n_factors: int) -> None:
        super().__init__()
        self.embedding_features_layer = nn.Linear(n_user_features, n_factors, bias=False)
        self.embedding_interactions_layer = nn.Linear(n_items, n_factors, bias=False)
        self.features_dense_layer = nn.Linear(n_factors, n_factors, bias=False)
        self.output_layer = nn.Linear(2 * n_factors, n_factors, bias=False)

    def forward(self, user_features: torch.Tensor, interactions: torch.Tensor) -> torch.Tensor:
        features_emb = F.elu(self.embedding_features_layer(user_features))
        interactions_emb = F.elu(self.embedding_interactions_layer(interactions))
        features_dense = F.elu(self.features_dense_layer(features_emb))
        return self.output_layer(torch.cat((features_emb + features_dense, interactions_emb), dim=1))


class DSSMTowers(nn.Module):
    """Both towers under one parameter tree (flax's ``user_net`` / ``item_net``)."""

    def __init__(self, n_user_features: int, n_items: int, n_item_features: int, n_factors: int) -> None:
        super().__init__()
        self.user_net = UserTower(n_user_features, n_items, n_factors)
        self.item_net = ItemTower(n_item_features, n_factors)

    def forward(
        self, user_features: torch.Tensor, interactions: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor
    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.user_net(user_features, interactions), self.item_net(pos), self.item_net(neg)

    def encode_users(self, user_features: torch.Tensor, interactions: torch.Tensor) -> torch.Tensor:
        return self.user_net(user_features, interactions)

    def encode_items(self, item_features: torch.Tensor) -> torch.Tensor:
        return self.item_net(item_features)

    @classmethod
    def from_state(cls, state: tp.Mapping[str, torch.Tensor], device: torch.device) -> "DSSMTowers":
        """Towers with ``state``'s weights on ``device``; the widths are read
        off the weights."""
        n_factors, n_user_features = state["user_net.embedding_features_layer.weight"].shape
        n_items = state["user_net.embedding_interactions_layer.weight"].shape[1]
        n_item_features = state["item_net.embedding_layer.weight"].shape[1]
        towers = cls(n_user_features, n_items, n_item_features, n_factors)
        towers.load_state_dict(state)
        return towers.to(device)


def init_towers(towers: DSSMTowers, generator: torch.Generator) -> DSSMTowers:
    """flax ``Dense``'s default kernel init (``lecun_normal``) for every layer,
    from ``generator``, layer by layer in parameter order."""
    with torch.no_grad():
        for weight in towers.parameters():
            std = math.sqrt(1.0 / weight.shape[1]) / _TRUNCATED_NORMAL_STD
            nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    return towers


def triplet_margin_loss(
    anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor, margin: float, mask: torch.Tensor
) -> torch.Tensor:
    """Euclidean triplet margin loss, masked mean, as JAX writes it:
    sqrt(sum((a - p)^2) + 1e-6) (``F.triplet_margin_loss`` puts its eps
    elsewhere)."""
    eps = 1e-6
    d_pos = torch.sqrt(torch.sum((anchor - positive) ** 2, dim=1) + eps)
    d_neg = torch.sqrt(torch.sum((anchor - negative) ** 2, dim=1) + eps)
    gap = d_pos - d_neg + margin
    per = torch.maximum(gap, torch.zeros_like(gap))  # jnp.maximum's gradient at a tie: half to each side
    return torch.sum(per * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class DSSMModelConfig(ModelConfig):
    """Config for `DSSMModel`."""

    n_factors: int = 128
    max_epochs: int = 5
    batch_size: int = 128
    lr: float = 0.01
    triplet_loss_margin: float = 0.4
    weight_decay: float = 1e-6
    random_state: int = 0
    device: str = "cuda"


class DSSMModel(VectorModel[DSSMModelConfig]):
    """Two-tower DSSM recommender (triplet loss, euclidean ranking)."""

    recommends_for_warm = True
    recommends_for_cold = False

    u2i_dist = Distance.EUCLIDEAN
    i2i_dist = Distance.EUCLIDEAN

    config_class = DSSMModelConfig

    def __init__(
        self,
        n_factors: int = 128,
        max_epochs: int = 5,
        batch_size: int = 128,
        lr: float = 0.01,
        triplet_loss_margin: float = 0.4,
        weight_decay: float = 1e-6,
        random_state: int = 0,
        verbose: int = 0,
        train_dataset_type: tp.Type[DSSMTrainDataset] = DSSMTrainDataset,
        user_dataset_type: tp.Type[DSSMUserDataset] = DSSMUserDataset,
        item_dataset_type: tp.Type[DSSMItemDataset] = DSSMItemDataset,
        device: str = "cuda",
    ) -> None:
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.n_factors = n_factors
        self.max_epochs = max_epochs
        self.batch_size = batch_size
        self.lr = lr
        self.triplet_loss_margin = triplet_loss_margin
        self.weight_decay = weight_decay
        self.random_state = random_state
        self.train_dataset_type = train_dataset_type
        self.user_dataset_type = user_dataset_type
        self.item_dataset_type = item_dataset_type
        self._towers: tp.Optional[DSSMTowers] = None
        self.train_loss_history: tp.List[float] = []

    def _get_config(self) -> DSSMModelConfig:
        return DSSMModelConfig(
            cls=self.__class__,
            n_factors=self.n_factors,
            max_epochs=self.max_epochs,
            batch_size=self.batch_size,
            lr=self.lr,
            triplet_loss_margin=self.triplet_loss_margin,
            weight_decay=self.weight_decay,
            random_state=self.random_state,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: DSSMModelConfig) -> tpe.Self:
        params = config.model_dump()
        params.pop("cls")
        return cls(**params)

    @property
    def towers(self) -> DSSMTowers:
        if self._towers is None:
            raise NotFittedError(self.__class__.__name__)
        return self._towers

    # ----------------------------------------------------------------------- fit

    def _fit(self, dataset: Dataset, dataset_valid: tp.Optional[Dataset] = None) -> None:
        if dataset.user_features is None or dataset.item_features is None:
            raise ValueError("DSSM model requires user and item features to be present in the dataset.")
        dev = resolve_device(self.device)
        train_data = self.train_dataset_type.from_dataset(dataset)
        # per-epoch mean triplet loss, the convergence evidence
        self.train_loss_history = []

        rng_np = np.random.default_rng(self.random_state)
        # the draws of JAX's init sample, so that the batches below are JAX's
        uf, inter, pos, _ = train_data.make_batch(np.arange(min(2, len(train_data))), rng_np)
        towers = DSSMTowers(uf.shape[1], inter.shape[1], pos.shape[1], self.n_factors).to(dev)
        init_towers(towers, torch.Generator(device=dev).manual_seed(self.random_state))
        self._towers = towers
        optimizer = torch.optim.Adam(towers.parameters(), lr=self.lr, weight_decay=self.weight_decay)

        n = len(train_data)
        bs = min(self.batch_size, max(n, 1))
        for epoch in range(self.max_epochs):
            order = rng_np.permutation(n)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            n_steps = 0
            for start in range(0, n, bs):
                rows = order[start : start + bs]
                b = len(rows)
                if b < bs:
                    rows = np.concatenate([rows, np.zeros(bs - b, dtype=rows.dtype)])
                batch = [host_to_device(x, dev) for x in train_data.make_batch(rows, rng_np)]
                mask = np.zeros(bs, dtype=np.float32)
                mask[:b] = 1.0
                optimizer.zero_grad(set_to_none=True)
                with full_f32_matmul():
                    anchor, positive, negative = towers(*batch)
                    loss = triplet_margin_loss(anchor, positive, negative, self.triplet_loss_margin,
                                               host_to_device(mask, dev))
                    loss.backward()
                optimizer.step()
                loss_sum += loss.detach()
                n_steps += 1
            if n_steps:
                self.train_loss_history.append(float(loss_sum) / n_steps)  # one host sync an epoch
                if self.verbose > 0:
                    print(f"epoch {epoch + 1}: loss={self.train_loss_history[-1]:.5f}")

    # --------------------------------------------------------------------factors

    def get_vectors(self, dataset: Dataset) -> tp.Tuple[np.ndarray, np.ndarray]:
        """Materialized user and item tower outputs (reference dssm.py:372-378)."""
        if not self.is_fitted:
            raise NotFittedError(self.__class__.__name__)
        return self._get_users_factors(dataset).embeddings, self._get_items_factors(dataset).embeddings

    def _encode(self, encode: tp.Callable[..., torch.Tensor], data: tp.Any) -> np.ndarray:
        """``encode`` over ``data``'s dense rows in batches of ``batch_size``,
        every batch queued before the one fetch."""
        dev = resolve_device(self.device)
        out = []
        with torch.no_grad(), full_f32_matmul():
            for start in range(0, len(data), self.batch_size):
                rows = data.dense_rows(np.arange(start, min(start + self.batch_size, len(data))))
                rows = rows if isinstance(rows, tuple) else (rows,)
                out.append(encode(*(host_to_device(x, dev) for x in rows)))
        return torch.cat(out).cpu().numpy()

    def _get_users_factors(self, dataset: Dataset) -> Factors:
        return Factors(self._encode(self.towers.encode_users, self.user_dataset_type.from_dataset(dataset)))

    def _get_items_factors(self, dataset: Dataset) -> Factors:
        return Factors(self._encode(self.towers.encode_items, self.item_dataset_type.from_dataset(dataset)))

    # ------------------------------------------------------------------ warm

    def _recommend_u2i_warm(
        self,
        user_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._recommend_u2i(user_ids, dataset, k, False, sorted_item_ids_to_recommend)

    def _recommend_i2i_warm(
        self,
        target_ids: np.ndarray,
        dataset: Dataset,
        k: int,
        sorted_item_ids_to_recommend: tp.Optional[np.ndarray],
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._recommend_i2i(target_ids, dataset, k, sorted_item_ids_to_recommend)

    # ------------------------------------------------------------------ pickle

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        towers = state.pop("_towers")
        state["_tower_weights"] = None if towers is None else {
            k: v.detach().cpu() for k, v in towers.state_dict().items()
        }
        return state

    def __setstate__(self, state: dict) -> None:
        weights = state.pop("_tower_weights")
        self.__dict__.update(state)
        self._towers = None if weights is None else DSSMTowers.from_state(weights, resolve_device(self.device))
