"""HybridMFModel — hybrid matrix factorization with user/item features: the
port of rectools_tpu/models/hybrid_mf.py, the framework's equivalent of the
reference's LightFM wrapper (rectools/models/lightfm.py:93-320).

Semantics preserved from the reference wrapper:
- features get an identity-block prefix (per-hot-entity one-hot + explicit
  features, lightfm.py:222-239), so entity repr = own latent vector + sum of
  feature vectors;
- DOT u2i ranking with biases folded into padded vectors (vector.py:105-134);
- warm AND cold targets supported: warm = feature-only representations,
  cold = item-bias ranking (lightfm.py:295-302);
- losses logistic / bpr / warp / warp-kos (ops/hybrid_mf.py);
- `fit_partial(epochs)` resumes training.

The step runs on the model's ``device`` (ops/hybrid_mf.py). The host loop
builds the batches as JAX does, with the same numpy ``SeedSequence``
permutations and k-OS draws, so the batches are JAX's bit for bit. The
initial tables and the negatives come from ``torch.Generator``s on the device
(seeded with ``random_state`` and ``random_state + 17``, where JAX seeds its
keys), so the card, the CPU and JAX draw different numbers and a fit repeats
on one device. ``params`` and the optimizer state stay host numpy arrays
between fits, so a pickle loads without a card. ``train_loss_history`` holds
each epoch's mean step loss.
"""

import typing as tp

import numpy as np
import torch
import typing_extensions as tpe
from scipy import sparse

from ..dataset import Dataset
from ..dataset.features import Features
from ..exceptions import NotFittedError
from ..ops import hybrid_mf as ops
from ..utils.device import host_to_device, resolve_device
from .base import FixedColdRecoModelMixin, ModelConfig
from .rank import Distance
from .utils import recommend_from_scores
from .vector import Factors, VectorModel

HybridMFLoss = tp.Literal["logistic", "bpr", "warp", "warp-kos"]


class HybridMFModelConfig(ModelConfig):
    """Config for `HybridMFModel` (field names follow LightFM's)."""

    no_components: int = 10
    loss: HybridMFLoss = "logistic"
    learning_schedule: tp.Literal["adagrad", "adadelta"] = "adagrad"
    learning_rate: float = 0.05
    rho: float = 0.95
    epsilon: float = 1e-6
    item_alpha: float = 0.0
    user_alpha: float = 0.0
    max_sampled: int = 10
    k: int = 5
    n: int = 10
    epochs: int = 1
    batch_size: int = 4096
    random_state: int = 0
    device: str = "cuda"


class HybridMFModel(FixedColdRecoModelMixin, VectorModel[HybridMFModelConfig]):
    """Hybrid MF with feature-summed embeddings (LightFM-equivalent)."""

    recommends_for_warm = True
    recommends_for_cold = True

    u2i_dist = Distance.DOT
    i2i_dist = Distance.COSINE

    config_class = HybridMFModelConfig

    def __init__(
        self,
        no_components: int = 10,
        loss: HybridMFLoss = "logistic",
        learning_schedule: tp.Literal["adagrad", "adadelta"] = "adagrad",
        learning_rate: float = 0.05,
        rho: float = 0.95,
        epsilon: float = 1e-6,
        item_alpha: float = 0.0,
        user_alpha: float = 0.0,
        max_sampled: int = 10,
        k: int = 5,
        n: int = 10,
        epochs: int = 1,
        batch_size: int = 4096,
        random_state: int = 0,
        verbose: int = 0,
        device: str = "cuda",
    ):
        super().__init__(verbose=verbose)
        resolve_device(device)
        self.device = device
        self.no_components = no_components
        self.loss = loss
        self.learning_schedule = learning_schedule
        self.learning_rate = learning_rate
        self.rho = rho
        self.epsilon = epsilon
        self.item_alpha = item_alpha
        self.user_alpha = user_alpha
        self.max_sampled = max_sampled
        self.k = k
        self.n = n
        self.epochs = epochs
        self.batch_size = batch_size
        self.random_state = random_state

        self.params: tp.Optional[tp.Dict[str, np.ndarray]] = None
        self._opt_state: tp.Optional[tp.Dict[str, tp.Dict[str, np.ndarray]]] = None
        self._epochs_trained = 0
        self.train_loss_history: tp.List[float] = []

    def _get_config(self) -> HybridMFModelConfig:
        return HybridMFModelConfig(
            cls=self.__class__,
            no_components=self.no_components,
            loss=self.loss,
            learning_schedule=self.learning_schedule,
            learning_rate=self.learning_rate,
            rho=self.rho,
            epsilon=self.epsilon,
            item_alpha=self.item_alpha,
            user_alpha=self.user_alpha,
            max_sampled=self.max_sampled,
            k=self.k,
            n=self.n,
            epochs=self.epochs,
            batch_size=self.batch_size,
            random_state=self.random_state,
            verbose=self.verbose,
            device=self.device,
        )

    @classmethod
    def _from_config(cls, config: HybridMFModelConfig) -> tpe.Self:
        params = config.model_dump()
        params.pop("cls")
        return cls(**params)

    # ------------------------------------------------------------------ features

    @staticmethod
    def _prepare_features(features: tp.Optional[Features], n_hot: int) -> sparse.csr_matrix:
        """[identity(n_hot) | explicit features] design matrix
        (reference lightfm.py:222-239). With no explicit features this is just
        the identity (plain MF)."""
        identity = sparse.identity(n_hot, dtype="float32", format="csr")
        if features is None:
            return identity
        features_csr = features.get_sparse().astype(np.float32)
        identity.resize(features_csr.shape[0], n_hot)
        return sparse.hstack((identity, features_csr), format="csr")

    # ----------------------------------------------------------------------- fit

    def _fit(self, dataset: Dataset) -> None:
        self.params = None
        self._opt_state = None
        self._epochs_trained = 0
        self.train_loss_history = []
        self._fit_partial(dataset, self.epochs)

    def _fit_partial(self, dataset: Dataset, epochs: tp.Optional[int] = None) -> None:
        if epochs is None:
            epochs = self.epochs
        dev = resolve_device(self.device)
        ui_coo = dataset.get_user_item_matrix(include_weights=True).tocoo(copy=False)
        user_design = self._prepare_features(dataset.get_hot_user_features(), dataset.n_hot_users)
        item_design = self._prepare_features(dataset.get_hot_item_features(), dataset.n_hot_items)
        n_items = item_design.shape[0]

        u_idx, u_val = ops.pad_feature_table(user_design)
        i_idx, i_val = ops.pad_feature_table(item_design)
        i_idx_dev = host_to_device(i_idx.astype(np.int64), dev)
        i_val_dev = host_to_device(i_val, dev)

        optimizer = ops.make_optimizer(self.learning_schedule, self.learning_rate, self.rho, self.epsilon)
        if self.params is None:
            generator = torch.Generator(device=dev).manual_seed(self.random_state)
            params = ops.init_params(user_design.shape[1], item_design.shape[1], self.no_components, generator)
            opt_state = optimizer.init(params)
        else:
            params = {k: host_to_device(v, dev) for k, v in self.params.items()}
            opt_state = {name: {k: host_to_device(v, dev) for k, v in slots.items()}
                         for name, slots in (self._opt_state or {}).items()}

        users = ui_coo.row.astype(np.int64)
        items = ui_coo.col.astype(np.int64)
        weights = ui_coo.data.astype(np.float32)
        n = len(users)
        bs = min(self.batch_size, max(n, 1))
        # per-user positive lists for k-OS sampling (LightFM's n draws)
        kos_csr = sparse.csr_matrix(ui_coo) if self.loss == "warp-kos" else None

        rng = np.random.default_rng(np.random.SeedSequence(entropy=(self.random_state, self._epochs_trained)))
        negatives = None
        if self.loss != "logistic":
            negatives = ops.negative_draws(torch.Generator(device=dev).manual_seed(self.random_state + 17),
                                           n_items, self.max_sampled)
        step = 0
        for _ in range(epochs):
            order = rng.permutation(n)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            n_steps = 0
            for start in range(0, n, bs):
                uf_idx, uf_val, batch_items, batch_weights = self._host_batch(
                    order[start : start + bs], bs, users, items, weights, u_idx, u_val, kos_csr, rng)
                params, opt_state, loss_val = ops.train_step(
                    params,
                    opt_state,
                    host_to_device(uf_idx, dev),
                    host_to_device(uf_val, dev),
                    i_idx_dev,
                    i_val_dev,
                    host_to_device(batch_items, dev),
                    host_to_device(batch_weights, dev),
                    None if negatives is None else negatives(step, bs).to(torch.int64),
                    loss=self.loss,
                    n_items=n_items,
                    optimizer=optimizer,
                    user_alpha=self.user_alpha,
                    item_alpha=self.item_alpha,
                    kos_k=self.k,
                )
                loss_sum += loss_val
                n_steps += 1
                step += 1
            self._epochs_trained += 1
            self.train_loss_history.append(float(loss_sum) / max(n_steps, 1))  # one host sync an epoch
            if self.verbose > 0:
                print(f"epoch {self._epochs_trained}: loss={self.train_loss_history[-1]:.5f}")

        self.params = {k: v.cpu().numpy() for k, v in params.items()}
        self._opt_state = {name: {k: v.cpu().numpy() for k, v in slots.items()} for name, slots in opt_state.items()}

    def _host_batch(
        self,
        rows: np.ndarray,
        bs: int,
        users: np.ndarray,
        items: np.ndarray,
        weights: np.ndarray,
        u_idx: np.ndarray,
        u_val: np.ndarray,
        kos_csr: tp.Optional[sparse.csr_matrix],
        rng: np.random.Generator,
    ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One batch on the host, padded to ``bs`` rows of weight 0: the
        users' feature rows, the positives (warp-kos: ``n`` draws with
        replacement from each row's user) and the weights; JAX's draws."""
        b = len(rows)
        batch_users = users[rows]
        if kos_csr is not None:
            batch_items = np.zeros((bs, self.n), dtype=np.int64)
            u = batch_users[:b]
            lengths = np.maximum(np.diff(kos_csr.indptr), 1)
            offsets = (rng.random((b, self.n)) * lengths[u][:, None]).astype(np.int64)
            batch_items[:b] = kos_csr.indices[kos_csr.indptr[u][:, None] + offsets]
        else:
            batch_items = np.zeros(bs, dtype=np.int64)
            batch_items[:b] = items[rows]
        batch_weights = np.zeros(bs, dtype=np.float32)
        batch_weights[:b] = weights[rows]
        uf_idx = np.zeros((bs, u_idx.shape[1]), dtype=np.int64)
        uf_val = np.zeros((bs, u_val.shape[1]), dtype=np.float32)
        uf_idx[:b] = u_idx[batch_users[:b]]
        uf_val[:b] = u_val[batch_users[:b]]
        return uf_idx, uf_val, batch_items, batch_weights

    # --------------------------------------------------------------------factors

    def _design_repr(self, design: sparse.csr_matrix, emb: np.ndarray, bias: np.ndarray) -> Factors:
        return Factors(embeddings=design @ emb, biases=design @ bias)

    def _get_users_factors(self, dataset: Dataset) -> Factors:
        design = self._prepare_features(dataset.user_features, dataset.n_hot_users)
        design = design[:, : self.params["user_emb"].shape[0]]
        return self._design_repr(design, self.params["user_emb"], self.params["user_bias"])

    def _get_items_factors(self, dataset: Dataset) -> Factors:
        design = self._prepare_features(dataset.item_features, dataset.n_hot_items)
        design = design[:, : self.params["item_emb"].shape[0]]
        return self._design_repr(design, self.params["item_emb"], self.params["item_bias"])

    def get_vectors(self, dataset: Dataset, add_biases: bool = True) -> tp.Tuple[np.ndarray, np.ndarray]:
        """User/item vectors; biases folded as 2 leading columns when requested
        (reference lightfm.py:252-293)."""
        if not self.is_fitted:
            raise NotFittedError(self.__class__.__name__)
        users = self._get_users_factors(dataset)
        items = self._get_items_factors(dataset)
        user_embeddings, item_embeddings = users.embeddings, items.embeddings
        if add_biases:
            user_embeddings = np.hstack(
                (users.biases[:, np.newaxis], np.ones((users.biases.size, 1)), user_embeddings)
            )
            item_embeddings = np.hstack(
                (np.ones((items.biases.size, 1)), items.biases[:, np.newaxis], item_embeddings)
            )
        return user_embeddings, item_embeddings

    # ---------------------------------------------------------------- warm/cold

    def _get_cold_reco(
        self, dataset: Dataset, k: int, sorted_item_ids_to_recommend: tp.Optional[np.ndarray]
    ) -> tp.Tuple[np.ndarray, np.ndarray]:
        all_scores = self._get_items_factors(dataset).biases
        return recommend_from_scores(all_scores, k, sorted_whitelist=sorted_item_ids_to_recommend)

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
