"""BERT4Rec: masked-item objective + bidirectional attention.

Port of rectools_tpu/models/nn/transformers/bert4rec.py: the MLM train
collation (one vectorised 80/10/10 draw over the batch's tokens, from the
loader's numpy ``rng`` in the JAX package's call order, so the batches equal
the JAX package's), the validation and recommend collations (MASK appended),
the config and the model. The item table carries two extra tokens, PAD and
MASK; neither is recommended, drawn as a negative or drawn as a random item.
The encoder is the Pre-LN stack with a key-padding mask and no causal mask,
so the attention kernels take a per-batch (B, 1, L, L) bias.
"""

import typing as tp
from collections.abc import Hashable

import numpy as np

from ..item_net import (
    CatFeaturesItemNet,
    IdEmbeddingsItemNet,
    ItemNetBase,
    ItemNetConstructorBase,
    SumOfEmbeddingsConstructor,
)
from .backbone import TransformerBackbone, TransformerBackboneBase
from .base import (
    CallbacksCallable,
    InitKwargs,
    TransformerDataPreparatorType,
    TransformerModelBase,
    TransformerModelConfig,
    ValMaskCallable,
)
from .constants import MASKING_VALUE, PADDING_VALUE
from .data_preparator import Batch, SequenceDataset, TransformerDataPreparatorBase, scatter_left_padded
from .negative_sampler import CatalogUniformSampler, TransformerNegativeSamplerBase
from .net_blocks import (
    LearnableInversePositionalEncoding,
    PositionalEncodingBase,
    PreLNTransformerLayers,
    TransformerLayersBase,
)
from .similarity import DistanceSimilarityModule, SimilarityModuleBase
from .training import TransformerTrainingModule, TransformerTrainingModuleBase


class BERT4RecDataPreparator(TransformerDataPreparatorBase):
    """MLM collation (reference bert4rec.py:51-193)."""

    train_session_max_len_addition: int = 0
    item_extra_tokens: tp.Sequence[Hashable] = (PADDING_VALUE, MASKING_VALUE)

    def __init__(
        self,
        session_max_len: int,
        batch_size: int,
        train_min_user_interactions: int = 2,
        negative_sampler: tp.Optional[TransformerNegativeSamplerBase] = None,
        n_negatives: tp.Optional[int] = None,
        mask_prob: float = 0.15,
        get_val_mask_func: tp.Optional[ValMaskCallable] = None,
        shuffle_train: bool = True,
        get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None,
        **kwargs: tp.Any,
    ) -> None:
        super().__init__(
            session_max_len=session_max_len,
            batch_size=batch_size,
            train_min_user_interactions=train_min_user_interactions,
            get_val_mask_func=get_val_mask_func,
            shuffle_train=shuffle_train,
            n_negatives=n_negatives,
            negative_sampler=negative_sampler,
            get_val_mask_func_kwargs=get_val_mask_func_kwargs,
            **kwargs,
        )
        self.mask_prob = mask_prob

    def _mask_tokens(
        self, tokens: np.ndarray, rng: np.random.Generator, first_border: float = 0.8, second_border: float = 0.9
    ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """80/10/10 MLM masking (reference bert4rec.py:109-127): a masked
        token becomes MASK (80%), a random item (10%) or stays (10%); the
        target is the original item at masked positions, 0 elsewhere."""
        probs = rng.random(len(tokens))
        masked = probs < self.mask_prob
        sub = probs / self.mask_prob  # uniform on [0, 1) given masked
        to_mask_token = masked & (sub < first_border)
        to_random = masked & (sub >= first_border) & (sub < second_border)
        x = tokens.copy()
        x[to_mask_token] = self.extra_token_ids[MASKING_VALUE]
        if to_random.any():
            x[to_random] = rng.integers(self.n_item_extra_tokens, self.item_id_map.size, size=int(to_random.sum()))
        return x, np.where(masked, tokens, 0)

    @staticmethod
    def _flat_rows(dataset: SequenceDataset, rows: np.ndarray) -> tp.Tuple[np.ndarray, np.ndarray]:
        """Flat indices of the rows' interactions, session by session, and the
        sessions' lengths."""
        starts = dataset.indptr[rows]
        lengths = dataset.lengths[rows]
        within = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
        return np.repeat(starts, lengths) + within, lengths

    def _collate_fn_train(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        if rng is None:  # pragma: no cover
            raise ValueError("BERT4Rec train collate requires rng")
        flat_idx, lengths = self._flat_rows(dataset, rows)
        x_flat, y_flat = self._mask_tokens(dataset.items[flat_idx], rng)
        flat_starts = np.cumsum(lengths) - lengths
        x = scatter_left_padded(x_flat, flat_starts, lengths, self.session_max_len, np.int64)
        y = scatter_left_padded(y_flat, flat_starts, lengths, self.session_max_len, np.int64)
        yw = scatter_left_padded(dataset.weights[flat_idx], flat_starts, lengths, self.session_max_len, np.float32)
        batch: Batch = {"x": x, "y": y, "yw": yw}
        self._sample_negatives(batch, rng)
        return batch

    def _with_mask_token(self, values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
        """Each row's values with MASK appended, right-aligned into
        (n, session_max_len): the last session_max_len of each row kept."""
        ext_vals = np.concatenate([values, np.full(n, self.extra_token_ids[MASKING_VALUE], dtype=np.int64)])
        ext_seg = np.concatenate([seg, np.arange(n)])
        order = np.argsort(ext_seg, kind="stable")  # history first, MASK last per row
        return self._ragged_right_align(ext_vals[order], ext_seg[order], n, self.session_max_len, np.int64)

    def _collate_fn_val(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        """History + MASK; target = first weighted row (reference bert4rec.py:146-175)."""
        input_flat, input_seg, y_vals, yw_vals, _ = self._val_inputs_targets(dataset, rows)
        batch: Batch = {
            "x": self._with_mask_token(dataset.items[input_flat].astype(np.int64), input_seg, len(rows)),
            "y": y_vals.reshape(-1, 1).astype(np.int64),
            "yw": yw_vals.reshape(-1, 1).astype(np.float32),
        }
        self._sample_negatives(batch, rng, session_len_limit=1)
        return batch

    def _collate_fn_recommend(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        """Session + MASK, right-truncated to session_max_len (reference bert4rec.py:177-193)."""
        flat_idx, lengths = self._flat_rows(dataset, rows)
        seg = np.repeat(np.arange(len(rows)), lengths)
        return {"x": self._with_mask_token(dataset.items[flat_idx].astype(np.int64), seg, len(rows))}


class BERT4RecModelConfig(TransformerModelConfig):
    """BERT4RecModel config."""

    data_preparator_type: TransformerDataPreparatorType = BERT4RecDataPreparator
    use_key_padding_mask: bool = True
    mask_prob: float = 0.15


class BERT4RecModel(TransformerModelBase[BERT4RecModelConfig]):
    """BERT4Rec sequential recommender (arXiv 1904.06690) with swappable
    losses and components, trained and served on the GPU (reference
    bert4rec.py:196-452). ``device`` defaults to ``"cuda"`` and construction
    raises when no card is present; ``device="cpu"`` runs the kernels' plain
    twins."""

    config_class = BERT4RecModelConfig

    def __init__(
        self,
        n_blocks: int = 2,
        n_heads: int = 4,
        n_factors: int = 256,
        dropout_rate: float = 0.2,
        mask_prob: float = 0.15,
        session_max_len: int = 100,
        train_min_user_interactions: int = 2,
        loss: str = "softmax",
        n_negatives: int = 1,
        gbce_t: float = 0.2,
        lr: float = 0.001,
        batch_size: int = 128,
        epochs: int = 3,
        deterministic: bool = False,
        seed: int = 0,
        verbose: int = 0,
        use_pos_emb: bool = True,
        use_key_padding_mask: bool = True,
        use_causal_attn: bool = False,
        item_net_block_types: tp.Sequence[tp.Type[ItemNetBase]] = (IdEmbeddingsItemNet, CatFeaturesItemNet),
        item_net_constructor_type: tp.Type[ItemNetConstructorBase] = SumOfEmbeddingsConstructor,
        pos_encoding_type: tp.Type[PositionalEncodingBase] = LearnableInversePositionalEncoding,
        transformer_layers_type: tp.Type[TransformerLayersBase] = PreLNTransformerLayers,
        data_preparator_type: tp.Type[TransformerDataPreparatorBase] = BERT4RecDataPreparator,
        training_module_type: tp.Type[TransformerTrainingModuleBase] = TransformerTrainingModule,
        negative_sampler_type: tp.Type[TransformerNegativeSamplerBase] = CatalogUniformSampler,
        similarity_module_type: tp.Type[SimilarityModuleBase] = DistanceSimilarityModule,
        backbone_type: tp.Type[TransformerBackboneBase] = TransformerBackbone,
        get_val_mask_func: tp.Optional[ValMaskCallable] = None,
        get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None,
        get_callbacks_func: tp.Optional[CallbacksCallable] = None,
        recommend_batch_size: tp.Optional[int] = None,
        data_preparator_kwargs: tp.Optional[InitKwargs] = None,
        transformer_layers_kwargs: tp.Optional[InitKwargs] = None,
        item_net_constructor_kwargs: tp.Optional[InitKwargs] = None,
        pos_encoding_kwargs: tp.Optional[InitKwargs] = None,
        training_module_kwargs: tp.Optional[InitKwargs] = None,
        negative_sampler_kwargs: tp.Optional[InitKwargs] = None,
        similarity_module_kwargs: tp.Optional[InitKwargs] = None,
        backbone_kwargs: tp.Optional[InitKwargs] = None,
        device: str = "cuda",
    ):
        self.mask_prob = mask_prob  # read by _init_data_preparator, which the base's __init__ calls
        super().__init__(
            data_preparator_type=data_preparator_type,
            transformer_layers_type=transformer_layers_type,
            n_blocks=n_blocks,
            n_heads=n_heads,
            n_factors=n_factors,
            use_pos_emb=use_pos_emb,
            use_causal_attn=use_causal_attn,
            use_key_padding_mask=use_key_padding_mask,
            dropout_rate=dropout_rate,
            session_max_len=session_max_len,
            batch_size=batch_size,
            loss=loss,
            n_negatives=n_negatives,
            gbce_t=gbce_t,
            lr=lr,
            epochs=epochs,
            verbose=verbose,
            deterministic=deterministic,
            seed=seed,
            recommend_batch_size=recommend_batch_size,
            train_min_user_interactions=train_min_user_interactions,
            item_net_block_types=item_net_block_types,
            item_net_constructor_type=item_net_constructor_type,
            pos_encoding_type=pos_encoding_type,
            training_module_type=training_module_type,
            negative_sampler_type=negative_sampler_type,
            similarity_module_type=similarity_module_type,
            backbone_type=backbone_type,
            get_val_mask_func=get_val_mask_func,
            get_val_mask_func_kwargs=get_val_mask_func_kwargs,
            get_callbacks_func=get_callbacks_func,
            data_preparator_kwargs=data_preparator_kwargs,
            transformer_layers_kwargs=transformer_layers_kwargs,
            item_net_constructor_kwargs=item_net_constructor_kwargs,
            pos_encoding_kwargs=pos_encoding_kwargs,
            training_module_kwargs=training_module_kwargs,
            negative_sampler_kwargs=negative_sampler_kwargs,
            similarity_module_kwargs=similarity_module_kwargs,
            backbone_kwargs=backbone_kwargs,
            device=device,
        )

    def _data_preparator_extra_kwargs(self) -> InitKwargs:
        return {"mask_prob": self.mask_prob, **super()._data_preparator_extra_kwargs()}
