"""SASRec: shifted-sequence objective + unidirectional attention.

Port of rectools_tpu/models/nn/transformers/sasrec.py: the train, validation
and recommend collations (the native host ops, or numpy scatters), the SASRec
blocks, the config and the model.
"""

import typing as tp

import numpy as np
import torch
from torch import nn

from .... import native as _native
from ..item_net import (
    CatFeaturesItemNet,
    IdEmbeddingsItemNet,
    ItemNetBase,
    ItemNetConstructorBase,
    SumOfEmbeddingsConstructor,
)
from ..dropout import HashDropout
from ..norm import FusedLayerNorm
from .backbone import TransformerBackbone, TransformerBackboneBase
from .base import (
    CallbacksCallable,
    InitKwargs,
    TransformerDataPreparatorType,
    TransformerLayersType,
    TransformerModelBase,
    TransformerModelConfig,
    ValMaskCallable,
)
from .data_preparator import Batch, SequenceDataset, TransformerDataPreparatorBase, scatter_left_padded
from .negative_sampler import CatalogUniformSampler, TransformerNegativeSamplerBase
from .net_blocks import (
    LearnableInversePositionalEncoding,
    MultiHeadAttention,
    PointWiseFeedForward,
    PositionalEncodingBase,
    TransformerLayersBase,
)
from .similarity import DistanceSimilarityModule, SimilarityModuleBase
from .training import TransformerTrainingModule, TransformerTrainingModuleBase


class SASRecDataPreparator(TransformerDataPreparatorBase):
    """Shifted-sequence collation (reference sasrec.py:51-166)."""

    train_session_max_len_addition: int = 1

    def _collate_fn_train(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        """x = session[:-1], y = session[1:], left-padded to session_max_len:
        one pass of the native host ops when they load, else three scatters."""
        starts = dataset.indptr[rows]
        lengths = dataset.lengths[rows]
        native = _native.sasrec_train_collate_native(
            dataset.items, dataset.weights, starts, lengths, self.session_max_len
        )
        if native is not None:
            x, y, yw = native
        else:
            m = lengths - 1  # shifted-pair count per session
            x = scatter_left_padded(dataset.items, starts, m, self.session_max_len, np.int64)
            y = scatter_left_padded(dataset.items, starts + 1, m, self.session_max_len, np.int64)
            yw = scatter_left_padded(dataset.weights, starts + 1, m, self.session_max_len, np.float32)
        batch: Batch = {"x": x, "y": y, "yw": yw}
        self._sample_negatives(batch, rng)
        if self.add_unix_ts:
            # (B, L+1): full session timestamps incl. the target, left-filled
            # with the first real value (reference sasrec.py:109-116)
            t = scatter_left_padded(dataset.extras["unix_ts"], starts, lengths, self.session_max_len + 1, np.int64)
            batch["unix_ts"] = self._left_fill_first_value(t, self.session_max_len + 1 - lengths)
        return batch

    def _collate_fn_val(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        """Input = weight-0 history rows; target = first weighted row
        (reference sasrec.py:119-148)."""
        input_flat, input_seg, y_vals, yw_vals, _ = self._val_inputs_targets(dataset, rows)
        x = self._ragged_right_align(dataset.items[input_flat], input_seg, len(rows), self.session_max_len, np.int64)
        batch: Batch = {
            "x": x,
            "y": y_vals.reshape(-1, 1).astype(np.int64),
            "yw": yw_vals.reshape(-1, 1).astype(np.float32),
        }
        self._sample_negatives(batch, rng, session_len_limit=1)
        if self.add_unix_ts:
            starts = dataset.indptr[rows]
            lengths = dataset.lengths[rows]
            t = scatter_left_padded(
                dataset.extras["unix_ts"], starts + 1, lengths - 1, self.session_max_len + 1, np.int64
            )
            batch["unix_ts"] = self._left_fill_first_value(t, self.session_max_len + 2 - lengths)
        return batch

    def _collate_fn_recommend(
        self, dataset: SequenceDataset, rows: np.ndarray, rng: tp.Optional[np.random.Generator]
    ) -> Batch:
        """Right truncation, left padding (reference sasrec.py:150-166)."""
        starts = dataset.indptr[rows]
        lengths = dataset.lengths[rows]
        if self.add_unix_ts:
            # Last session row is the appended context (PAD item) — drop it
            # from x, keep its timestamp as the target time.
            m = lengths - 1
            clipped = np.minimum(m, self.session_max_len)
            x = scatter_left_padded(dataset.items, starts + (m - clipped), clipped, self.session_max_len, np.int64)
            t_len = np.minimum(lengths, self.session_max_len + 1)
            t = scatter_left_padded(
                dataset.extras["unix_ts"], starts + (lengths - t_len), t_len, self.session_max_len + 1, np.int64
            )
            t = self._left_fill_first_value(t, self.session_max_len - clipped)
            return {"x": x, "unix_ts": t}
        clipped = np.minimum(lengths, self.session_max_len)
        x = scatter_left_padded(dataset.items, starts + (lengths - clipped), clipped, self.session_max_len, np.int64)
        return {"x": x}


class SASRecTransformerLayer(nn.Module):
    """SASRec authors' block (reference sasrec.py:169-230): query = LN(seqs),
    residual from the normalized query, FFN residual from its own input."""

    def __init__(
        self, n_factors: int, n_heads: int, dropout_rate: float, device: tp.Optional[torch.device] = None
    ) -> None:
        super().__init__()
        self.q_layer_norm = FusedLayerNorm(n_factors, device=device)
        self.multi_head_attn = MultiHeadAttention(n_factors, n_heads, dropout_rate, device=device)
        self.ff_layer_norm = FusedLayerNorm(n_factors, device=device)
        self.feed_forward = PointWiseFeedForward(n_factors, n_factors, dropout_rate, torch.relu, device=device)
        self.dropout = HashDropout(dropout_rate)

    def forward(self, seqs: torch.Tensor, attn_bias: tp.Optional[torch.Tensor]) -> torch.Tensor:
        q = self.q_layer_norm(seqs)
        seqs = q + self.multi_head_attn(q, seqs, seqs, attn_bias)
        ff_input = self.ff_layer_norm(seqs)
        return self.dropout(self.feed_forward(ff_input)) + ff_input


class SASRecTransformerLayers(TransformerLayersBase):
    """SASRec stack with timeline-mask multiplications between blocks and a
    final LayerNorm with eps 1e-8 (the blocks use 1e-6) (reference
    sasrec.py:233-304)."""

    def __init__(
        self,
        n_blocks: int,
        n_factors: int,
        n_heads: int,
        dropout_rate: float,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            SASRecTransformerLayer(n_factors, n_heads, dropout_rate, device=device) for _ in range(n_blocks)
        )
        self.last_layernorm = FusedLayerNorm(n_factors, epsilon=1e-8, device=device)

    def forward(
        self,
        seqs: torch.Tensor,
        timeline_mask: torch.Tensor,
        attn_bias: tp.Optional[torch.Tensor],
        batch: tp.Dict[str, torch.Tensor],
    ) -> torch.Tensor:
        for block in self.blocks:
            seqs = block(seqs * timeline_mask, attn_bias)
        return self.last_layernorm(seqs * timeline_mask)


class SASRecModelConfig(TransformerModelConfig):
    """SASRecModel config."""

    data_preparator_type: TransformerDataPreparatorType = SASRecDataPreparator
    transformer_layers_type: TransformerLayersType = SASRecTransformerLayers
    use_causal_attn: bool = True


class SASRecModel(TransformerModelBase[SASRecModelConfig]):
    """SASRec sequential recommender (arXiv 1808.09781) with swappable losses
    and components, trained and served on the GPU.

    ``fit`` trains with the port's kernels (the fused softmax-CE for the
    full-catalog loss); :meth:`load_jax_params` loads weights trained by the
    JAX package instead. ``device`` defaults to ``"cuda"`` and construction
    raises when no card is present; ``device="cpu"`` runs the kernels' plain
    twins.
    """

    config_class = SASRecModelConfig

    def __init__(
        self,
        n_blocks: int = 2,
        n_heads: int = 4,
        n_factors: int = 256,
        dropout_rate: float = 0.2,
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
        use_key_padding_mask: bool = False,
        use_causal_attn: bool = True,
        item_net_block_types: tp.Sequence[tp.Type[ItemNetBase]] = (IdEmbeddingsItemNet, CatFeaturesItemNet),
        item_net_constructor_type: tp.Type[ItemNetConstructorBase] = SumOfEmbeddingsConstructor,
        pos_encoding_type: tp.Type[PositionalEncodingBase] = LearnableInversePositionalEncoding,
        transformer_layers_type: tp.Type[TransformerLayersBase] = SASRecTransformerLayers,
        data_preparator_type: tp.Type[TransformerDataPreparatorBase] = SASRecDataPreparator,
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
