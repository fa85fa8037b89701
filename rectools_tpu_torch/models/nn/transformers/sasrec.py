"""SASRec: shifted-sequence objective + unidirectional attention.

Port of rectools_tpu/models/nn/transformers/sasrec.py, serving half: the
recommend collation, the SASRec blocks, the config and the model. Train and
validation collation come with the training slice.
"""

import typing as tp

import numpy as np
import torch
from torch import nn

from ..item_net import (
    CatFeaturesItemNet,
    IdEmbeddingsItemNet,
    ItemNetBase,
    ItemNetConstructorBase,
    SumOfEmbeddingsConstructor,
)
from ..norm import FusedLayerNorm
from .backbone import TransformerBackbone, TransformerBackboneBase
from .base import (
    InitKwargs,
    TransformerDataPreparatorType,
    TransformerLayersType,
    TransformerModelBase,
    TransformerModelConfig,
    ValMaskCallable,
)
from .data_preparator import Batch, SequenceDataset, TransformerDataPreparatorBase, scatter_left_padded
from .net_blocks import (
    LearnableInversePositionalEncoding,
    MultiHeadAttention,
    PointWiseFeedForward,
    PositionalEncodingBase,
    TransformerLayersBase,
)
from .similarity import DistanceSimilarityModule, SimilarityModuleBase


class SASRecDataPreparator(TransformerDataPreparatorBase):
    """Shifted-sequence collation (reference sasrec.py:51-166)."""

    train_session_max_len_addition: int = 1

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

    def forward(self, seqs: torch.Tensor, attn_bias: tp.Optional[torch.Tensor]) -> torch.Tensor:
        q = self.q_layer_norm(seqs)
        seqs = q + self.multi_head_attn(q, seqs, seqs, attn_bias)
        ff_input = self.ff_layer_norm(seqs)
        return self.feed_forward(ff_input) + ff_input


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
    """SASRec sequential recommender (arXiv 1808.09781), serving on the GPU.

    ``fit`` raises until the training slice is ported; load weights trained by
    the JAX package with :meth:`load_jax_params`. ``device`` defaults to
    ``"cuda"`` and construction raises when no card is present.
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
        similarity_module_type: tp.Type[SimilarityModuleBase] = DistanceSimilarityModule,
        backbone_type: tp.Type[TransformerBackboneBase] = TransformerBackbone,
        get_val_mask_func: tp.Optional[ValMaskCallable] = None,
        get_val_mask_func_kwargs: tp.Optional[InitKwargs] = None,
        recommend_batch_size: tp.Optional[int] = None,
        data_preparator_kwargs: tp.Optional[InitKwargs] = None,
        transformer_layers_kwargs: tp.Optional[InitKwargs] = None,
        item_net_constructor_kwargs: tp.Optional[InitKwargs] = None,
        pos_encoding_kwargs: tp.Optional[InitKwargs] = None,
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
            similarity_module_type=similarity_module_type,
            backbone_type=backbone_type,
            get_val_mask_func=get_val_mask_func,
            get_val_mask_func_kwargs=get_val_mask_func_kwargs,
            data_preparator_kwargs=data_preparator_kwargs,
            transformer_layers_kwargs=transformer_layers_kwargs,
            item_net_constructor_kwargs=item_net_constructor_kwargs,
            pos_encoding_kwargs=pos_encoding_kwargs,
            similarity_module_kwargs=similarity_module_kwargs,
            backbone_kwargs=backbone_kwargs,
            device=device,
        )
