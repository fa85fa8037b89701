"""HSTU: pointwise-aggregated attention with relative time/position biases.

Port of rectools_tpu/models/nn/transformers/hstu.py (original paper arXiv
2402.17152). The STU block replaces softmax attention with
SiLU(qk + rel_bias) / L and multiplicative causal/timeline masking; the fused
uvqk projection is one matrix product. The attention goes through
``ops/stu_attention.py``: its CUDA kernels for a CUDA tensor at every shape
and with either mask (causal, shared by the batch, or with key padding, one
per row), its plain twins for a CPU tensor. Both LayerNorms are the port's
``FusedLayerNorm``. Under bf16 compute the layer rounds where the JAX
package's layer does on its TPU route: u, v, q, k once after the f32 SiLU,
the attention output as ``_stu_reference`` returns it (bf16).
"""

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.stu_attention import stu_dot_product_attention
from ..dropout import HashDropout
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
    CallbacksCallable,
    InitKwargs,
    TransformerDataPreparatorType,
    TransformerLayersType,
    TransformerModelBase,
    TransformerModelConfig,
    ValMaskCallable,
)
from .data_preparator import TransformerDataPreparatorBase
from .negative_sampler import CatalogUniformSampler, TransformerNegativeSamplerBase
from .net_blocks import MASK_VALUE, LearnableInversePositionalEncoding, PositionalEncodingBase, TransformerLayersBase
from .sasrec import SASRecDataPreparator
from .similarity import DistanceSimilarityModule, SimilarityModuleBase
from .training import TransformerTrainingModule, TransformerTrainingModuleBase

TABLE_INIT_STD = 0.02


class RelativeAttentionBias(nn.Module):
    """The two relative-bias tables (reference hstu.py:47-153):
    ``time_weights`` (num_buckets + 1,), looked up by the log bucket of a
    timestamp difference, and ``pos_weights`` (2L − 1,), by the position
    difference. The attention op consumes the raw vectors."""

    def __init__(
        self,
        session_max_len: int,
        relative_time_attention: bool,
        relative_pos_attention: bool,
        num_buckets: int = 128,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.num_buckets = num_buckets
        if relative_time_attention:
            self.time_weights = nn.Parameter(torch.empty(num_buckets + 1, device=device))
        if relative_pos_attention:
            self.pos_weights = nn.Parameter(torch.empty(2 * session_max_len - 1, device=device))
        self.reset_tables()

    def reset_tables(self, generator: tp.Optional[torch.Generator] = None) -> None:
        """N(0, 0.02) for both tables, drawn on the CPU from ``generator``."""
        with torch.no_grad():
            for table in self.parameters():
                table.copy_(torch.randn(table.shape, generator=generator) * TABLE_INIT_STD)

    def weight_vectors(self) -> tp.Tuple[tp.Optional[torch.Tensor], tp.Optional[torch.Tensor]]:
        """(time_weights, pos_weights); None where the bias is off."""
        return getattr(self, "time_weights", None), getattr(self, "pos_weights", None)


class STULayer(nn.Module):
    """HSTU encoder block (reference hstu.py:156-299)."""

    def __init__(
        self,
        n_factors: int,
        n_heads: int,
        linear_hidden_dim: int,
        attention_dim: int,
        session_max_len: int,
        relative_time_attention: bool,
        relative_pos_attention: bool,
        attn_dropout_rate: float,
        dropout_rate: float,
        epsilon: float,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.linear_hidden_dim = linear_hidden_dim
        self.attention_dim = attention_dim
        self.relative_time_attention = relative_time_attention
        hidden, attn = linear_hidden_dim * n_heads, attention_dim * n_heads
        self.norm_input = FusedLayerNorm(n_factors, epsilon=epsilon, device=device)
        # one raw (in, out) matrix for u, v, q and k, as the JAX module keeps it
        self.uvqk_proj = nn.Parameter(torch.empty(n_factors, 2 * hidden + 2 * attn, device=device))
        nn.init.xavier_uniform_(self.uvqk_proj)
        self.rel_attn = RelativeAttentionBias(
            session_max_len, relative_time_attention, relative_pos_attention, device=device
        )
        self.attn_dropout = HashDropout(attn_dropout_rate)
        self.norm_attn_output = FusedLayerNorm(hidden, epsilon=epsilon, device=device)
        self.dropout = HashDropout(dropout_rate)
        self.output_mlp = nn.Linear(hidden, n_factors, device=device)

    def forward(
        self,
        seqs: torch.Tensor,  # (B, L, D)
        batch: tp.Dict[str, torch.Tensor],
        attn_allowed: torch.Tensor,  # (B|1, 1, L, L) float 0/1
        timeline_mask: torch.Tensor,  # (B, L, 1) float
    ) -> torch.Tensor:
        b, l, _ = seqs.shape
        h, lh, ad = self.n_heads, self.linear_hidden_dim, self.attention_dim
        normed_x = self.norm_input(seqs) * timeline_mask
        # the product summed in f32 and the SiLU in f32, then the working precision (JAX hstu.py:147-149): under
        # bf16 compute u, v, q, k are bf16, rounded once; under f32 the casts are no-ops
        transformed = F.silu(torch.matmul(normed_x.float(), self.uvqk_proj.float())).to(seqs.dtype)
        u, v, q, k = torch.split(transformed, [lh * h, lh * h, ad * h, ad * h], dim=-1)

        tw, pw = self.rel_attn.weight_vectors()
        ts = None
        if self.relative_time_attention:
            # (B, L + 1) timestamps incl. the target time; the last one again for the op's (B, L + 2)
            ts = torch.cat([batch["unix_ts"], batch["unix_ts"][:, -1:]], dim=1)
        attn_output = stu_dot_product_attention(
            q.view(b, l, h, ad), k.view(b, l, h, ad), v.view(b, l, h, lh), ts, timeline_mask[:, :, 0],
            attn_allowed[:, 0], tw, pw, self.rel_attn.num_buckets,
        ).reshape(b, l, h * lh)
        attn_output = self.attn_dropout(attn_output)

        o_input = u * self.norm_attn_output(attn_output) * timeline_mask
        return self.output_mlp(self.dropout(o_input)) + seqs


class STULayers(TransformerLayersBase):
    """Stacked STU blocks (reference hstu.py:302-399)."""

    def __init__(
        self,
        n_blocks: int,
        n_factors: int,
        n_heads: int,
        linear_hidden_dim: int,
        attention_dim: int,
        session_max_len: int,
        relative_time_attention: bool,
        relative_pos_attention: bool,
        dropout_rate: float = 0.2,
        attn_dropout_rate: float = 0.0,
        epsilon: float = 1e-6,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            STULayer(
                n_factors, n_heads, linear_hidden_dim, attention_dim, session_max_len, relative_time_attention,
                relative_pos_attention, attn_dropout_rate, dropout_rate, epsilon, device=device,
            )
            for _ in range(n_blocks)
        )

    def forward(
        self,
        seqs: torch.Tensor,
        timeline_mask: torch.Tensor,
        attn_bias: tp.Optional[torch.Tensor],
        batch: tp.Dict[str, torch.Tensor],
    ) -> torch.Tensor:
        l = seqs.shape[1]
        if attn_bias is None:
            attn_allowed = torch.ones((1, 1, l, l), dtype=seqs.dtype, device=seqs.device)
        else:
            # additive bias -> multiplicative 0/1 mask: STU attention is not a
            # softmax, masking is by multiplication
            attn_allowed = (attn_bias > MASK_VALUE / 2).to(seqs.dtype)
        for block in self.blocks:
            seqs = block(seqs * timeline_mask, batch, attn_allowed, timeline_mask)
        return seqs * timeline_mask

    def reinit_vectors(self, generator: torch.Generator) -> None:
        for block in self.blocks:
            block.rel_attn.reset_tables(generator)


class HSTUModelConfig(TransformerModelConfig):
    """HSTU model config."""

    data_preparator_type: TransformerDataPreparatorType = SASRecDataPreparator
    transformer_layers_type: TransformerLayersType = STULayers
    use_causal_attn: bool = True
    relative_time_attention: bool = True
    relative_pos_attention: bool = True


class HSTUModel(TransformerModelBase[HSTUModelConfig]):
    """HSTU sequential recommender (arXiv 2402.17152; reference
    hstu.py:402-729), trained and served on the GPU. Cosine similarity and the
    scaled positional encoding are its defaults; with time attention its
    batches carry ``unix_ts`` and ``recommend`` needs a context. ``device``
    defaults to ``"cuda"``; ``device="cpu"`` runs the kernels' plain twins."""

    config_class = HSTUModelConfig

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
        relative_time_attention: bool = True,
        relative_pos_attention: bool = True,
        item_net_block_types: tp.Sequence[tp.Type[ItemNetBase]] = (IdEmbeddingsItemNet, CatFeaturesItemNet),
        item_net_constructor_type: tp.Type[ItemNetConstructorBase] = SumOfEmbeddingsConstructor,
        pos_encoding_type: tp.Type[PositionalEncodingBase] = LearnableInversePositionalEncoding,
        transformer_layers_type: tp.Type[TransformerLayersBase] = STULayers,
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
        self.relative_time_attention = relative_time_attention
        self.relative_pos_attention = relative_pos_attention
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

    def _init_transformer_layers(self) -> TransformerLayersBase:
        head_dim = self.n_factors // self.n_heads
        return self.transformer_layers_type(
            n_blocks=self.n_blocks,
            n_factors=self.n_factors,
            n_heads=self.n_heads,
            session_max_len=self.session_max_len,
            attention_dim=head_dim,
            linear_hidden_dim=head_dim,
            dropout_rate=self.dropout_rate,
            relative_time_attention=self.relative_time_attention,
            relative_pos_attention=self.relative_pos_attention,
            device=self._device,
            **self._get_kwargs(self.transformer_layers_kwargs),
        )

    def _data_preparator_extra_kwargs(self) -> InitKwargs:
        kwargs = dict(super()._data_preparator_extra_kwargs())
        if self.relative_time_attention:
            kwargs["add_unix_ts"] = True
        return kwargs

    def _init_similarity_module(self) -> SimilarityModuleBase:
        similarity_module_kwargs = dict(self._get_kwargs(self.similarity_module_kwargs))
        similarity_module_kwargs.setdefault("distance", "cosine")
        return self.similarity_module_type(**similarity_module_kwargs)

    def _init_pos_encoding_layer(self) -> PositionalEncodingBase:
        pos_encoding_kwargs = dict(self._get_kwargs(self.pos_encoding_kwargs))
        pos_encoding_kwargs.setdefault("use_scale_factor", True)
        return self.pos_encoding_type(
            self.use_pos_emb, self.session_max_len, self.n_factors, device=self._device, **pos_encoding_kwargs
        )

    @property
    def require_recommend_context(self) -> bool:
        """Time-aware inference needs per-user context timestamps
        (reference hstu.py:719-729)."""
        return self.relative_time_attention
