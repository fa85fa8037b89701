"""LiGR transformer layers (eSASRec) — gated Pre-LN blocks with a SwiGLU FFN.

Port of rectools_tpu/models/nn/transformers/ligr.py (LiGR: arXiv
2502.03417). eSASRec is ``SASRecModel(transformer_layers_type=LiGRLayers,
loss="sampled_softmax")``. The blocks run on the port's kernels as every
other stack does: LayerNorm (kernels 1, 4) and attention (kernels 2, 5).
"""

import typing as tp

import torch
from torch import nn

from ..dropout import HashDropout
from ..norm import FusedLayerNorm
from .net_blocks import MultiHeadAttention, TransformerLayersBase, init_feed_forward


class LiGRLayer(nn.Module):
    """Pre-LN block whose MHA and FFN residuals are each gated by
    ``sigmoid(gating_linear_i(seqs))`` (reference ligr.py:25-107)."""

    def __init__(
        self,
        n_factors: int,
        n_heads: int,
        dropout_rate: float,
        ff_factors_multiplier: int = 4,
        bias_in_ff: bool = False,
        ff_activation: str = "swiglu",
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.layer_norm_1 = FusedLayerNorm(n_factors, device=device)
        self.multi_head_attn = MultiHeadAttention(n_factors, n_heads, dropout_rate, device=device)
        self.gating_linear_1 = nn.Linear(n_factors, n_factors, device=device)
        self.layer_norm_2 = FusedLayerNorm(n_factors, device=device)
        self.feed_forward = init_feed_forward(
            n_factors, ff_factors_multiplier, dropout_rate, ff_activation, bias_in_ff, device=device
        )
        self.gating_linear_2 = nn.Linear(n_factors, n_factors, device=device)
        self.attn_dropout = HashDropout(dropout_rate)
        self.ff_dropout = HashDropout(dropout_rate)

    def forward(self, seqs: torch.Tensor, attn_bias: tp.Optional[torch.Tensor]) -> torch.Tensor:
        mha_input = self.layer_norm_1(seqs)
        mha_output = self.multi_head_attn(mha_input, mha_input, mha_input, attn_bias)
        seqs = seqs + torch.sigmoid(self.gating_linear_1(seqs)) * self.attn_dropout(mha_output)
        ff_output = self.feed_forward(self.layer_norm_2(seqs))
        return seqs + torch.sigmoid(self.gating_linear_2(seqs)) * self.ff_dropout(ff_output)


class LiGRLayers(TransformerLayersBase):
    """LiGR stack (reference ligr.py:110-191)."""

    def __init__(
        self,
        n_blocks: int,
        n_factors: int,
        n_heads: int,
        dropout_rate: float,
        ff_factors_multiplier: int = 4,
        ff_activation: str = "swiglu",
        bias_in_ff: bool = False,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            LiGRLayer(
                n_factors, n_heads, dropout_rate, ff_factors_multiplier, bias_in_ff, ff_activation, device=device
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
        for block in self.blocks:
            seqs = block(seqs, attn_bias)
        return seqs
