"""Transformer building blocks — port of
rectools_tpu/models/nn/transformers/net_blocks.py (the SASRec serving path).

Attention masks are additive float biases (``MASK_VALUE``, finite, never
-inf), so fully-masked rows stay NaN-free. The modules here are forward-only
for serving: in training mode a positive dropout rate raises in the attention
wrapper (dropout and the backward kernels come with the training slice).
"""

import typing as tp

import torch
from torch import nn

from ....ops.attention import dot_product_attention

MASK_VALUE = -1e9  # additive attention-bias "minus infinity"


class MultiHeadAttention(nn.Module):
    """Multi-head attention with an additive bias; projections ``q_proj``,
    ``k_proj``, ``v_proj``, ``out_proj`` as in the JAX module."""

    def __init__(
        self, n_factors: int, n_heads: int, dropout_rate: float, device: tp.Optional[torch.device] = None
    ) -> None:
        super().__init__()
        self.n_factors = n_factors
        self.n_heads = n_heads
        self.dropout_rate = dropout_rate
        self.q_proj = nn.Linear(n_factors, n_factors, device=device)
        self.k_proj = nn.Linear(n_factors, n_factors, device=device)
        self.v_proj = nn.Linear(n_factors, n_factors, device=device)
        self.out_proj = nn.Linear(n_factors, n_factors, device=device)

    def forward(
        self,
        query: torch.Tensor,  # (B, L, D)
        key: torch.Tensor,
        value: torch.Tensor,
        attn_bias: tp.Optional[torch.Tensor],  # (B|1, 1, L, L) additive
    ) -> torch.Tensor:
        b, l, _ = query.shape
        head_dim = self.n_factors // self.n_heads
        q = self.q_proj(query).view(b, l, self.n_heads, head_dim)
        k = self.k_proj(key).view(b, l, self.n_heads, head_dim)
        v = self.v_proj(value).view(b, l, self.n_heads, head_dim)
        scale = 1.0 / float(head_dim) ** 0.5
        rate = self.dropout_rate if self.training else 0.0
        out = dot_product_attention(q, k, v, attn_bias, scale, dropout_rate=rate)
        return self.out_proj(out.reshape(b, l, self.n_factors))


class PointWiseFeedForward(nn.Module):
    """Two-layer FFN (reference net_blocks.py:21-65)."""

    def __init__(
        self,
        n_factors: int,
        n_factors_ff: int,
        dropout_rate: float,
        activation: tp.Callable[[torch.Tensor], torch.Tensor],
        use_bias: bool = True,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.ff_linear_1 = nn.Linear(n_factors, n_factors_ff, bias=use_bias, device=device)
        self.ff_linear_2 = nn.Linear(n_factors_ff, n_factors, bias=use_bias, device=device)
        self.activation = activation

    def forward(self, seqs: torch.Tensor) -> torch.Tensor:
        return self.ff_linear_2(self.activation(self.ff_linear_1(seqs)))


class TransformerLayersBase(nn.Module):
    """Base class for transformer layer stacks.

    Contract (reference net_blocks.py:154-185): ``forward(seqs, timeline_mask,
    attn_bias, batch)`` where ``timeline_mask`` is the float (B, L, 1)
    non-padding indicator and ``attn_bias`` the merged additive bias (or None).
    """

    def forward(
        self,
        seqs: torch.Tensor,
        timeline_mask: torch.Tensor,
        attn_bias: tp.Optional[torch.Tensor],
        batch: tp.Dict[str, torch.Tensor],
    ) -> torch.Tensor:
        raise NotImplementedError()


class PositionalEncodingBase(nn.Module):
    """Base class for positional encodings."""

    def forward(self, sessions: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError()


class LearnableInversePositionalEncoding(PositionalEncodingBase):
    """Learnable embeddings indexed by inverse positions L-1..0, so left-padded
    sessions align on the distance from their end (reference
    net_blocks.py:346-401)."""

    def __init__(
        self,
        use_pos_emb: bool,
        session_max_len: int,
        n_factors: int,
        use_scale_factor: bool = False,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.use_pos_emb = use_pos_emb
        self.use_scale_factor = use_scale_factor
        if use_pos_emb:
            self.pos_emb = nn.Parameter(torch.randn(session_max_len, n_factors, device=device))

    def forward(self, sessions: torch.Tensor) -> torch.Tensor:
        _, session_max_len, n_factors = sessions.shape
        if self.use_scale_factor:
            sessions = sessions * (n_factors**0.5)
        if self.use_pos_emb:
            positions = torch.arange(session_max_len - 1, -1, -1, device=sessions.device)
            sessions = sessions + self.pos_emb[positions][None, :, :]
        return sessions
