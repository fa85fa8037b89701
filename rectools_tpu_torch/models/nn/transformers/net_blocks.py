"""Transformer building blocks — port of
rectools_tpu/models/nn/transformers/net_blocks.py: multi-head attention, the
feed-forwards (ReLU, exact GELU, SwiGLU), the Pre-LN block and stack (the
BERT4Rec default) and the positional encoding.

Attention masks are additive float biases (``MASK_VALUE``, finite, never
-inf), so fully-masked rows stay NaN-free. In training mode the attention
draws its dropout seed from the training module's generator and applies the
counter-hash dropout inside the kernel; the FFNs apply :class:`HashDropout`
to their inner activations.
"""

import typing as tp
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.attention import dot_product_attention
from ..dropout import HashDropout, draw_attention_seed, scalar_in, shifted_attention_seed
from ..norm import FusedLayerNorm

MASK_VALUE = -1e9  # additive attention-bias "minus infinity"

# exact (erf) GELU, as the JAX package's ``_exact_gelu``
_exact_gelu = partial(F.gelu, approximate="none")


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
        self.dropout_generator: tp.Optional[torch.Generator] = None  # see dropout.attach_generator
        self.batch_offset = 0  # see dropout.set_batch_offset

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
        seed = None
        if rate > 0.0:
            seed = shifted_attention_seed(draw_attention_seed(self.dropout_generator), self.batch_offset, self.n_heads)
        out = dot_product_attention(q, k, v, attn_bias, scale, dropout_rate=rate, dropout_seed=seed)
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
        self.dropout = HashDropout(dropout_rate)

    def forward(self, seqs: torch.Tensor) -> torch.Tensor:
        return self.ff_linear_2(self.dropout(self.activation(self.ff_linear_1(seqs))))


class SwigluFeedForward(nn.Module):
    """SwiGLU FFN (reference net_blocks.py:68-110): ``ff_linear_2(dropout(
    silu(ff_linear_1(x)) * ff_linear_3(x)))``."""

    def __init__(
        self,
        n_factors: int,
        n_factors_ff: int,
        dropout_rate: float,
        use_bias: bool = True,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.ff_linear_1 = nn.Linear(n_factors, n_factors_ff, bias=use_bias, device=device)
        self.ff_linear_3 = nn.Linear(n_factors, n_factors_ff, bias=use_bias, device=device)
        self.ff_linear_2 = nn.Linear(n_factors_ff, n_factors, bias=use_bias, device=device)
        self.dropout = HashDropout(dropout_rate)

    def forward(self, seqs: torch.Tensor) -> torch.Tensor:
        output = F.silu(self.ff_linear_1(seqs)) * self.ff_linear_3(seqs)
        return self.ff_linear_2(self.dropout(output))


def init_feed_forward(
    n_factors: int,
    ff_factors_multiplier: int,
    dropout_rate: float,
    ff_activation: str,
    use_bias: bool = True,
    device: tp.Optional[torch.device] = None,
) -> nn.Module:
    """FFN factory: "swiglu" / "relu" / "gelu" (reference net_blocks.py:113-151)."""
    n_factors_ff = n_factors * ff_factors_multiplier
    if ff_activation == "swiglu":
        return SwigluFeedForward(n_factors, n_factors_ff, dropout_rate, use_bias, device=device)
    if ff_activation == "gelu":
        return PointWiseFeedForward(n_factors, n_factors_ff, dropout_rate, _exact_gelu, use_bias, device=device)
    if ff_activation == "relu":
        return PointWiseFeedForward(n_factors, n_factors_ff, dropout_rate, torch.relu, use_bias, device=device)
    raise ValueError(f"Unsupported ff_activation: {ff_activation}")


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

    def reinit_vectors(self, generator: torch.Generator) -> None:
        """Redraw the stack's one-dimensional parameters that are not biases or
        LayerNorm parameters, on the CPU from ``generator``. The training
        module calls it after the Xavier re-init, which leaves such vectors
        alone, so that the seed fixes them too. A stack without any does
        nothing."""


class PreLNTransformerLayer(nn.Module):
    """Pre-LN block (reference net_blocks.py:188-261): LayerNorm before the
    attention and before the GELU FFN, dropped-out residuals, and a dropout
    of the block's output."""

    def __init__(
        self,
        n_factors: int,
        n_heads: int,
        dropout_rate: float,
        ff_factors_multiplier: int = 4,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.layer_norm_1 = FusedLayerNorm(n_factors, device=device)
        self.multi_head_attn = MultiHeadAttention(n_factors, n_heads, dropout_rate, device=device)
        self.layer_norm_2 = FusedLayerNorm(n_factors, device=device)
        self.feed_forward = PointWiseFeedForward(
            n_factors, n_factors * ff_factors_multiplier, dropout_rate, _exact_gelu, device=device
        )
        self.attn_dropout = HashDropout(dropout_rate)
        self.ff_dropout = HashDropout(dropout_rate)
        self.out_dropout = HashDropout(dropout_rate)

    def forward(self, seqs: torch.Tensor, attn_bias: tp.Optional[torch.Tensor]) -> torch.Tensor:
        mha_input = self.layer_norm_1(seqs)
        seqs = seqs + self.attn_dropout(self.multi_head_attn(mha_input, mha_input, mha_input, attn_bias))
        seqs = seqs + self.ff_dropout(self.feed_forward(self.layer_norm_2(seqs)))
        return self.out_dropout(seqs)


class PreLNTransformerLayers(TransformerLayersBase):
    """Pre-LN stack, the BERT4Rec default (reference net_blocks.py:264-335)."""

    def __init__(
        self,
        n_blocks: int,
        n_factors: int,
        n_heads: int,
        dropout_rate: float,
        ff_factors_multiplier: int = 4,
        device: tp.Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            PreLNTransformerLayer(n_factors, n_heads, dropout_rate, ff_factors_multiplier, device=device)
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
            sessions = sessions * scalar_in(n_factors**0.5, sessions.dtype)
        if self.use_pos_emb:
            positions = torch.arange(session_max_len - 1, -1, -1, device=sessions.device)
            sessions = sessions + self.pos_emb[positions][None, :, :]
        return sessions
