"""Transformer backbone: item embeddings + session encoding + similarity logits.

Port of rectools_tpu/models/nn/transformers/backbone.py. Masks are additive
float biases (see net_blocks.py) with the reference's rules:

- causal: strict upper triangle disallowed;
- key padding: padded keys disallowed;
- both: merged, and the diagonal force-enabled.
"""

import typing as tp

import torch
from torch import nn

from ..dropout import HashDropout
from ..item_net import ItemNetBase
from .net_blocks import MASK_VALUE, PositionalEncodingBase, TransformerLayersBase
from .similarity import SimilarityModuleBase


class TransformerBackboneBase(nn.Module):
    """Base class for transformer backbones."""

    def encode_sessions(self, batch: tp.Dict[str, torch.Tensor], item_embs: torch.Tensor) -> torch.Tensor:
        """Encode user sessions -> (B, L, D)."""
        raise NotImplementedError()

    def forward(
        self, batch: tp.Dict[str, torch.Tensor], candidate_item_ids: tp.Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Full-catalog logits (B, L, N), or candidate logits (B, L, C)."""
        raise NotImplementedError()


class TransformerBackbone(TransformerBackboneBase):
    """Default backbone (reference torch_backbone.py:118-286)."""

    def __init__(
        self,
        item_model: ItemNetBase,
        pos_encoding_layer: PositionalEncodingBase,
        transformer_layers: TransformerLayersBase,
        similarity_module: SimilarityModuleBase,
        n_heads: int,
        dropout_rate: float,
        use_causal_attn: bool = True,
        use_key_padding_mask: bool = False,
    ) -> None:
        super().__init__()
        self.item_model = item_model
        self.pos_encoding_layer = pos_encoding_layer
        self.transformer_layers = transformer_layers
        self.similarity_module = similarity_module
        self.n_heads = n_heads
        self.dropout_rate = dropout_rate
        self.use_causal_attn = use_causal_attn
        self.use_key_padding_mask = use_key_padding_mask
        self.emb_dropout = HashDropout(dropout_rate)

    def _build_attn_bias(self, sessions: torch.Tensor) -> tp.Optional[torch.Tensor]:
        b, l = sessions.shape
        dev = sessions.device
        causal = None
        key_padding = None
        if self.use_causal_attn:
            allowed = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
            causal = torch.where(allowed, 0.0, MASK_VALUE)[None, None, :, :]  # (1, 1, L, L)
        if self.use_key_padding_mask:
            pad = sessions == 0  # (B, L) True for padded keys
            key_padding = torch.where(pad, MASK_VALUE, 0.0)[:, None, None, :]  # (B, 1, 1, L)
        if causal is not None and key_padding is not None:
            eye = torch.eye(l, dtype=torch.bool, device=dev)[None, None, :, :]
            return torch.where(eye, 0.0, causal + key_padding)  # (B, 1, L, L)
        if causal is not None:
            return causal
        if key_padding is not None:
            # the diagonal stays enabled so fully-padded rows remain clean
            eye = torch.eye(l, dtype=torch.bool, device=dev)[None, None, :, :]
            return torch.where(eye, 0.0, key_padding.expand(b, 1, l, l))
        return None

    def encode_sessions(self, batch: tp.Dict[str, torch.Tensor], item_embs: torch.Tensor) -> torch.Tensor:
        sessions = batch["x"]  # (B, L) int
        timeline_mask = (sessions != 0).to(item_embs.dtype)[:, :, None]  # (B, L, 1)
        seqs = item_embs[sessions]  # (B, L, D)
        seqs = self.emb_dropout(self.pos_encoding_layer(seqs))
        attn_bias = self._build_attn_bias(sessions)
        return self.transformer_layers(seqs, timeline_mask, attn_bias, batch)

    def forward(
        self, batch: tp.Dict[str, torch.Tensor], candidate_item_ids: tp.Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        item_embs = self.item_model.embed_catalog()
        session_embs = self.encode_sessions(batch, item_embs)
        return self.similarity_module(session_embs, item_embs, candidate_item_ids)
