"""Flax parameter trees -> the port's ``state_dict``.

The JAX package's transformer backbone keeps its parameters as a nested
dict (flax layout), for SASRec:

    item_model/item_net_blocks_0/ids_emb                       (n_items, d)
    item_model/item_net_blocks_1/cat_emb                       (n_values, d)
    pos_encoding_layer/pos_emb                                 (L, d)
    transformer_layers/block_{i}/{q_layer_norm,ff_layer_norm}/{scale,bias}
    transformer_layers/block_{i}/multi_head_attn/{q,k,v,out}_proj/{kernel,bias}
    transformer_layers/block_{i}/feed_forward/ff_linear_{1,2}/{kernel,bias}
    transformer_layers/last_layernorm/{scale,bias}

The port's modules carry the same names, with two layout rules: a numbered
child ``name_{i}`` is entry ``i`` of the ``nn.ModuleList`` ``name`` (``block``
becomes ``blocks``), and a flax ``Dense`` kernel, stored (in, out), becomes
the transposed ``nn.Linear.weight``, stored (out, in). Embedding tables become
``nn.Embedding.weight``.
"""

import re
import typing as tp

import numpy as np
import torch

_NUMBERED = re.compile(r"^(.*)_(\d+)$")
_LIST_NAMES = {"block": "blocks", "item_net_blocks": "item_net_blocks"}
_EMBEDDING_TABLES = ("ids_emb", "cat_emb")


def _torch_name(flax_name: str) -> str:
    match = _NUMBERED.match(flax_name)
    if match and match.group(1) in _LIST_NAMES:
        return f"{_LIST_NAMES[match.group(1)]}.{match.group(2)}"
    return flax_name


def flax_params_to_state_dict(params: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    """The port's backbone ``state_dict`` (float32 CPU tensors) for a flax
    parameter tree given as nested dicts of numpy arrays."""
    state: tp.Dict[str, torch.Tensor] = {}

    def walk(node: tp.Mapping[str, tp.Any], prefix: str) -> None:
        for name, value in node.items():
            path = f"{prefix}{_torch_name(name)}"
            if isinstance(value, tp.Mapping):
                walk(value, f"{path}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                state[f"{prefix}weight"] = torch.tensor(arr.T)
            elif name in _EMBEDDING_TABLES:
                state[f"{path}.weight"] = torch.tensor(arr)
            else:
                state[path] = torch.tensor(arr)

    walk(params, "")
    return state
