"""Flax parameter trees <-> the port's ``state_dict``, both directions.

The JAX package's transformer backbone keeps its parameters as a nested
dict (flax layout), for SASRec:

    item_model/item_net_blocks_0/ids_emb                       (n_items, d)
    item_model/item_net_blocks_1/cat_emb                       (n_values, d)
    pos_encoding_layer/pos_emb                                 (L, d)
    transformer_layers/block_{i}/{q_layer_norm,ff_layer_norm}/{scale,bias}
    transformer_layers/block_{i}/multi_head_attn/{q,k,v,out}_proj/{kernel,bias}
    transformer_layers/block_{i}/feed_forward/ff_linear_{1,2}/{kernel,bias}
    transformer_layers/last_layernorm/{scale,bias}

for the Pre-LN stack (BERT4Rec) and the LiGR stack (eSASRec), in place of
the ``transformer_layers`` entries above:

    transformer_layers/block_{i}/layer_norm_{1,2}/{scale,bias}
    transformer_layers/block_{i}/multi_head_attn/{q,k,v,out}_proj/{kernel,bias}
    transformer_layers/block_{i}/feed_forward/ff_linear_{1,2,3}/{kernel[,bias]}   (ff_linear_3: SwiGLU)
    transformer_layers/block_{i}/gating_linear_{1,2}/{kernel,bias}               (LiGR)

and for HSTU:

    transformer_layers/block_{i}/{norm_input,norm_attn_output}/{scale,bias}
    transformer_layers/block_{i}/uvqk_proj                     (d, 2·lh·H + 2·ad·H)
    transformer_layers/block_{i}/rel_attn/{time_weights,pos_weights}   (129,), (2L − 1,)
    transformer_layers/block_{i}/output_mlp/{kernel,bias}

The port's modules carry the same names, with two layout rules: a numbered
child ``name_{i}`` is entry ``i`` of the ``nn.ModuleList`` ``name`` (``block``
becomes ``blocks``), and a flax ``Dense`` kernel, stored (in, out), becomes
the transposed ``nn.Linear.weight``, stored (out, in). Embedding tables become
``nn.Embedding.weight``. Every other leaf keeps its name and its layout:
``uvqk_proj`` is a raw parameter stored (in, out) on both sides and is not
transposed, and the two relative-bias tables are plain vectors. These names
cover every parameter of the SASRec, eSASRec, BERT4Rec and HSTU training
paths (item tables, positions, LayerNorms, attention, FFNs, gates, STU
blocks), so a model trained on either side continues on the other.
"""

import re
import typing as tp

import numpy as np
import torch

_NUMBERED = re.compile(r"^(.*)_(\d+)$")
_LIST_NAMES = {"block": "blocks", "item_net_blocks": "item_net_blocks"}
_FLAX_LIST_NAMES = {torch_name: flax_name for flax_name, torch_name in _LIST_NAMES.items()}
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


def state_dict_to_flax_params(state: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, tp.Any]:
    """The inverse of :func:`flax_params_to_state_dict`: a flax parameter tree
    (nested dicts of float32 numpy arrays) for the port's backbone ``state_dict``."""
    params: tp.Dict[str, tp.Any] = {}
    for key, value in state.items():
        parts = key.split(".")
        path: tp.List[str] = []
        i = 0
        while i < len(parts):
            part = parts[i]
            if part in _FLAX_LIST_NAMES and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f"{_FLAX_LIST_NAMES[part]}_{parts[i + 1]}")
                i += 2
                continue
            path.append(part)
            i += 1
        arr = value.detach().cpu().numpy().astype(np.float32)
        if path[-1] == "weight" and len(path) > 1 and path[-2] in _EMBEDDING_TABLES:
            path = path[:-1]
        elif path[-1] == "weight":
            path[-1], arr = "kernel", arr.T.copy()
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
    return params
