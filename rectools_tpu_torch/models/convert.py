"""Fitted state of the JAX package's classic models -> the port's models.

The JAX models keep their fitted state as numpy arrays on the model, named
as below; :func:`load_fitted_arrays` checks such a dict against the port
model it is given and sets it there, so a model fitted by the JAX package
serves from the port (the transformers' weights come in through
``load_jax_params`` instead):

    EASEModel               weight                      (n_items, n_items) f32
    PureSVDModel            user_factors, item_factors  (n_users, factors), (n_items, factors) f32
    ItemKNNModel            similarity                  (n_items, n_items) f32
    PopularModel            popularity_list             (item ids (n,) int, scores (n,) float)
    RandomModel             all_item_ids                (n_items,) int
    PopularInCategoryModel  category_columns, category_scores, n_effective_categories,
                            _cat_items, _cat_item_scores (one int / float array per category)
    ALSModel                user_factors, item_factors  (n_users, f), (n_items, f) f32, f >= factors
    BPRModel                user_embeddings, item_embeddings, item_biases
                                                        (n_users, factors), (n_items, factors), (n_items,) f32
    HybridMFModel           params                      {user_emb, user_bias, item_emb, item_bias} f32,
                                                        (n_user_features, d), (n_user_features,), ...

DSSM's flax parameter tree comes in through :func:`load_jax_dssm_params`.
"""

import typing as tp

import numpy as np
import pandas as pd
import torch

from ..utils.device import resolve_device
from .als import ALSModel
from .base import ModelBase
from .bpr import BPRModel
from .ease import EASEModel
from .hybrid_mf import HybridMFModel
from .item_knn import ItemKNNModel
from .nn.dssm import DSSMModel, DSSMTowers
from .popular import PopularModel
from .popular_in_category import PopularInCategoryModel
from .pure_svd import PureSVDModel
from .random import RandomModel

# by class name, which the JAX package's models share
FITTED_ATTRIBUTES = {
    "EASEModel": ("weight",),
    "PureSVDModel": ("user_factors", "item_factors"),
    "ItemKNNModel": ("similarity",),
    "PopularModel": ("popularity_list",),
    "RandomModel": ("all_item_ids",),
    "PopularInCategoryModel": (
        "category_columns", "category_scores", "n_effective_categories", "_cat_items", "_cat_item_scores"
    ),
    "ALSModel": ("user_factors", "item_factors"),
    "BPRModel": ("user_embeddings", "item_embeddings", "item_biases"),
    "HybridMFModel": ("params",),
}
HYBRID_MF_PARAMS = ("user_emb", "user_bias", "item_emb", "item_bias")


def fitted_arrays(model: tp.Any) -> tp.Dict[str, tp.Any]:
    """The fitted state of a classic model, of the port or of the JAX package,
    as :func:`load_fitted_arrays` takes it (category scores as an array)."""
    arrays = {name: getattr(model, name) for name in FITTED_ATTRIBUTES[type(model).__name__]}
    if "category_scores" in arrays:
        arrays["category_scores"] = arrays["category_scores"].to_numpy()
    return arrays


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"load_fitted_arrays: {message}")


def _matrix(value: tp.Any, name: str, square: bool = False, columns: tp.Optional[int] = None) -> np.ndarray:
    _require(isinstance(value, np.ndarray) and value.dtype == np.float32 and value.ndim == 2,
             f"`{name}` must be a 2-D float32 array, got {getattr(value, 'dtype', type(value))} "
             f"{getattr(value, 'shape', '')}")
    _require(not square or value.shape[0] == value.shape[1], f"`{name}` must be square, got {value.shape}")
    _require(columns is None or value.shape[1] == columns, f"`{name}` must have {columns} columns, got {value.shape}")
    return value


def _vector(value: tp.Any, name: str, kind: str) -> np.ndarray:
    _require(isinstance(value, np.ndarray) and value.ndim == 1 and value.dtype.kind in kind,
             f"`{name}` must be a 1-D array of kind {kind!r}, got {getattr(value, 'dtype', type(value))}")
    return value


def load_fitted_arrays(model: ModelBase, arrays: tp.Mapping[str, tp.Any]) -> ModelBase:
    """Set the JAX package's fitted arrays of ``model``'s class on ``model``
    (after checking their names, shapes and dtypes) and mark it fitted."""
    names = FITTED_ATTRIBUTES.get(type(model).__name__)
    _require(names is not None, f"no fitted arrays are known for {type(model).__name__}")
    _require(set(arrays) == set(names), f"{type(model).__name__} takes {sorted(names)}, got {sorted(arrays)}")
    values = dict(arrays)
    if isinstance(model, (EASEModel, ItemKNNModel)):
        _matrix(values[names[0]], names[0], square=True)
    elif isinstance(model, PureSVDModel):
        users = _matrix(values["user_factors"], "user_factors", columns=model.factors)
        items = _matrix(values["item_factors"], "item_factors", columns=model.factors)
        _require(users.shape[1] == items.shape[1], "the factor tables differ in width")
    elif isinstance(model, PopularModel):
        _require(len(values["popularity_list"]) == 2, "`popularity_list` must be (item ids, scores)")
        items = _vector(values["popularity_list"][0], "popularity_list[0]", "iu")
        scores = _vector(values["popularity_list"][1], "popularity_list[1]", "f")
        _require(len(items) == len(scores), "`popularity_list`'s ids and scores differ in length")
        values["popularity_list"] = (items.copy(), scores.copy())
    elif isinstance(model, RandomModel):
        _vector(values["all_item_ids"], "all_item_ids", "iu")
    elif isinstance(model, ALSModel):
        users = _matrix(values["user_factors"], "user_factors")
        items = _matrix(values["item_factors"], "item_factors")
        _require(users.shape[1] == items.shape[1] >= model.factors,
                 f"the factor tables must share a width of at least {model.factors}")
    elif isinstance(model, BPRModel):
        _matrix(values["user_embeddings"], "user_embeddings", columns=model.factors)
        items = _matrix(values["item_embeddings"], "item_embeddings", columns=model.factors)
        biases = _vector(values["item_biases"], "item_biases", "f")
        _require(biases.dtype == np.float32 and len(biases) == len(items), "`item_biases` must be (n_items,) float32")
    elif isinstance(model, HybridMFModel):
        params = values["params"]
        _require(isinstance(params, dict) and set(params) == set(HYBRID_MF_PARAMS),
                 f"`params` must hold {list(HYBRID_MF_PARAMS)}")
        for side in ("user", "item"):
            emb = _matrix(params[f"{side}_emb"], f"params[{side}_emb]", columns=model.no_components)
            bias = _vector(params[f"{side}_bias"], f"params[{side}_bias]", "f")
            _require(bias.dtype == np.float32 and len(bias) == len(emb), f"`params[{side}_bias]` must be (n,) float32")
        values["params"] = {k: params[k].copy() for k in HYBRID_MF_PARAMS}
    else:
        n_cat = int(values["n_effective_categories"])
        _require(len(values["category_columns"]) == len(values["_cat_items"]) == len(values["_cat_item_scores"])
                 == len(values["category_scores"]) == n_cat, "the per-category lists differ in length")
        for items, scores in zip(values["_cat_items"], values["_cat_item_scores"]):
            _require(len(_vector(items, "_cat_items", "iu")) == len(_vector(scores, "_cat_item_scores", "f")),
                     "a category's item ids and scores differ in length")
        values["category_columns"] = [int(c) for c in values["category_columns"]]
        values["category_scores"] = pd.Series(values["category_scores"], index=values["category_columns"],
                                              dtype=float)
        values["n_effective_categories"] = n_cat
        values["_cat_items"] = [items.copy() for items in values["_cat_items"]]
        values["_cat_item_scores"] = [scores.copy() for scores in values["_cat_item_scores"]]
    for name, value in values.items():  # the model owns writable copies
        setattr(model, name, value.copy() if isinstance(value, np.ndarray) else value)
    model.is_fitted = True
    return model


def load_jax_dssm_params(model: DSSMModel, flax_params: tp.Mapping[str, tp.Any]) -> DSSMModel:
    """Set a JAX ``DSSMModel``'s flax parameter tree (``model.params``:
    ``user_net`` / ``item_net``, each layer's ``kernel`` stored (in, out)) as
    ``model``'s towers on its device (``nn.Linear.weight`` is (out, in)) and
    mark it fitted."""
    state = {}
    for net, layers in flax_params.items():
        for layer, leaves in layers.items():
            _require(set(leaves) == {"kernel"}, f"{net}/{layer} must hold only a kernel, got {sorted(leaves)}")
            state[f"{net}.{layer}.weight"] = torch.from_numpy(np.array(leaves["kernel"], dtype=np.float32).T.copy())
    expected = set(DSSMTowers(1, 1, 1, 1).state_dict())
    _require(set(state) == expected, f"DSSM takes {sorted(expected)}, got {sorted(state)}")
    _require(state["item_net.output_layer.weight"].shape[0] == model.n_factors,
             f"the towers' width is not n_factors={model.n_factors}")
    model._towers = DSSMTowers.from_state(state, resolve_device(model.device))
    model.is_fitted = True
    return model


def jax_dssm_params(model: DSSMModel) -> tp.Dict[str, tp.Dict[str, tp.Dict[str, np.ndarray]]]:
    """A fitted ``DSSMModel``'s towers as a flax parameter tree of numpy
    arrays, as :func:`load_jax_dssm_params` takes it."""
    tree: tp.Dict[str, tp.Dict[str, tp.Dict[str, np.ndarray]]] = {}
    for name, weight in model.towers.state_dict().items():
        net, layer, _ = name.split(".")
        tree.setdefault(net, {})[layer] = {"kernel": weight.detach().cpu().numpy().T.copy()}
    return tree
