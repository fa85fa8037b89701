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
"""

import typing as tp

import numpy as np
import pandas as pd

from .base import ModelBase
from .ease import EASEModel
from .item_knn import ItemKNNModel
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
}


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
