"""Module-level model serialization helpers: the port's copy of
``rectools_tpu/models/serialization.py`` (reference
rectools/models/serialization.py:25-88). Class paths resolve to the port's
own classes (``rectools_tpu_torch.models...``)."""

import pickle
import typing as tp

from pydantic import TypeAdapter

from ..utils.misc import unflatten_dict
from ..utils.serialization import FileLike, read_bytes
from .base import ModelBase, ModelClass, ModelConfig


def load_model(f: FileLike) -> ModelBase:
    """Load any model from a file written by ``model.save``: a fitted
    transformer comes back on its config's ``device``."""
    return pickle.loads(read_bytes(f))


def model_from_config(config: tp.Union[dict, ModelConfig]) -> ModelBase:
    """Instantiate a model from a config carrying its class path."""
    if isinstance(config, dict):
        model_cls = config.get("cls")
        model_cls = TypeAdapter(tp.Optional[ModelClass]).validate_python(model_cls)
    else:
        model_cls = config.cls
    if model_cls is None:
        raise ValueError("`cls` must be provided in the config to load the model")
    return model_cls.from_config(config)


def model_from_params(params: dict, sep: str = ".") -> ModelBase:
    """Instantiate a model from a flat params dict."""
    return model_from_config(unflatten_dict(params, sep=sep))
