"""Pydantic config base (reference: rectools/utils/config.py:15-19)."""

from pydantic import BaseModel, ConfigDict


class BaseConfig(BaseModel):
    """Base config for all typed configs: extra keys are forbidden."""

    model_config = ConfigDict(extra="forbid", arbitrary_types_allowed=True)
