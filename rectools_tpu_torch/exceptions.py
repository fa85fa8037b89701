"""Framework exceptions (reference: rectools/exceptions.py:16-41)."""


class NotFittedError(Exception):
    """Raised when a model method requiring a fitted model is called before ``fit``."""

    def __init__(self, model_name: str) -> None:
        super().__init__(f"Model `{model_name}` is not fitted, call `fit` first")


class NotFittedForStageError(Exception):
    """Raised when a multi-stage model is not fitted for the requested stage."""

    def __init__(self, model_name: str, stage: str) -> None:
        super().__init__(f"Model `{model_name}` is not fitted for stage `{stage}`")
