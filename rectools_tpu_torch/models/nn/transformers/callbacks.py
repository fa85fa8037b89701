"""Training callbacks: per-epoch hooks, early stopping, best-state retention.

Port of rectools_tpu/models/nn/transformers/callbacks.py. Pass instances via
``training_module_kwargs={"callbacks": [...]}`` or a ``get_callbacks_func``
factory. Monitorable values per epoch: ``train_loss``, ``val_loss`` (with a
validation mask) and ``val_recall@{k}`` (with the training module's
``val_recall_k``). The best-state snapshot is a copy of the backbone's
``state_dict`` and of the optimizer's state, restored when training ends.
"""

import copy
import typing as tp
import warnings

if tp.TYPE_CHECKING:  # pragma: no cover
    from .training import TransformerTrainingModule


class TrainingCallback:
    """Per-epoch hook protocol for `TransformerTrainingModule.fit`."""

    def on_train_start(self, module: "TransformerTrainingModule") -> None:
        """Called once when a fit loop starts (also on fit_partial resumes)."""

    def on_epoch_end(self, module: "TransformerTrainingModule", epoch: int, logs: tp.Dict[str, float]) -> bool:
        """Called after each epoch with the epoch's metric logs. Return True to stop."""
        return False

    def on_train_end(self, module: "TransformerTrainingModule") -> None:
        """Called when the fit loop finishes (exhausted or stopped early)."""


class _MonitorMixin:
    """Shared improvement tracking over a monitored metric."""

    monitor: str
    mode: str
    min_delta: float

    def _init_monitor(self, monitor: str, mode: str, min_delta: float) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode}")
        self.monitor = monitor
        self.mode = mode
        self.min_delta = min_delta
        self.best_value: tp.Optional[float] = None
        self._warned_missing = False

    def _metric(self, logs: tp.Dict[str, float]) -> tp.Optional[float]:
        value = logs.get(self.monitor)
        if value is None and not self._warned_missing:
            warnings.warn(
                f"Monitored metric `{self.monitor}` is not in epoch logs {sorted(logs)}; "
                "callback is inactive. Configure a validation mask (and `val_recall_k` "
                "for recall monitors) on the training module."
            )
            self._warned_missing = True
        return value

    def _improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        if self.mode == "min":
            return value < self.best_value - self.min_delta
        return value > self.best_value + self.min_delta


class EarlyStopping(TrainingCallback, _MonitorMixin):
    """Stop when the monitored metric hasn't improved for `patience` epochs;
    ``warmup_epochs`` delays monitoring."""

    def __init__(
        self,
        monitor: str = "val_loss",
        patience: int = 1,
        min_delta: float = 0.0,
        mode: str = "min",
        warmup_epochs: int = 0,
    ):
        self._init_monitor(monitor, mode, min_delta)
        self.patience = patience
        self.warmup_epochs = warmup_epochs
        self.wait = 0
        self._epochs_seen = 0
        self.stopped_epoch: tp.Optional[int] = None

    def on_train_start(self, module: "TransformerTrainingModule") -> None:
        self.wait = 0
        self._epochs_seen = 0

    def on_epoch_end(self, module: "TransformerTrainingModule", epoch: int, logs: tp.Dict[str, float]) -> bool:
        value = self._metric(logs)
        if value is None:
            return False
        self._epochs_seen += 1
        if self._epochs_seen <= self.warmup_epochs:
            if self._improved(value):
                self.best_value = value
            return False
        if self._improved(value):
            self.best_value = value
            self.wait = 0
            return False
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            return True
        return False


class BestStateKeeper(TrainingCallback, _MonitorMixin):
    """Snapshot the best epoch's parameters and optimizer state, restore them
    after training."""

    def __init__(self, monitor: str = "val_loss", mode: str = "min", min_delta: float = 0.0):
        self._init_monitor(monitor, mode, min_delta)
        self.best_epoch: tp.Optional[int] = None
        self._params_snapshot: tp.Optional[tp.Dict[str, tp.Any]] = None
        self._opt_snapshot: tp.Optional[tp.Dict[str, tp.Any]] = None

    def on_epoch_end(self, module: "TransformerTrainingModule", epoch: int, logs: tp.Dict[str, float]) -> bool:
        value = self._metric(logs)
        if value is None:
            return False
        if self._improved(value):
            self.best_value = value
            self.best_epoch = epoch
            self._params_snapshot = {k: v.detach().clone() for k, v in module.backbone.state_dict().items()}
            self._opt_snapshot = copy.deepcopy(module.optimizer.state_dict())
        return False

    def on_train_end(self, module: "TransformerTrainingModule") -> None:
        if self._params_snapshot is None:
            return
        module.backbone.load_state_dict(self._params_snapshot)
        module.optimizer.load_state_dict(self._opt_snapshot)
