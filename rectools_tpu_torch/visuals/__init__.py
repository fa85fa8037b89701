"""Jupyter visual apps (port of rectools_tpu/visuals: pandas and numpy, no device)."""

from .metrics_app import MetricsApp
from .visual_app import AppDataStorage, ItemToItemVisualApp, VisualApp

__all__ = ["MetricsApp", "AppDataStorage", "ItemToItemVisualApp", "VisualApp"]
