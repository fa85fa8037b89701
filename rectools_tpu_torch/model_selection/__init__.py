"""Model selection: splitters + cross-validation.

The port's copy of ``rectools_tpu/model_selection/__init__.py``.
"""

from .cross_validate import cross_validate
from .last_n_split import LastNSplitter
from .random_split import RandomSplitter
from .splitter import Splitter
from .time_split import TimeRangeSplitter
from .utils import get_not_seen_mask

__all__ = [
    "cross_validate",
    "LastNSplitter",
    "RandomSplitter",
    "Splitter",
    "TimeRangeSplitter",
    "get_not_seen_mask",
]
